"""K11: MG-PCG with the F-to-1 level skip
(`euler_tpu/ops/pallas/mg_stream_kernel.py`).

`solve_pressure_mg_stream` replaces the Pallas kernel `_stream_mg_kernel`
launched by `solve_pressure_mg_stream` (mg_stream_kernel.py:394-495), same
contract: (p, iterations, residual) for A p = b from p = 0 (it takes no
warm start, as the Pallas kernel takes none).  The JAX package routes MG
solves to it where the resident kernel (K3) does not fit its VMEM budget,
from about 1672² (`ops/project.solve_pressure`).  Its preconditioner is
not K3's: the fine residual of a degree-1 Chebyshev pre-smooth is
restricted straight to the first resident level (`_resident_start`; F = 2
at 2048², F = 4 at 4096²), the levels from there down run K3's
truncated-W cycle with that root in edge form, and the fine level is
post-smoothed once with degree-1 Chebyshev.

On an H100 it is bound by launches, then bytes: each iteration is four
fine sweeps moving 17 [Y, X] f32 planes (68 MB at 2048²) plus K3's cycle
on the resident levels (its coarse end one cluster launch a visit).  So
it runs on K3's machinery (`mg_kernel.MgWorkspace` with its root at
level `ls`; `csrc/mg_stream.cu` over `csrc/mg_solver.cuh` and
`csrc/mg_levels.cuh`): a cached workspace, the Galerkin hierarchy and
the rows built on the card per solve, and a CUDA graph of 8 iterations
replayed with one read of the stop flag a chunk.

`stream_host_operands` is the plain version of that build: the resident
levels' planes and Chebyshev rows from K3's full Galerkin hierarchy
(`mg_host_operands`), and one row more for the fine level's 1/theta.
`solve_pressure_mg_stream_plain` is the plain version of the solve: K3's
plain PCG loop around `multigrid.cycle_galerkin` over the resident levels
with the F-to-1 transfer.

`_resident_start` and `stream_mg_fits` are the JAX package's (:112, :498),
kept as integer arithmetic: see `pcg_kernel._VMEM_BUDGET`.
"""

from __future__ import annotations

import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.ops import multigrid
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda.mg_kernel import (
    _level_shapes,
    mg_fits,
    mg_host_operands,
    mg_pcg_plain,
    workspace,
)
from euler_tpu_torch.ops.project import apply_a

# the resident sub-hierarchy's budget on the TPU: 7 planes a level,
# geometric in level area
_RES_BUDGET = 48 * 1024 * 1024


def _resident_start(shapes) -> int:
    """The first level whose sub-hierarchy fits the resident budget: the
    root of the cycle."""
    for ls in range(1, len(shapes)):
        Y, X = shapes[ls]
        if int(Y * X * 4 * 7 * 4 / 3) <= _RES_BUDGET:
            return ls
    return len(shapes) - 1


def _root(cfg: SimConfig):
    """(shapes, ls, F): the level shapes, the root's index and the
    transfer factor."""
    shapes = _level_shapes(cfg.ny, cfg.nx, cfg.solver.mg_min_size)
    ls = _resident_start(shapes)
    return shapes, ls, cfg.ny // shapes[ls][0]


def stream_mg_fits(cfg: SimConfig) -> bool:
    """`mg_fits`, a resident level below the root, and rows and columns
    that split into the F-to-1 transfer and 8-row blocks."""
    if not mg_fits(cfg):
        return False
    shapes, ls, F = _root(cfg)
    Y, X = cfg.ny, cfg.nx
    return ls < len(shapes) - 1 and not (Y % 8 or X % F or Y % F)


def solve_pressure_mg_stream_plain(cfg: SimConfig, b, a_diag, fluid):
    """Plain K11: `mg_pcg_plain` from p = 0 with the preconditioner
    x = it0 r, b_root = R_F (r - A x), ec = cycle(levels[ls:], b_root),
    x += fl P_F ec, z = x + it0 (r - A x)."""
    s = cfg.solver
    _, ls, F = _root(cfg)
    levels = multigrid.build_galerkin_hierarchy(a_diag, fluid, b.dtype,
                                                min_size=s.mg_min_size)
    resident = levels[ls:]
    it0, _ = multigrid.cheby_coefficients(levels[0].lmax.to(b.dtype), 1,
                                          s.mg_cheby_ratio)
    fl = fluid.to(b.dtype)
    kw = multigrid.cycle_kwargs(cfg)
    Y, X = b.shape

    def apply(x):
        return apply_a(a_diag, fluid, x)

    def precon(r):
        res = r - it0 * apply(r)
        b_root = res.reshape(Y // F, F, X // F, F).sum((1, 3))
        ec = multigrid.cycle_galerkin(resident, b_root, **kw)
        x = it0 * r + fl * ec.repeat_interleave(F, 0).repeat_interleave(F, 1)
        return x + it0 * (r - apply(x))

    return mg_pcg_plain(cfg, b, apply, precon, fluid)


def stream_host_operands(cfg: SimConfig, a_diag, fluid):
    """(F, shapes, packed0, coef_planes, rows) of the CUDA solve: the
    resident levels' shapes and (c, e, n) planes, the packed fine plane,
    and the resident levels' Chebyshev rows with the fine level's
    [it0, 0, ...] appended."""
    _, ls, F = _root(cfg)
    shapes, packed0, coef_planes, rows = mg_host_operands(cfg, a_diag, fluid)
    fine = torch.zeros_like(rows[:1])
    fine[0, 0] = rows[0, 0]  # inv_theta does not depend on the degree
    return (F, shapes[ls:], packed0, coef_planes[ls - 1:],
            torch.cat([rows[ls:], fine]))


def solve_pressure_mg_stream(cfg: SimConfig, b, a_diag, fluid, solid=None):
    """One MG-PCG solve with the F-to-1 level skip, from p = 0.  Returns
    (p, iterations, residual).  CUDA tensors run the kernel on the cached
    workspace of `cfg`; CPU tensors the plain version."""
    del solid  # the Galerkin hierarchy needs only a_diag and the fluid
    if b.device.type == "cpu":
        _build.PLAIN_CALLS["K11"] += 1
        return solve_pressure_mg_stream_plain(cfg, b, a_diag, fluid)
    if not stream_mg_fits(cfg):
        raise NotImplementedError(
            "the CUDA MG-PCG with the level skip needs f32 galerkin + cheby, "
            "level sizes that halve evenly to mg_min_size and a resident "
            "level below the root (`ops/project.solve_pressure` takes P3 "
            "where they do not)")
    plane = (cfg.ny, cfg.nx)
    dev = b.device
    _build.require(b, "b", torch.float32, plane)
    _build.require(a_diag, "a_diag", torch.int32, plane, dev)
    _build.require(fluid, "fluid", torch.bool, plane, dev)
    ws = workspace(cfg, dev, _root(cfg)[1])
    iters, resid = ws.stream_solve(a_diag, fluid, b)
    return ws.p.clone(), iters, resid
