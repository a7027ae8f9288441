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
on the resident levels (its coarse end one cluster launch a visit), one
host read of the stop flag per iteration.
The CUDA side is `csrc/mg_stream.cu` over the level kernels it shares
with K3 (`csrc/mg_levels.cuh`).

`stream_host_operands` builds its operands from K3's full Galerkin
hierarchy (`mg_host_operands`): the resident levels' planes and
Chebyshev rows, and one row more for the fine level's 1/theta.
`solve_pressure_mg_stream_plain` is the plain version: K3's plain PCG
loop around `multigrid.cycle_galerkin` over the resident levels with the
F-to-1 transfer.

`_resident_start` and `stream_mg_fits` are the JAX package's (:112, :498),
kept as integer arithmetic: see `pcg_kernel._VMEM_BUDGET`.
"""

from __future__ import annotations

import ctypes

import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.ops import multigrid
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda.mg_kernel import (
    _F_ITERS,
    _PLANES_PER_LEVEL,
    _S_RESID,
    _cycle_kwargs,
    _level_shapes,
    cycle_args,
    mg_fits,
    mg_host_operands,
    mg_pcg_plain,
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
    kw = _cycle_kwargs(cfg)
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


def _lib():
    lib = _build.load("mg_stream", flags=["-fmad=false"])
    P, I, F = _build.PTR, _build.INT, _build.FLOAT
    _build.bind(lib, "eu_mg_stream",
                [I, I, I, I, P, P, P, P, I, I, I, I, I, I, F, F]
                + [P] * 9)
    return lib


class Buffers:
    """Device buffers handed to the CUDA library, kept referenced here
    until the launch that reads them is enqueued."""

    def __init__(self, device):
        self.device = device
        self.keep = []

    def new(self, shape) -> int:
        t = torch.empty(shape, dtype=torch.float32, device=self.device)
        self.keep.append(t)
        return t.data_ptr()

    def levels(self, shapes, coef_planes):
        """ctypes (shapes, planes) of a `Solve` (csrc/mg_levels.cuh): per
        level its (c, e, n) planes, then fresh x, b, z, rr, d, dn planes."""
        ptrs = []
        for l, ((Yl, Xl), cen) in enumerate(zip(shapes, coef_planes)):
            planes = [t.contiguous() for t in cen]
            for name, t in zip("cen", planes):
                _build.require(t, f"{name}{l}", torch.float32, (Yl, Xl),
                               self.device)
            self.keep.extend(planes)
            ptrs += [t.data_ptr() for t in planes]
            ptrs += [self.new((Yl, Xl)) for _ in range(6)]
        assert len(ptrs) == _PLANES_PER_LEVEL * len(shapes)
        flat = [v for sh in shapes for v in sh]
        return ((ctypes.c_int * len(flat))(*flat),
                (ctypes.c_void_p * len(ptrs))(*ptrs))


def solve_pressure_mg_stream(cfg: SimConfig, b, a_diag, fluid, solid=None):
    """One MG-PCG solve with the F-to-1 level skip, from p = 0.  Returns
    (p, iterations, residual).  CUDA tensors run the kernel; CPU tensors
    the plain version."""
    del solid  # the Galerkin hierarchy needs only a_diag and the fluid
    if b.device.type == "cpu":
        _build.PLAIN_CALLS["K11"] += 1
        return solve_pressure_mg_stream_plain(cfg, b, a_diag, fluid)
    if not stream_mg_fits(cfg):
        raise NotImplementedError(
            "the CUDA MG-PCG with the level skip needs f32 galerkin + cheby, "
            "level sizes that halve evenly to mg_min_size and a resident "
            "level below the root (ROADMAP queue 1 item M11)")
    s = cfg.solver
    Y, X = cfg.ny, cfg.nx
    f = torch.float32
    dev = b.device
    _build.require(b, "b", f, (Y, X))
    F, shapes, packed0, coef_planes, rows = stream_host_operands(
        cfg, a_diag, fluid)
    rows = rows.contiguous()
    r = b.clone()
    p = torch.empty_like(b)
    bufs = Buffers(dev)
    shape_arr, plane_arr = bufs.levels(shapes, coef_planes)
    work = [bufs.new((Y, X)) for _ in range(3)]  # s, As, z
    part = bufs.new((-(-Y * X // 256),))
    scal = torch.zeros(8, dtype=f, device=dev)
    flags = torch.zeros(4, dtype=torch.int32, device=dev)
    lib = _lib()
    _build.LAUNCHES["K11"] += 1
    rc = lib.eu_mg_stream(
        Y, X, F, len(shapes), shape_arr, plane_arr, packed0.data_ptr(),
        rows.data_ptr(), rows.shape[1], *cycle_args(cfg), s.max_iterations,
        float(s.tol), float(s.tol_rel), p.data_ptr(), r.data_ptr(), *work,
        part, scal.data_ptr(), flags.data_ptr(), _build.stream())
    _build.check(lib, rc, "eu_mg_stream")
    return p, flags[_F_ITERS].clone(), scal[_S_RESID].clone()
