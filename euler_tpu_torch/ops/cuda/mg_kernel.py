"""K3: Galerkin MG-PCG (`euler_tpu/ops/pallas/mg_kernel.py`).

`solve_pressure_mg` replaces the Pallas kernel `_mg_kernel` launched by
`solve_pressure_mg_pallas` (mg_kernel.py:697-745), same contract:
(p, iterations, residual) for A p = b, optionally warm-started from x0.
The solver body (`csrc/mg_pcg.cu`) is also the middle of K2's substep.

On an H100 the solve is bound by launches more than bytes: each PCG
iteration is one truncated-W cycle (about fifty small launches at 1024²,
most on the coarse levels) and one host read of the stop flag.  The
design keeps one kernel per level operation with the restriction and the
<z, r> dot fused into the smoothers, and reduces deterministically, so
the iteration count repeats from run to run (see the note in the
source).

`mg_pallas_fits` is the JAX package's gate for K3 (mg_kernel.py:748);
`mg_fits` is the CUDA levels' own check that the sizes halve evenly.

`mg_host_operands` stays plain PyTorch on the device, as the JAX package
leaves it to XLA: the Galerkin hierarchy by 2x2 block sums and the
Chebyshev rows from each level's measured Gershgorin bound, with no host
read.  `solve_pressure_mg_plain` is the plain version: a PCG loop of the
same shape as `_mg_pcg_solve` around `multigrid.cycle_galerkin`.
"""

from __future__ import annotations

import ctypes

import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.ops import multigrid
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda.pcg_kernel import _VMEM_BUDGET
from euler_tpu_torch.ops.project import apply_a

_PLANES_PER_LEVEL = 9  # c, e, n, x, b, z, rr, d, dn (csrc/mg_pcg.cu)
_S_RESID = 5           # scal index of the final residual max
_F_ITERS = 1           # flags index of the iteration count


def _level_shapes(Y: int, X: int, min_size: int):
    """Fine-to-coarse level shapes, mirroring build_galerkin_hierarchy."""
    shapes = [(Y, X)]
    while min(shapes[-1]) > min_size:
        Yl, Xl = shapes[-1]
        if Yl % 2 or Xl % 2:
            break
        shapes.append((Yl // 2, Xl // 2))
    return shapes


def mg_fits(cfg: SimConfig) -> bool:
    """f32 Galerkin MG with Chebyshev smoothing, and level sizes that stay
    even down to mg_min_size (the CUDA levels are not padded)."""
    s = cfg.solver
    if not (s.preconditioner == "mg" and s.dtype == "float32"
            and s.mg_scheme == "galerkin" and s.mg_smoother == "cheby"):
        return False
    Yl, Xl = _level_shapes(cfg.ny, cfg.nx, s.mg_min_size)[-1]
    return min(Yl, Xl) <= s.mg_min_size


def mg_pallas_fits(cfg: SimConfig) -> bool:
    """`mg_fits`, and 10.5 fine planes fit the budget: through 1672²."""
    return mg_fits(cfg) and int(cfg.ny * cfg.nx * 4 * 10.5) <= _VMEM_BUDGET


def _cycle_kwargs(cfg: SimConfig):
    s = cfg.solver
    return dict(coarse_iters=s.mg_coarse_iters,
                w=2 if s.mg_cycle == "w" else 1,
                cheby_degree=s.mg_cheby_degree, cheby_ratio=s.mg_cheby_ratio,
                coarse_ratio=s.mg_coarse_ratio, w_depth=s.mg_w_depth)


def mg_host_operands(cfg: SimConfig, a_diag, fluid):
    """(shapes, packed0, coef_planes, coef_rows) for the CUDA solver:
    the packed level-0 plane a_diag + 8*fluid, the coarse levels' (c, e, n)
    planes, and one Chebyshev row per level [inv_theta, c_prev_0, c_r_0,
    ...] (the coarsest carries the coarse-solve schedule), zero-padded to
    1 + 2*max(degree)."""
    s = cfg.solver
    f = torch.float32
    shapes = _level_shapes(cfg.ny, cfg.nx, s.mg_min_size)
    L = len(shapes)
    levels = multigrid.build_galerkin_hierarchy(a_diag, fluid, f,
                                                min_size=s.mg_min_size)
    if len(levels) != L:
        raise ValueError(f"hierarchy has {len(levels)} levels, expected {L}")
    fl = fluid.to(f)
    packed0 = a_diag.to(f) * fl + 8.0 * fl
    coef_planes = [(lv.c, lv.e, lv.n) for lv in levels[1:]]

    deg = [s.mg_cheby_degree] * (L - 1) + [s.mg_coarse_iters]
    ratio = [s.mg_cheby_ratio] * (L - 1) + [s.mg_coarse_ratio]
    lmax = torch.stack([lv.lmax for lv in levels]).to(f)
    inv_theta, coefs = multigrid.cheby_coefficients(
        lmax, max(deg), torch.tensor(ratio, dtype=f, device=lmax.device))
    cols = [inv_theta] + [c for pair in coefs for c in pair]
    rows = torch.stack(cols, dim=1)                 # [L, 1 + 2*max(deg)]
    keep = torch.tensor([[j <= 2 * d for j in range(rows.shape[1])]
                         for d in deg], device=rows.device)
    return shapes, packed0, coef_planes, torch.where(keep, rows, 0.0)


def mg_pcg_plain(cfg: SimConfig, b, apply, precon, fluid, x0=None):
    """The PCG loop shape of `_mg_pcg_solve` (the preconditioner at the
    top, s/As from zero, As' = Az + beta As, NaN-robust stop on
    max|r| <= max(tol, tol_rel * max|b|) with ||b|| taken before the
    warm-start subtraction) around z = precon(r), from p = 0 or the guess
    x0.  Reads the stop flag on the host once per iteration.  Returns (p,
    iterations, residual)."""
    s = cfg.solver
    r = b.clone()
    rmax0 = r.abs().max()
    nonzero = rmax0 != 0
    tol_eff = torch.maximum(
        torch.tensor(s.tol, dtype=b.dtype, device=b.device), s.tol_rel * rmax0)
    if x0 is None:
        p = torch.zeros_like(b)
        rmax = rmax0
        done = ~nonzero
    else:
        p = torch.where(fluid & nonzero, x0, 0.0)
        r = r - apply(p)
        rmax = r.abs().max()
        done = ~nonzero | ~(rmax > tol_eff)
    s_ = torch.zeros_like(b)
    As = torch.zeros_like(b)
    sigma = torch.zeros((), dtype=b.dtype, device=b.device)
    iters = 0
    while iters < s.max_iterations and not bool(done):
        z = precon(r)
        sigma_new = (z * r).sum()
        beta = sigma_new / torch.where(sigma != 0, sigma, 1.0)
        s_ = z + beta * s_
        As = apply(z) + beta * As
        zs = (As * s_).sum()
        alpha = sigma_new / torch.where(zs != 0, zs, 1.0)
        p = p + alpha * s_
        r = r - alpha * As
        rmax = r.abs().max()
        done = ~(rmax > tol_eff)
        sigma = sigma_new
        iters += 1
    return (p, torch.tensor(iters, dtype=torch.int32, device=b.device),
            rmax)


def solve_pressure_mg_plain(cfg: SimConfig, b, a_diag, fluid, x0=None):
    """Plain MG-PCG: `mg_pcg_plain` preconditioned by `cycle_galerkin`
    over the whole hierarchy."""
    levels = multigrid.build_galerkin_hierarchy(
        a_diag, fluid, b.dtype, min_size=cfg.solver.mg_min_size)
    kw = _cycle_kwargs(cfg)
    return mg_pcg_plain(cfg, b, lambda x: apply_a(a_diag, fluid, x),
                        lambda r: multigrid.cycle_galerkin(levels, r, **kw),
                        fluid, x0)


def _lib():
    lib = _build.load("mg_pcg")
    P, I, F = _build.PTR, _build.INT, _build.FLOAT
    _build.bind(lib, "eu_mg_pcg",
                [I, P, P, P, P, I, I, I, I, I, I, F, F, I,
                 P, P, P, P, P, P, P, P])
    return lib


class Buffers:
    """Device buffers handed to a CUDA library, kept referenced here until
    the launch that reads them is enqueued."""

    def __init__(self, device):
        self.device = device
        self.keep = []

    def new(self, shape) -> int:
        t = torch.empty(shape, dtype=torch.float32, device=self.device)
        self.keep.append(t)
        return t.data_ptr()

    def levels(self, shapes, coef_planes):
        """ctypes (shapes, planes) of a `Solve` (csrc/mg_levels.cuh):
        per level its (c, e, n) planes, or None for a packed level 0 whose
        b is the solver's r, then fresh x, b, z, rr, d, dn planes."""
        ptrs = []
        for l, ((Yl, Xl), cen) in enumerate(zip(shapes, coef_planes)):
            if cen is None:
                ptrs += [0, 0, 0, self.new((Yl, Xl)), 0]
            else:
                planes = [t.contiguous() for t in cen]
                for name, t in zip("cen", planes):
                    _build.require(t, f"{name}{l}", torch.float32, (Yl, Xl),
                                   self.device)
                self.keep.extend(planes)
                ptrs += [t.data_ptr() for t in planes]
                ptrs += [self.new((Yl, Xl)), self.new((Yl, Xl))]
            ptrs += [self.new((Yl, Xl)) for _ in range(4)]
        assert len(ptrs) == _PLANES_PER_LEVEL * len(shapes)
        flat = [v for sh in shapes for v in sh]
        return ((ctypes.c_int * len(flat))(*flat),
                (ctypes.c_void_p * len(ptrs))(*ptrs))


def cycle_args(cfg: SimConfig):
    """deg, coarse_deg, w, w_depth of the CUDA `Solve`."""
    s = cfg.solver
    return [s.mg_cheby_degree, s.mg_coarse_iters,
            2 if s.mg_cycle == "w" else 1, s.mg_w_depth]


def mg_pcg_cuda(cfg: SimConfig, operands, r, p, warm: bool):
    """Run the CUDA MG-PCG body in place: r holds b on entry (it becomes
    the residual) and, with `warm`, p holds the initial guess; p ends as
    the solution.  Returns (iterations, residual) as device tensors."""
    shapes, packed0, coef_planes, rows = operands
    s = cfg.solver
    dev = r.device
    Y, X = shapes[0]
    f = torch.float32
    _build.require(r, "r", f, (Y, X))
    _build.require(p, "p", f, (Y, X), dev)
    _build.require(packed0, "packed0", f, (Y, X), dev)
    rows = rows.contiguous()
    _build.require(rows, "coef_rows", f, device=dev)

    bufs = Buffers(dev)
    shape_arr, plane_arr = bufs.levels(shapes, [None] + list(coef_planes))
    s_buf = bufs.new((Y, X))
    as_buf = bufs.new((Y, X))
    part = bufs.new((-(-Y * X // 256),))
    scal = torch.zeros(8, dtype=f, device=dev)
    flags = torch.zeros(4, dtype=torch.int32, device=dev)

    lib = _lib()
    # the K3 count includes the solves K2 runs
    _build.LAUNCHES["K3"] += 1
    rc = lib.eu_mg_pcg(
        len(shapes), shape_arr, plane_arr, packed0.data_ptr(),
        rows.data_ptr(), rows.shape[1], *cycle_args(cfg), s.max_iterations,
        float(s.tol), float(s.tol_rel), int(warm),
        p.data_ptr(), r.data_ptr(), s_buf, as_buf, part,
        scal.data_ptr(), flags.data_ptr(), _build.stream())
    _build.check(lib, rc, "eu_mg_pcg")
    return flags[_F_ITERS].clone(), scal[_S_RESID].clone()


def solve_pressure_mg(cfg: SimConfig, b, a_diag, fluid, solid=None,
                      x0=None):
    """One Galerkin MG-PCG solve.  Returns (p, iterations, residual).
    CUDA tensors run the kernel; CPU tensors the plain version."""
    del solid  # the Galerkin hierarchy needs only a_diag and the fluid
    if b.device.type == "cpu":
        _build.PLAIN_CALLS["K3"] += 1
        return solve_pressure_mg_plain(cfg, b, a_diag, fluid, x0)
    if not mg_fits(cfg):
        raise NotImplementedError(
            "the CUDA MG-PCG needs f32 galerkin + cheby and level sizes "
            "that halve evenly to mg_min_size (ROADMAP queue 1 item M11)")
    _build.require(b, "b", torch.float32, (cfg.ny, cfg.nx))
    operands = mg_host_operands(cfg, a_diag, fluid)
    r = b.clone()
    if x0 is None:
        p = torch.empty_like(b)
    else:
        _build.require(x0, "x0", torch.float32, (cfg.ny, cfg.nx), b.device)
        p = x0.clone()
    iters, resid = mg_pcg_cuda(cfg, operands, r, p, warm=x0 is not None)
    return p, iters, resid
