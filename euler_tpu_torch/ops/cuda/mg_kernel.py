"""K3: Galerkin MG-PCG (`euler_tpu/ops/pallas/mg_kernel.py`).

`solve_pressure_mg` replaces the Pallas kernel `_mg_kernel` launched by
`solve_pressure_mg_pallas` (mg_kernel.py:697-745), same contract:
(p, iterations, residual) for A p = b, optionally warm-started from x0.
The solver body (`csrc/mg_pcg.cu`) is also the middle of K2's substep.

On an H100 the solve is bound by launches and barriers more than bytes:
a PCG iteration at 1024² is one truncated-W cycle over six levels, most
of them too small to fill the card, and three fine sweeps.  So the loop
stays on the device as far as a GPU lets it.  `MgWorkspace` owns every
buffer of a solve, and builds the Galerkin hierarchy and the Chebyshev
rows there; once per workspace it captures 8 PCG iterations into a CUDA
graph, which each solve replays, reading the stop flag once a chunk
(every kernel of an iteration is a no-op once the flag is set).  The
coarse end of each cycle visit (from the first level of at most 128²
cells) is one launch of a cluster of 8 CTAs (csrc/mg_levels.cuh).
Workspaces are cached per device and configuration (`workspace`; the key
is `workspace_key`), at most `_MAX_WORKSPACES` of them; an evicted one is
closed (`MgWorkspace.close`).

`mg_pallas_fits` is the JAX package's gate for K3 (mg_kernel.py:748);
`mg_fits` is the CUDA levels' own check that the sizes halve evenly.

`mg_host_operands` is the plain version of the hierarchy build (and
K11's operands): the Galerkin hierarchy by 2x2 block sums and the
Chebyshev rows from each level's measured Gershgorin bound, in PyTorch.
`solve_pressure_mg_plain` is the plain version of the solve: a PCG loop
of the same shape as `_mg_pcg_solve` around `multigrid.cycle_galerkin`.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.ops import multigrid
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda.pcg_kernel import _VMEM_BUDGET
from euler_tpu_torch.ops.project import apply_a

_PLANES_PER_LEVEL = 9  # c, e, n, x, b, z, rr, d, dn (csrc/mg_levels.cuh)
_S_N = 6               # scal floats of one solve
_S_RESID = 5           # scal index of the final residual max
_F_N = 3               # flags ints
_F_ITERS = 1           # flags index of the iteration count
_MAX_WORKSPACES = 4


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
    _build.bind(lib, "eu_mg_create",
                [I, P, P, P, P, P, I, I, I, I, I, F, F, I, F, F]
                + [P] * 8 + [ctypes.POINTER(ctypes.c_void_p)])
    _build.bind(lib, "eu_mg_destroy", [P])
    _build.bind(lib, "eu_mg_load", [P] * 6)
    _build.bind(lib, "eu_mg_solve", [P, I, P])
    _build.bind(lib, "eu_mg_cycle", [P, I, P, P])
    return lib


def cycle_args(cfg: SimConfig):
    """deg, coarse_deg, w, w_depth of the CUDA `Solve`."""
    s = cfg.solver
    return [s.mg_cheby_degree, s.mg_coarse_iters,
            2 if s.mg_cycle == "w" else 1, s.mg_w_depth]


def workspace_key(cfg: SimConfig, device) -> tuple:
    """What a workspace's buffers and captured launches depend on: the
    device, the level shapes, the cycle schedule, the Chebyshev ratios
    and the stopping rule."""
    s = cfg.solver
    return (str(device), tuple(_level_shapes(cfg.ny, cfg.nx, s.mg_min_size)),
            *cycle_args(cfg), s.mg_cheby_ratio, s.mg_coarse_ratio,
            s.max_iterations, s.tol, s.tol_rel)


class MgWorkspace:
    """The device buffers of one configuration's MG-PCG solves and the
    CUDA solver over them (csrc/mg_pcg.cu: the hierarchy, the rows, the
    graph of one chunk of iterations).  Per level: the c, e, n planes and
    active flags of the hierarchy (coarse levels), and x, b, z, rr, d, dn
    (level 0's b is r); the packed matrix, r, p, s, As; the block
    partials; the scalars and flags; and K2's grid-stage scratch and tail
    partials.  A solve reads and writes only these, so nothing it returns
    may alias them: callers copy out."""

    def __init__(self, cfg: SimConfig, device):
        s = cfg.solver
        f = torch.float32
        Y, X = cfg.ny, cfg.nx
        self.shapes = _level_shapes(Y, X, s.mg_min_size)
        L = len(self.shapes)
        self.keep = []

        def new(shape, dtype=f):
            t = torch.empty(shape, dtype=dtype, device=device)
            self.keep.append(t)
            return t

        plane = (Y, X)
        self.packed0, self.r, self.p, self.s, self.As = (
            new(plane) for _ in range(5))
        self.zu, self.zv = new(plane), new(plane)
        nb = -(-Y * X // 256)
        self.part = new((nb,))
        self.tail_part = new((2 * nb,))
        self.hpart = new((sum(-(-Yl * Xl // 256) for Yl, Xl in self.shapes),))
        deg = [s.mg_cheby_degree] * (L - 1) + [s.mg_coarse_iters]
        self.rows = new((L, 1 + 2 * max(deg)))
        self.scal = new((_S_N,))
        self.flags = new((_F_N,), torch.int32)
        # the coarse levels' (c, e, n, active): the hierarchy the solve builds
        self.levels = [tuple(new(shape) for _ in range(3))
                       + (new(shape, torch.uint8),)
                       for shape in self.shapes[1:]]
        planes, act = [], [0]
        for l, shape in enumerate(self.shapes):
            if l == 0:
                planes += [0, 0, 0, new(shape).data_ptr(), 0]
            else:
                c, e, n, active = self.levels[l - 1]
                planes += [c.data_ptr(), e.data_ptr(), n.data_ptr(),
                           new(shape).data_ptr(), new(shape).data_ptr()]
                act.append(active.data_ptr())
            planes += [new(shape).data_ptr() for _ in range(4)]
        assert len(planes) == _PLANES_PER_LEVEL * L
        flat = [v for sh in self.shapes for v in sh]
        self.lib = _lib()
        self.handle = None
        handle = ctypes.c_void_p()
        with torch.cuda.device(device):
            rc = self.lib.eu_mg_create(
                L, (ctypes.c_int * len(flat))(*flat),
                (ctypes.c_void_p * len(planes))(*planes),
                (ctypes.c_void_p * L)(*act), self.packed0.data_ptr(),
                self.rows.data_ptr(), self.rows.shape[1], *cycle_args(cfg),
                s.mg_cheby_ratio, s.mg_coarse_ratio, s.max_iterations,
                s.tol, s.tol_rel, *(t.data_ptr() for t in (self.p, self.r, self.s, self.As,
                                         self.part, self.hpart, self.scal,
                                         self.flags)),
                ctypes.byref(handle))
        _build.check(self.lib, rc, "eu_mg_create")
        self.handle = handle.value

    @property
    def nbytes(self) -> int:
        """Device bytes of the workspace's buffers."""
        return sum(t.numel() * t.element_size() for t in self.keep)

    def close(self):
        """Free the solver and its graph once the last solve's replays have
        run; raises when that fails."""
        handle, self.handle = self.handle, None
        if handle:
            _build.check(self.lib, self.lib.eu_mg_destroy(handle),
                         "eu_mg_destroy")

    def load(self, a_diag, fluid, b, x0=None):
        """K3's head: packed0 from a_diag and fluid, r = b, p = x0."""
        rc = self.lib.eu_mg_load(
            self.handle, a_diag.data_ptr(), fluid.data_ptr(), b.data_ptr(),
            None if x0 is None else x0.data_ptr(), _build.stream())
        _build.check(self.lib, rc, "eu_mg_load")

    def solve(self, warm: bool):
        """One MG-PCG solve on the loaded workspace: p ends as the
        solution.  Returns (iterations, residual) as fresh device
        tensors."""
        # the K3 count includes the solves K2 runs
        _build.LAUNCHES["K3"] += 1
        rc = self.lib.eu_mg_solve(self.handle, int(warm), _build.stream())
        _build.check(self.lib, rc, "eu_mg_solve")
        return self.flags[_F_ITERS].clone(), self.scal[_S_RESID].clone()

    def cycle(self, per_op: bool):
        """z = M r for the loaded r on the hierarchy of the last solve,
        through the coarse cycle or one launch per level operation (the
        card tests hold the two bitwise equal).  Returns z, fresh."""
        z = torch.empty_like(self.r)
        rc = self.lib.eu_mg_cycle(self.handle, int(per_op), z.data_ptr(),
                                  _build.stream())
        _build.check(self.lib, rc, "eu_mg_cycle")
        return z


_WORKSPACES: collections.OrderedDict = collections.OrderedDict()


def workspace(cfg: SimConfig, device) -> MgWorkspace:
    """The cached workspace of `cfg` on `device` (least recently used
    first out)."""
    key = workspace_key(cfg, device)
    ws = _WORKSPACES.pop(key, None)
    if ws is None:
        ws = MgWorkspace(cfg, device)
    _WORKSPACES[key] = ws
    while len(_WORKSPACES) > _MAX_WORKSPACES:
        _WORKSPACES.popitem(last=False)[1].close()
    return ws


def clear_workspaces() -> None:
    """Close and drop every cached workspace."""
    while _WORKSPACES:
        _WORKSPACES.popitem()[1].close()


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
    plane = (cfg.ny, cfg.nx)
    f = torch.float32
    dev = b.device
    _build.require(b, "b", f, plane)
    _build.require(a_diag, "a_diag", torch.int32, plane, dev)
    _build.require(fluid, "fluid", torch.bool, plane, dev)
    if x0 is not None:
        _build.require(x0, "x0", f, plane, dev)
    ws = workspace(cfg, dev)
    ws.load(a_diag, fluid, b, x0)
    iters, resid = ws.solve(warm=x0 is not None)
    return ws.p.clone(), iters, resid
