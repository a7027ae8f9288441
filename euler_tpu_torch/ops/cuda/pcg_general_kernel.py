"""P1, P2, P3 and P7: the general PCG solve and the IC(0) preconditioner
(`csrc/pcg_general.cu`), the same loop with the Galerkin MG cycle as its
preconditioner (`csrc/pcg_mg.cu`), and with the rediscretized V-cycle
(`csrc/pcg_mg_redisc.cu`).

`solve_pressure_general` (P1) runs where the JAX package's
`solve_pressure` falls through to its jnp `pcg_loop`
(euler_tpu/ops/project.py:110-178): every f64 solve, the solve without a
preconditioner, IC(0), and Jacobi beyond K8's gate with rows that are not
a multiple of 8 (K12's gate).  Same contract: (p, iterations, residual),
warm-started from `x0` when given, the jnp-form Jacobi preconditioner
(`ops/project.jacobi_preconditioner_jnp`, not K8's invd * r).  Its plain
version is `ops/project.pcg_loop` with `make_preconditioner`.
`ic0_apply` (P2) is IC(0)'s z = M^-1 r with E_inv built anew, the
preconditioner step P1 runs once an iteration with IC(0); its plain
version is `ops/ic0.make_ic0_preconditioner`.  Neither replaces a
`pallas_call`.

With `preconditioner="mg"` and the Galerkin scheme (Chebyshev or RB-GS
smoothing, f32 or f64), the same wrapper runs P3: where the JAX package's
MG falls through to its jnp `pcg_loop` (in f32 Chebyshev, level sizes that
do not halve evenly to mg_min_size: 1080 x 1920, 1200², 1448², 999²; K3's
and K11's gates are the JAX package's; in f64 or with RB-GS, every size,
since every JAX Pallas MG gate is f32 Chebyshev only), P1's loop with one
MG cycle (csrc/mg_levels.cuh) as its preconditioner step, on a hierarchy
built on the card each solve at the padded level shapes of
`mg_kernel.padded_level_shapes`, all in the solver dtype (the f64
Chebyshev rows from f64 bounds, as the JAX package takes them).  An odd
grid is solved on its padded level-0 shape (the inputs at the top left,
the pad not fluid) and p cropped.  P3 reads the stop flag after every
chunk of 8 iterations (an MG solve stops within a few), not between
batches of 13.  Its plain version is the same `pcg_loop` with
`make_preconditioner` ("mg": `multigrid.make_mg_preconditioner`), and
`mg_kernel.mg_host_operands` the plain version of its hierarchy build.
With `mg_scheme="rediscretize"` (every size, f32 or f64) it runs P7: the
same loop with one V-cycle of the rediscretized hierarchy (masks
coarsened, the operator rebuilt; bilinear transfers; RB-GS), the
hierarchy built on the card each solve, one launch a level, at the
unpadded shapes of `mg_kernel.rediscretized_shapes`; it needs the solid
mask.  Its plain version is `pcg_loop` with `multigrid.v_cycle`, and
`multigrid.build_hierarchy` that of its hierarchy build.

On an H100 an iteration of P1 is bound by its five plane sweeps' bytes
and three grid-wide reductions; P2 by its 2 (Y + X - 1) dependent
diagonal steps (one CTA), not its bytes.  Every buffer lives in a
workspace cached per device, grid, precision and preconditioner (and MG
scheme, smoother and schedule), with a CUDA graph of 8 iterations that a
solve replays up to its cap, reading the stop flag between batches of 13
replays (as K8; P3 and P7 after every replay).  The launch count "P1"
counts solves; "P2" counts the solves that apply IC(0) inside P1 and the
calls of `ic0_apply`; "P3" counts the Galerkin MG solves, "P7" the
rediscretized ones.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda.mg_kernel import (
    _PLANES_PER_LEVEL,
    cycle_args,
    galerkin_cheby,
    galerkin_rbgs,
    padded_level_shapes,
    rediscretized,
    rediscretized_shapes,
)
from euler_tpu_torch.ops.ic0 import make_ic0_preconditioner
from euler_tpu_torch.ops.project import apply_a, make_preconditioner, pcg_loop

_PRECON = {"none": 0, "jacobi": 1, "ic0": 2}
_S_RESID = 4   # scal index of the final max|r|
_S_N = 5
_F_ITERS = 1   # flags index of the iteration count
_F_N = 6
_PARTS = 1024
_MAX_WORKSPACES = 4
_MAX_WORKSPACE_BYTES = 512 * 2**20


@functools.cache
def general_lib():
    """csrc/pcg_general.cu: P1 (`eu_pcg_*`) and P2 (`eu_ic0_apply`)."""
    lib = _build.load("pcg_general", flags=["-fmad=false"])
    P, I = _build.PTR, _build.INT
    D = ctypes.c_double
    _build.bind(lib, "eu_pcg_create",
                [I] * 4 + [P] * 11 + [ctypes.POINTER(ctypes.c_void_p)])
    _build.bind(lib, "eu_pcg_destroy", [P])
    _build.bind(lib, "eu_pcg_solve", [P, I, D, D] + [P] * 5)
    _build.bind(lib, "eu_ic0_apply", [I] * 3 + [P] * 8)
    return lib


@functools.cache
def mg_lib():
    """csrc/pcg_mg.cu: P3 (`eu_pcg_mg_*`)."""
    lib = _build.load("pcg_mg", flags=["-fmad=false"])
    P, I = _build.PTR, _build.INT
    D = ctypes.c_double
    _build.bind(lib, "eu_pcg_mg_create",
                [I] * 6 + [P] * 5 + [I] * 8 + [D, D] + [P] * 12
                + [ctypes.POINTER(ctypes.c_void_p)])
    _build.bind(lib, "eu_pcg_mg_destroy", [P])
    _build.bind(lib, "eu_pcg_mg_solve", [P, I, D, D] + [P] * 5)
    _build.bind(lib, "eu_pcg_mg_cycle", [P, I, P, P, P])
    _build.bind(lib, "eu_pcg_mg_plan", [P, P])
    return lib


@functools.cache
def redisc_lib():
    """csrc/pcg_mg_redisc.cu: P7 (`eu_pcg_redisc_*`)."""
    lib = _build.load("pcg_mg_redisc", flags=["-fmad=false"])
    P, I = _build.PTR, _build.INT
    D = ctypes.c_double
    _build.bind(lib, "eu_pcg_redisc_create",
                [I] * 4 + [P] * 7 + [I] * 3 + [P] * 11
                + [ctypes.POINTER(ctypes.c_void_p)])
    _build.bind(lib, "eu_pcg_redisc_destroy", [P])
    _build.bind(lib, "eu_pcg_redisc_solve", [P, I, D, D] + [P] * 6)
    _build.bind(lib, "eu_pcg_redisc_cycle", [P] * 4)
    return lib


def solve_pressure_general_plain(cfg: SimConfig, b, a_diag, fluid, x0=None,
                                 solid=None):
    """`pcg_loop` with the configured preconditioner."""
    return pcg_loop(cfg, b, lambda s: apply_a(a_diag, fluid, s),
                    make_preconditioner(cfg, a_diag, fluid, solid), x0=x0)


class GeneralWorkspace:
    """The device buffers of one grid's general solves in one precision
    with one preconditioner, and the CUDA solver over them."""

    def __init__(self, Y: int, X: int, dtype, precon: str, device):
        self._planes(Y, X, dtype, device)
        self.lib = general_lib()
        self._solve, self._destroy = (self.lib.eu_pcg_solve,
                                      self.lib.eu_pcg_destroy)
        self.handle = None
        handle = ctypes.c_void_p()
        with torch.cuda.device(device):
            rc = self.lib.eu_pcg_create(
                Y, X, int(dtype == torch.float64), _PRECON[precon],
                *self._loop_ptrs(), ctypes.byref(handle))
        _build.check(self.lib, rc, "eu_pcg_create")
        self.handle = handle.value

    def _planes(self, Y, X, dtype, device):
        """The loop's buffers: code, p, r, d, z, ad, pre, q, part, scal,
        flags."""
        self.code = torch.empty((Y, X), dtype=torch.uint8, device=device)
        self.planes = torch.empty((7, Y, X), dtype=dtype, device=device)
        self.part = torch.empty(_PARTS, dtype=dtype, device=device)
        self.scal = torch.empty(_S_N, dtype=dtype, device=device)
        self.flags = torch.empty(_F_N, dtype=torch.int32, device=device)
        self.keep = [self.code, self.planes, self.part, self.scal,
                     self.flags]

    def _loop_ptrs(self):
        """code, p, r, d, z, ad, pre, q, then part, scal, flags."""
        return ([self.code.data_ptr()]
                + [self.planes[k].data_ptr() for k in range(7)]
                + [t.data_ptr() for t in (self.part, self.scal,
                                          self.flags)])

    @property
    def p(self):
        return self.planes[0]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.keep)

    def solve(self, s, a_diag, fluid, b, x0):
        """One solve of A p = b (device pointers) with the caps of solver
        config `s`: p stays in `self.p`."""
        rc = self._solve(self.handle, s.max_iterations, float(s.tol),
                         float(s.tol_rel), a_diag, fluid, b, x0,
                         _build.stream())
        _build.check(self.lib, rc, self._solve.__name__)

    def close(self):
        """Free the solver once its last solve's replays have run."""
        handle, self.handle = self.handle, None
        if handle:
            _build.check(self.lib, self._destroy(handle),
                         self._destroy.__name__)


class MgGeneralWorkspace(GeneralWorkspace):
    """P3's buffers in the solver dtype (f32 or f64): the loop's planes at
    the padded level-0 shape, and per coarse level the hierarchy's c, e, n
    planes and active flags and the cycle's x, b, z, rr, d, dn; the packed
    level 0, the Chebyshev rows and the hierarchy's partials; and the CUDA
    solver over them (its level-0 scratch is the loop's planes), with
    Chebyshev or, with mg_smoother "rbgs", RB-GS smoothing (which uses only
    c, e, n, x and b of a level; its head builds no rows).
    `shapes` are the stored level shapes (`padded_level_shapes`)."""

    def __init__(self, cfg: SimConfig, device):
        s = cfg.solver
        f = getattr(torch, s.dtype)
        self.shapes = padded_level_shapes(cfg.ny, cfg.nx, s.mg_min_size)
        L = len(self.shapes)
        if L > 16:
            raise NotImplementedError(f"P3 takes at most 16 levels, not {L}")
        Y, X = self.shapes[0]
        self._planes(Y, X, f, device)
        levels = self._mg_levels(cfg, device)
        ptrs = self._loop_ptrs()
        self.lib = mg_lib()
        self._solve, self._destroy = (self.lib.eu_pcg_mg_solve,
                                      self.lib.eu_pcg_mg_destroy)
        self.handle = None
        handle = ctypes.c_void_p()
        with torch.cuda.device(device):
            rc = self.lib.eu_pcg_mg_create(
                Y, X, cfg.ny, cfg.nx, int(f == torch.float64), *levels,
                *cycle_args(cfg), int(galerkin_rbgs(cfg)), s.mg_pre_smooth,
                s.mg_post_smooth, s.mg_cheby_ratio, s.mg_coarse_ratio,
                *ptrs[:8], ptrs[8], self.hpart.data_ptr(), *ptrs[9:],
                ctypes.byref(handle))
        _build.check(self.lib, rc, "eu_pcg_mg_create")
        self.handle = handle.value

    def plan(self) -> dict:
        """The cycle's plan on the card: the level where its coarse end
        runs as one cluster launch ("fused"; the level count "levels":
        none) and that launch's shared memory in bytes ("smem")."""
        out = (ctypes.c_int * 3)()
        _build.check(self.lib, self.lib.eu_pcg_mg_plan(self.handle, out),
                     "eu_pcg_mg_plan")
        return {"fused": out[0], "smem": out[1], "levels": out[2]}

    def _mg_levels(self, cfg: SimConfig, device, own0: bool = False):
        """The cycle's buffers at `self.shapes` (the loop's planes are
        level 0, or with `own0` level 0 has x, b, z, rr, d, dn of its own,
        b and the packed level 0 zero: P4's padded level 0): the packed
        level 0, the Chebyshev rows, the hierarchy's partials and per
        coarse level c, e, n, active and the cycle's x, b, z, rr, d, dn.
        Returns the create call's (L, shapes, planes, act, packed0, rows,
        ncoef) arguments.  Every plane is in the dtype of the loop's."""
        s, f = cfg.solver, self.planes.dtype
        L = len(self.shapes)

        def new(shape, dtype=f, zero=False):
            t = (torch.zeros if zero else torch.empty)(shape, dtype=dtype,
                                                       device=device)
            self.keep.append(t)
            return t

        self.packed0 = new(self.shapes[0], zero=own0)
        deg = [s.mg_cheby_degree] * (L - 1) + [s.mg_coarse_iters]
        self.rows = new((L, 1 + 2 * max(deg)))
        self.hpart = new((sum(-(-Yl * Xl // 256) for Yl, Xl in self.shapes),))
        self.levels = [tuple(new(shape) for _ in range(3))
                       + (new(shape, torch.uint8),)
                       for shape in self.shapes[1:]]
        # level 0's pointers are the loop's planes, set by the library
        planes, act = [0] * _PLANES_PER_LEVEL, [0]
        if own0:
            planes[3:] = [new(self.shapes[0], zero=k == 1).data_ptr()
                          for k in range(6)]
        for (c, e, n, active), shape in zip(self.levels, self.shapes[1:]):
            planes += [c.data_ptr(), e.data_ptr(), n.data_ptr()]
            planes += [new(shape).data_ptr() for _ in range(6)]
            act.append(active.data_ptr())
        flat = [v for sh in self.shapes for v in sh]
        return (L, (ctypes.c_int * len(flat))(*flat),
                (ctypes.c_void_p * len(planes))(*planes),
                (ctypes.c_void_p * L)(*act), self.packed0.data_ptr(),
                self.rows.data_ptr(), self.rows.shape[1])

    def cycle(self, r, per_op: bool):
        """z = M r for `r` ([Y, X] at the planes' shape, in the solver
        dtype) on the hierarchy of the last solve, through the coarse cycle
        or one launch per level operation (the card tests hold the two
        bitwise equal).  Overwrites the workspace's r and z.  Returns z,
        fresh."""
        _build.require(r, "r", self.p.dtype, self.shapes[0], self.p.device)
        z = torch.empty_like(r)
        rc = self.lib.eu_pcg_mg_cycle(self.handle, int(per_op), r.data_ptr(),
                                      z.data_ptr(), _build.stream())
        _build.check(self.lib, rc, "eu_pcg_mg_cycle")
        return z


class RediscWorkspace(GeneralWorkspace):
    """P7's buffers in the solver dtype (f32 or f64): the loop's planes at
    the grid's shape, per level of `shapes` (`rediscretized_shapes`) the
    hierarchy's fluid and solid masks, a_diag (i32) and inv_diag
    (`levels`, the build's outputs) and below level 0 the cycle's x and b;
    and the CUDA solver over them (level 0's x and b are the loop's z and
    r)."""

    def __init__(self, cfg: SimConfig, device):
        s = cfg.solver
        f = getattr(torch, s.dtype)
        self.shapes = rediscretized_shapes(cfg.ny, cfg.nx, s.mg_min_size)
        L = len(self.shapes)
        Y, X = self.shapes[0]
        self._planes(Y, X, f, device)

        def new(shape, dtype=f):
            t = torch.empty(shape, dtype=dtype, device=device)
            self.keep.append(t)
            return t

        self.levels = [(new(sh, torch.bool), new(sh, torch.bool),
                        new(sh, torch.int32), new(sh)) for sh in self.shapes]
        xb = [(0, 0)] + [(new(sh).data_ptr(), new(sh).data_ptr())
                            for sh in self.shapes[1:]]
        arr = lambda v: (ctypes.c_void_p * L)(*v)  # noqa: E731
        flat = [v for sh in self.shapes for v in sh]
        ptrs = self._loop_ptrs()
        self.lib = redisc_lib()
        self._solve, self._destroy = (self.lib.eu_pcg_redisc_solve,
                                      self.lib.eu_pcg_redisc_destroy)
        self.handle = None
        handle = ctypes.c_void_p()
        with torch.cuda.device(device):
            rc = self.lib.eu_pcg_redisc_create(
                Y, X, int(f == torch.float64), L,
                (ctypes.c_int * len(flat))(*flat),
                *(arr([lv[k].data_ptr() for lv in self.levels])
                  for k in range(4)),
                arr([c[0] for c in xb]), arr([c[1] for c in xb]),
                s.mg_pre_smooth, s.mg_post_smooth, s.mg_coarse_iters,
                *ptrs, ctypes.byref(handle))
        _build.check(self.lib, rc, "eu_pcg_redisc_create")
        self.handle = handle.value

    def solve(self, s, a_diag, fluid, b, x0, solid=None):
        """One solve of A p = b (device pointers; `solid` the solid mask's)
        with the caps of solver config `s`: p stays in `self.p`."""
        rc = self._solve(self.handle, s.max_iterations, float(s.tol),
                         float(s.tol_rel), a_diag, fluid, solid, b, x0,
                         _build.stream())
        _build.check(self.lib, rc, self._solve.__name__)

    def cycle(self, r):
        """z = M r, one V-cycle on `r` ([Y, X] in the solver dtype) over
        the hierarchy of the last solve.  Overwrites the workspace's r and
        z.  Returns z, fresh."""
        _build.require(r, "r", self.p.dtype, self.shapes[0], self.p.device)
        z = torch.empty_like(r)
        rc = self.lib.eu_pcg_redisc_cycle(self.handle, r.data_ptr(),
                                          z.data_ptr(), _build.stream())
        _build.check(self.lib, rc, "eu_pcg_redisc_cycle")
        return z


_WORKSPACES: collections.OrderedDict = collections.OrderedDict()


def workspace_key(cfg: SimConfig, device) -> tuple:
    """What a workspace's buffers and captured launches depend on: the
    device, the grid, the solver dtype and the preconditioner, and for MG
    the scheme, the smoother and its sweeps, the stored level shapes, the
    cycle schedule and the Chebyshev ratios."""
    s = cfg.solver
    key = (str(device), cfg.ny, cfg.nx, s.dtype, s.preconditioner)
    if s.preconditioner == "mg":
        key += (s.mg_scheme, s.mg_smoother, s.mg_pre_smooth,
                s.mg_post_smooth,
                tuple(padded_level_shapes(cfg.ny, cfg.nx, s.mg_min_size)),
                *cycle_args(cfg), s.mg_cheby_ratio, s.mg_coarse_ratio)
    return key


def workspace(cfg: SimConfig, device) -> GeneralWorkspace:
    """The cached workspace of `cfg`'s grid, solver dtype and
    preconditioner (and MG scheme and schedule) on `device`."""
    kind, dt = cfg.solver.preconditioner, cfg.solver.dtype

    def make():
        if rediscretized(cfg):
            return RediscWorkspace(cfg, device)
        if kind == "mg":
            return MgGeneralWorkspace(cfg, device)
        return GeneralWorkspace(cfg.ny, cfg.nx, getattr(torch, dt), kind,
                                device)

    return _build.cached(_WORKSPACES, workspace_key(cfg, device), make,
                         _MAX_WORKSPACES, _MAX_WORKSPACE_BYTES)


def clear_workspaces() -> None:
    """Close and drop every cached workspace."""
    _build.close_all(_WORKSPACES)


def solver_name(cfg: SimConfig) -> str:
    """The launch count a general solve of `cfg` adds to: "P7" for the
    rediscretized MG, "P3" for the Galerkin MG, else "P1"."""
    if cfg.solver.preconditioner != "mg":
        return "P1"
    return "P7" if rediscretized(cfg) else "P3"


def solve_pressure_general(cfg: SimConfig, b, a_diag, fluid, x0=None,
                           solid=None):
    """PCG for A p = b with the configured preconditioner ("none",
    "jacobi" in the jnp form, "ic0"; "mg": P3, or P7 with the
    rediscretized scheme, which needs `solid`) in b's dtype (the
    solver's), from `x0` when given.  Returns (p, iterations, residual).
    CUDA tensors run P1 (and P2 for IC(0)), P3 or P7 on the cached
    workspace; CPU tensors the plain version."""
    s = cfg.solver
    name = solver_name(cfg)
    if b.device.type == "cpu":
        _build.PLAIN_CALLS[name] += 1
        return solve_pressure_general_plain(cfg, b, a_diag, fluid, x0, solid)
    if s.preconditioner not in _PRECON and not (
            galerkin_cheby(cfg) or galerkin_rbgs(cfg) or rediscretized(cfg)):
        raise NotImplementedError(
            f"the general solve has no {s.preconditioner!r} form in "
            f"{s.dtype} ({s.mg_scheme} / {s.mg_smoother})")
    dev = b.device
    plane = (cfg.ny, cfg.nx)
    dtype = getattr(torch, s.dtype)
    p_b = _build.require(b, "b", dtype, plane)
    p_a = _build.require(a_diag, "a_diag", torch.int32, plane, dev)
    p_fl = _build.require(fluid, "fluid", torch.bool, plane, dev)
    p_x0 = (None if x0 is None
            else _build.require(x0, "x0", dtype, plane, dev))
    extra = ()
    if name == "P7":
        if solid is None:
            raise ValueError("mg preconditioner needs the solid mask")
        extra = (_build.require(solid, "solid", torch.bool, plane, dev),)
    ws = workspace(cfg, dev)
    _build.LAUNCHES[name] += 1
    if s.preconditioner == "ic0":
        _build.LAUNCHES["P2"] += 1
    ws.solve(s, p_a, p_fl, p_b, p_x0, *extra)
    return (ws.p[:cfg.ny, :cfg.nx].clone(), ws.flags[_F_ITERS].clone(),
            ws.scal[_S_RESID].clone())


def ic0_apply(a_diag, fluid, r, e_inv: bool = False):
    """z = M^-1 r of IC(0) (E_inv built anew) in r's dtype, or with
    `e_inv` (z, E_inv).  CUDA tensors run P2; CPU tensors the plain
    version."""
    if r.device.type == "cpu":
        _build.PLAIN_CALLS["P2"] += 1
        apply = make_ic0_preconditioner(a_diag, fluid, r.dtype)
        z = apply(r)
        return (z, apply.e_inv) if e_inv else z
    Y, X = fluid.shape
    dev = r.device
    if r.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"r: dtype {r.dtype}, expected float32 or float64")
    p_r = _build.require(r, "r", r.dtype, (Y, X))
    p_a = _build.require(a_diag, "a_diag", torch.int32, (Y, X), dev)
    p_fl = _build.require(fluid, "fluid", torch.bool, (Y, X), dev)
    z = torch.empty_like(r)
    code = torch.empty((Y, X), dtype=torch.uint8, device=dev)
    pre, q = torch.empty_like(r), torch.empty_like(r)
    lib = general_lib()
    _build.LAUNCHES["P2"] += 1
    rc = lib.eu_ic0_apply(Y, X, int(r.dtype == torch.float64), p_a, p_fl,
                          p_r, z.data_ptr(), code.data_ptr(),
                          pre.data_ptr(), q.data_ptr(), _build.stream())
    _build.check(lib, rc, "eu_ic0_apply")
    return (z, pre) if e_inv else z
