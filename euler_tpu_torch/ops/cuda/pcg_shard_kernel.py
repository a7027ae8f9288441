"""P4: the PCG solve on one block of a grid split over ranks
(`csrc/pcg_shard.cu`), the port of the JAX package's `_pcg_sharded`
(euler_tpu/parallel/halo.py:88-148: ops/project.py's `pcg_loop` under
shard_map, psum / pmax reductions and a halo-exchanging operator; no
pallas_call).

`solve_pressure_sharded(cfg, comm, axes, b, a_diag, fluid, x0)` solves
A p = b on this block of the blocks along `axes` ("y", or "y" and "x")
of `comm` (`parallel/comm.py`).  CUDA tensors run P4: P1's loop
(csrc/pcg_loop.cuh with SHARD = true) one stage at a time (`HEAD`,
`WARM`, `HEAD_TAIL`, `ITERATION`),
each block's reductions all-reduced over the blocks between the stage
that folds them and the stage that uses them, and the edges of d (of p
for a warm start) exchanged before each apply.  On an NCCL group the
collectives are NCCL's, on the loop's stream; on an in-process
`LocalGroup` the fold of the blocks in rank order.  CPU tensors run the
plain version, `parallel/halo.pcg_sharded` (the port's `pcg_loop` with
the same collectives).  A gloo group with CUDA tensors raises: P4 does
not copy to the host.

Preconditioners: "none" (z = r on the fluid), "jacobi" (the jnp form,
halo.py:136-139) and "mg", in f32 or f64: block-Jacobi additive
Schwarz, P3's cycle (csrc/mg_levels.cuh) on the block's own hierarchy,
built on the card from the block's operator (the global a_diag, cut), at
`mg_kernel.padded_level_shapes` of the block, every level, row and
partial in the solver dtype: a block with an odd side (135 rows) keeps
its level 0 padded on planes of its own, r copied in with a zero pad
before the cycle and z cropped out after it.  `halo.
make_sharded_pressure_solver` gives P4 "jacobi" for every preconditioner
but "mg", as halo.py does; the frame on blocks gives it its own "none"
and "jacobi" (its "mg" and "ic0" are P5's and P6's).

There is no CUDA graph: a collective sits between every reduction and
its use.  The host reads the stop flag after every chunk of 8
iterations; every block stops on the same iteration, and every kernel
and finish is a no-op after the stop, so the blocks always enqueue the
same collectives.  On an H100 an iteration's device work is P1's (five
plane sweeps, bound by bytes); the host's four stage calls, three
all-reduces and one exchange an iteration bound it at the sizes here.
The launch count "P4" counts a block's solves.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda.mg_kernel import (
    cycle_args,
    galerkin_cheby,
    padded_level_shapes,
)
from euler_tpu_torch.ops.cuda.pcg_general_kernel import (
    _F_ITERS,
    _S_RESID,
    MgGeneralWorkspace,
)

_PRECON = {"none": 0, "jacobi": 1, "mg": 3}
_F_DONE = 0
_CHUNK = 8
# the stages of a solve (csrc/pcg_shard.cu) and the all-reduce after each
HEAD = ((0, "max"), (1, None))
WARM = ((2, "max"),)
HEAD_TAIL = ((3, "sum"), (4, None))
ITERATION = ((5, "sum"), (6, "max"), (7, "sum"), (8, None))


@functools.cache
def shard_lib():
    """csrc/pcg_shard.cu: P4 (`eu_pcg_shard_*`)."""
    lib = _build.load("pcg_shard", flags=["-fmad=false"])
    P, I = _build.PTR, _build.INT
    D = ctypes.c_double
    _build.bind(lib, "eu_pcg_shard_create",
                [I] * 5 + [P] * 5 + [I] * 5 + [D, D] + [P] * 13
                + [ctypes.POINTER(ctypes.c_void_p)])
    _build.bind(lib, "eu_pcg_shard_destroy", [P])
    _build.bind(lib, "eu_pcg_shard_stage", [P, I, I, D, D] + [P] * 9)
    _build.bind(lib, "eu_pcg_shard_plan", [P, P])
    return lib


class ShardWorkspace(MgGeneralWorkspace):
    """One block's buffers: P1's planes at the block's shape, the one-value
    reduction buffer `red`, and for MG P3's levels of the block (level 0
    on planes of its own where it is padded); and the CUDA solver over
    them."""

    def __init__(self, cfg: SimConfig, shape, device):
        s = cfg.solver
        dtype = getattr(torch, s.dtype)
        Y, X = shape
        mg = s.preconditioner == "mg"
        self._planes(Y, X, dtype, device)
        self.red = torch.zeros(1, dtype=dtype, device=device)
        self.keep.append(self.red)
        if mg:
            self.shapes = padded_level_shapes(Y, X, s.mg_min_size)
            levels = self._mg_levels(cfg, device,
                                     tuple(self.shapes[0]) != (Y, X))
            ratios = (s.mg_cheby_ratio, s.mg_coarse_ratio)
            hpart = self.hpart.data_ptr()
        else:
            levels = (0, None, None, None, None, None, 0)
            ratios, hpart = (0.0, 0.0), None
        cyc = cycle_args(cfg) if mg else [0, 0, 0, 0]
        ptrs = self._loop_ptrs()
        self.lib = shard_lib()
        self._destroy = self.lib.eu_pcg_shard_destroy
        self.handle = None
        handle = ctypes.c_void_p()
        with torch.cuda.device(device):
            rc = self.lib.eu_pcg_shard_create(
                Y, X, int(dtype == torch.float64), _PRECON[s.preconditioner],
                *levels, *cyc, *ratios, *ptrs[:8], ptrs[8], hpart,
                *ptrs[9:], self.red.data_ptr(), ctypes.byref(handle))
        _build.check(self.lib, rc, "eu_pcg_shard_create")
        self.handle = handle.value

    @property
    def d(self):
        return self.planes[2]

    def plan(self) -> dict:
        """The block MG cycle's plan on the card: the level where its
        coarse end runs as one cluster launch ("fused"; the level count
        "levels": none) and that launch's shared memory in bytes
        ("smem"); zeros without MG."""
        out = (ctypes.c_int * 3)()
        _build.check(self.lib, self.lib.eu_pcg_shard_plan(self.handle, out),
                     "eu_pcg_shard_plan")
        return {"fused": out[0], "smem": out[1], "levels": out[2]}

    def solve(self, comm, axes, s, a_diag, fluid, b, x0):
        """One solve of A p = b on this block (device pointers), the
        collectives through `comm` over `axes`: p stays in `self.p`."""
        lib, h = self.lib, self.handle
        cap, tol, tol_rel = s.max_iterations, float(s.tol), float(s.tol_rel)
        keep = []

        def halo(plane):
            below, above = comm.exchange(plane, 1, "y")
            left = right = None
            if "x" in axes:
                left, right = comm.exchange(plane, 1, "x")
            keep[:] = [below, above, left, right]
            return [None if t is None else t.data_ptr() for t in keep]

        def run(stages, edges=(None,) * 4):
            for k, op in stages:
                rc = lib.eu_pcg_shard_stage(h, k, cap, tol, tol_rel, a_diag,
                                            fluid, b, x0, *edges,
                                            _build.stream())
                _build.check(lib, rc, "eu_pcg_shard_stage")
                if op is not None:
                    comm.all_reduce(self.red, op, axes)

        run(HEAD)
        if x0 is not None:
            run(WARM, halo(self.p))
        run(HEAD_TAIL)
        for chunk in range(-(-cap // _CHUNK)):
            if chunk and int(self.flags[_F_DONE]):
                break
            for _ in range(_CHUNK):
                run(ITERATION[:1], halo(self.d))
                run(ITERATION[1:])

    def close(self):
        handle, self.handle = self.handle, None
        if handle:  # the solver is host memory only: no wait for the card
            _build.check(self.lib, self._destroy(handle),
                         self._destroy.__name__)


def workspace(cfg: SimConfig, comm, shape, device) -> ShardWorkspace:
    """This block's workspace for `cfg`'s solver at `shape`, kept by its
    comm (blocks of one process never share one)."""
    s = cfg.solver
    key = (str(device), tuple(shape), s.dtype, s.preconditioner)
    if s.preconditioner == "mg":
        key += (s.mg_min_size, *cycle_args(cfg), s.mg_cheby_ratio,
                s.mg_coarse_ratio)
    ws = comm.workspaces.get(key)
    if ws is None:
        ws = comm.workspaces[key] = ShardWorkspace(cfg, shape, device)
    return ws


def check_solver(cfg: SimConfig) -> None:
    """Raise NotImplementedError for the solvers that no solve on blocks
    (P4, P5, P6) runs, naming their ROADMAP items: MG other than Galerkin
    with Chebyshev smoothing (RB-GS and the rediscretized hierarchy, which
    P3 and P7 run on one card: M14 part b).  Every solver they run, runs
    in f32 and in f64."""
    s = cfg.solver
    if s.dtype not in ("float32", "float64"):
        raise ValueError(f"solver dtype {s.dtype!r}")
    if s.preconditioner == "mg" and not galerkin_cheby(cfg):
        raise NotImplementedError(
            f"MG {s.mg_scheme} / {s.mg_smoother}: only galerkin MG with "
            "Chebyshev smoothing runs on blocks; RB-GS and rediscretized "
            "MG on blocks are ROADMAP queue 1 item M14 part b")
    if s.preconditioner not in (*_PRECON, "ic0"):
        raise ValueError(f"preconditioner {s.preconditioner!r}")


def solve_pressure_sharded(cfg: SimConfig, comm, axes, b, a_diag, fluid,
                           x0=None):
    """PCG for A p = b on this block (see the top of this module).
    Returns (p, iterations, residual), the last two the same on every
    block."""
    check_solver(cfg)
    kind = cfg.solver.preconditioner
    if kind not in _PRECON:
        raise ValueError(f"P4 runs {sorted(_PRECON)}, not {kind!r} (IC(0) "
                         "on blocks is P6, parallel/spatial_ic0.py)")
    if b.device.type == "cpu":
        from euler_tpu_torch.ops.project import make_preconditioner
        from euler_tpu_torch.parallel.halo import pcg_sharded

        _build.PLAIN_CALLS["P4"] += 1
        precon = (None if kind == "mg"
                  else make_preconditioner(cfg, a_diag, fluid))
        return pcg_sharded(cfg, comm, axes, b, a_diag, fluid, x0,
                           precon=precon)
    if comm.backend == "gloo":
        raise RuntimeError("P4 on CUDA tensors needs an NCCL group or an "
                           "in-process LocalGroup, not gloo")
    s = cfg.solver
    dev = b.device
    shape = tuple(b.shape)
    dtype = getattr(torch, s.dtype)
    p_b = _build.require(b, "b", dtype)
    p_a = _build.require(a_diag, "a_diag", torch.int32, shape, dev)
    p_fl = _build.require(fluid, "fluid", torch.bool, shape, dev)
    p_x0 = (None if x0 is None
            else _build.require(x0, "x0", dtype, shape, dev))
    ws = workspace(cfg, comm, shape, dev)
    _build.LAUNCHES["P4"] += 1
    ws.solve(comm, axes, s, p_a, p_fl, p_b, p_x0)
    return (ws.p.clone(), ws.flags[_F_ITERS].clone(),
            ws.scal[_S_RESID].clone())
