"""P6: the IC(0)-PCG solve of the whole grid computed on blocks of it
(`csrc/pcg_ic0_blocks.cu`): what GSPMD makes of the JAX package's
`pcg_loop` with `make_ic0_preconditioner` (euler_tpu/ops/project.py:115,
ops/ic0.py:35; no pallas_call) in its frame on ("y", "x") blocks
(euler_tpu/parallel/spatial.py:113).

`solve_ic0_blocks(cfg, comm, axes, b, a_diag, fluid, x0)` solves A p = b
on this block of the blocks along `axes` of `comm` (`parallel/comm.py`)
with P1 + P2's function (`pcg_general_kernel`, csrc/pcg_general.cu):
P1's loop in apply_a's order with the whole grid's IC(0), E_inv rebuilt
each solve.  The host drives it, as P5 (`pcg_mg_blocks_kernel`): the
loop's stages with the all-reduce after each reduction, and P2's three
sweeps (csrc/ic0.cuh) in stages across the blocks (`parallel/
spatial_ic0.schedule`): before each stage every block exchanges the edges
of the plane being swept, and the blocks of that stage launch their
sweep, one CTA each.  The stop flag is read after the head and after
every iteration.  Its plain version is `parallel/spatial_ic0.
block_ic0` in `halo.pcg_sharded`; the launch count "P6" counts a block's
solves.  A gloo group with CUDA tensors raises.

On an H100 a block's sweep is P2's on a smaller plane (its Y + X - 1
dependent diagonal steps), and the blocks of one stage run one after
another on the one stream of an in-process `LocalGroup`; the host's
work bounds it: 2 (ny + nx - 2) exchanges of the sweeps, each a meeting
of the blocks (or a collective), besides the loop's five, an iteration.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda.pcg_general_kernel import (
    _F_ITERS,
    _S_RESID,
    GeneralWorkspace,
)
from euler_tpu_torch.parallel.spatial_ic0 import schedule, sweep

_F_DONE = 0
# the loop's stages (csrc/pcg_ic0_blocks.cu) and the all-reduce after each
HEAD = ((0, "max"), (1, None))
WARM = ((2, "max"),)
HEAD_TAIL = ((3, None),)
HEAD_DOT = ((4, "sum"), (5, None))
ITER_AD = ((6, "sum"),)
ITER_UPDATE = ((7, "max"), (8, None))
ITER_DOT = ((9, "sum"), (10, None))
# the sweeps (`Sweep`)
BUILD, FORWARD, BACK = range(3)


@functools.cache
def ic0_blocks_lib():
    """csrc/pcg_ic0_blocks.cu: P6 (`eu_pcg_ic0_blocks_*`)."""
    lib = _build.load("pcg_ic0_blocks", flags=["-fmad=false"])
    P, I = _build.PTR, _build.INT
    D = ctypes.c_double
    _build.bind(lib, "eu_pcg_ic0_blocks_create",
                [I] * 3 + [P] * 12 + [ctypes.POINTER(ctypes.c_void_p)])
    _build.bind(lib, "eu_pcg_ic0_blocks_destroy", [P])
    _build.bind(lib, "eu_pcg_ic0_blocks_stage", [P, I, I, D, D] + [P] * 9)
    _build.bind(lib, "eu_pcg_ic0_blocks_sweep", [P, I] + [P] * 7)
    return lib


class Ic0BlocksWorkspace(GeneralWorkspace):
    """One block's buffers: P1's loop planes at the block's shape (E_inv in
    `pre`, the forward solve's q in `q`), the one-value reduction buffer,
    the west / south E_inv edges kept from the build, and zeros for the
    edges beyond the grid; and the CUDA solver over them."""

    def __init__(self, cfg: SimConfig, shape, device):
        dtype = getattr(torch, cfg.solver.dtype)
        Y, X = shape
        self._planes(Y, X, dtype, device)
        self.red = torch.zeros(1, dtype=dtype, device=device)
        # E_inv's west [Y] and south [X] edges, and zeros [Y], [X]
        self.pre_w, self.pre_s, self.zero_y, self.zero_x = (
            torch.zeros(n, dtype=dtype, device=device) for n in (Y, X, Y, X))
        self.keep += [self.red, self.pre_w, self.pre_s, self.zero_y,
                      self.zero_x]
        self.lib = ic0_blocks_lib()
        self._destroy = self.lib.eu_pcg_ic0_blocks_destroy
        self.handle = None
        handle = ctypes.c_void_p()
        with torch.cuda.device(device):
            rc = self.lib.eu_pcg_ic0_blocks_create(
                Y, X, int(dtype == torch.float64), *self._loop_ptrs(),
                self.red.data_ptr(), ctypes.byref(handle))
        _build.check(self.lib, rc, "eu_pcg_ic0_blocks_create")
        self.handle = handle.value

    @property
    def d(self):
        return self.planes[2]

    @property
    def z(self):
        return self.planes[3]

    @property
    def pre(self):
        return self.planes[5]

    @property
    def q(self):
        return self.planes[6]

    def _halo(self, comm, axes, plane):
        """(below, above, left, right) of `plane` from the neighbours
        (left, right None on an axis no block splits); the tensors stay
        referenced until the next exchange."""
        below, above = comm.exchange(plane, 1, "y")
        left = right = None
        if "x" in axes:
            left, right = comm.exchange(plane, 1, "x")
        self._held = (below, above, left, right)
        return [None if t is None else t.data_ptr() for t in self._held]

    def _sweep(self, kind, pre_edges, got_edges):
        """Launch sweep `kind` with E_inv's (west, south) and the swept
        plane's exchanged (column, row) edges, zeros where None."""
        def ptr(t, zero):
            return (zero if t is None else t).data_ptr()

        col, row = got_edges
        e = [None] * 6
        if kind == BACK:
            e[4:] = ptr(col, self.zero_y), ptr(row, self.zero_x)
        else:
            e[:2] = pre_edges
            if kind == FORWARD:
                e[2:4] = ptr(col, self.zero_y), ptr(row, self.zero_x)
        rc = self.lib.eu_pcg_ic0_blocks_sweep(self.handle, kind, *e,
                                              _build.stream())
        _build.check(self.lib, rc, "eu_pcg_ic0_blocks_sweep")

    def build(self, comm, axes, stages, stage):
        """E_inv on the blocks in stages: this block's at `stage`, from its
        west and south neighbours' edges, which it keeps."""
        def run(got):
            col, row = got
            for kept, t in ((self.pre_w, col), (self.pre_s, row)):
                if t is None:
                    kept.zero_()
                else:
                    kept.copy_(t)
            self._sweep(BUILD, self._pre_ptrs(), (None, None))

        sweep(comm, axes, stages, stage, lambda: self.pre, run)

    def _pre_ptrs(self):
        return [self.pre_w.data_ptr(), self.pre_s.data_ptr()]

    def apply(self, comm, axes, stages, fwd, back):
        """z = M^-1 r on the blocks: the forward solve in stages (this
        block's at `fwd`), then the back solve (at `back`)."""
        pre = self._pre_ptrs()
        sweep(comm, axes, stages, fwd, lambda: self.q,
              lambda got: self._sweep(FORWARD, pre, got))
        sweep(comm, axes, stages, back, lambda: self.z,
              lambda got: self._sweep(BACK, pre, got), after=True)

    def _runner(self, comm, axes, s, a_diag, fluid, b, x0):
        """run(stages, halo): the loop's stages for this solve, each
        reduction all-reduced over the blocks after the stage that folds
        it."""
        lib, h = self.lib, self.handle
        cap, tol, tol_rel = s.max_iterations, float(s.tol), float(s.tol_rel)

        def run(stage_list, halo=(None,) * 4):
            for k, op in stage_list:
                rc = lib.eu_pcg_ic0_blocks_stage(h, k, cap, tol, tol_rel,
                                                 a_diag, fluid, b, x0, *halo,
                                                 _build.stream())
                _build.check(lib, rc, "eu_pcg_ic0_blocks_stage")
                if op is not None:
                    comm.all_reduce(self.red, op, axes)

        return run

    def solve(self, comm, axes, s, a_diag, fluid, b, x0):
        """One solve of A p = b on this block (device pointers), the
        collectives through `comm` over `axes`: p stays in `self.p`."""
        run = self._runner(comm, axes, s, a_diag, fluid, b, x0)
        stages, fwd, back = schedule(comm, axes)
        run(HEAD)
        if x0 is not None:
            run(WARM, self._halo(comm, axes, self.p))
        run(HEAD_TAIL)
        # every block holds the same flag: all stop here or none
        if int(self.flags[_F_DONE]):
            return
        self.build(comm, axes, stages, fwd)
        self.apply(comm, axes, stages, fwd, back)
        run(HEAD_DOT)
        for _ in range(s.max_iterations):
            run(ITER_AD, self._halo(comm, axes, self.d))
            run(ITER_UPDATE)
            self.apply(comm, axes, stages, fwd, back)
            run(ITER_DOT)
            if int(self.flags[_F_DONE]):
                break

    def precondition(self, comm, axes, s, a_diag, fluid, r):
        """E_inv built on the blocks and z = M^-1 r applied once, for this
        block's `r` (a device pointer; every block calls it): the head
        writes the operator code and r, the sweeps run as in a solve.
        Returns (E_inv, z), fresh."""
        self._runner(comm, axes, s, a_diag, fluid, r, None)(HEAD)
        self.flags[_F_DONE] = 0
        stages, fwd, back = schedule(comm, axes)
        self.build(comm, axes, stages, fwd)
        self.apply(comm, axes, stages, fwd, back)
        return self.pre.clone(), self.z.clone()

    def close(self):
        handle, self.handle = self.handle, None
        if handle:  # the solver is host memory only: no wait for the card
            _build.check(self.lib, self._destroy(handle),
                         self._destroy.__name__)


def workspace(cfg: SimConfig, comm, shape, device) -> Ic0BlocksWorkspace:
    """This block's P6 workspace for `cfg`'s precision at `shape`, kept by
    its comm (blocks of one process never share one)."""
    key = ("P6", str(device), tuple(shape), cfg.solver.dtype)
    ws = comm.workspaces.get(key)
    if ws is None:
        ws = comm.workspaces[key] = Ic0BlocksWorkspace(cfg, shape, device)
    return ws


def _inputs(cfg: SimConfig, comm, b, a_diag, fluid, x0=None):
    """The checked device pointers of (b, a_diag, fluid, x0) and the
    block's workspace."""
    if comm.backend == "gloo":
        raise RuntimeError("P6 on CUDA tensors needs an NCCL group or an "
                           "in-process LocalGroup, not gloo")
    dev = b.device
    shape = tuple(b.shape)
    dtype = getattr(torch, cfg.solver.dtype)
    ptrs = (_build.require(b, "b", dtype),
            _build.require(a_diag, "a_diag", torch.int32, shape, dev),
            _build.require(fluid, "fluid", torch.bool, shape, dev),
            None if x0 is None
            else _build.require(x0, "x0", dtype, shape, dev))
    return ptrs, workspace(cfg, comm, shape, dev)


def solve_ic0_blocks(cfg: SimConfig, comm, axes, b, a_diag, fluid, x0=None):
    """P6 on this block's CUDA tensors (see the top of this module): (p,
    iterations, residual), the last two the same on every block."""
    (p_b, p_a, p_fl, p_x0), ws = _inputs(cfg, comm, b, a_diag, fluid, x0)
    _build.LAUNCHES["P6"] += 1
    ws.solve(comm, axes, cfg.solver, p_a, p_fl, p_b, p_x0)
    return (ws.p.clone(), ws.flags[_F_ITERS].clone(),
            ws.scal[_S_RESID].clone())


def precondition_ic0_blocks(cfg: SimConfig, comm, axes, a_diag, fluid, r):
    """P6's sweeps alone on this block's CUDA tensors (every block calls
    it): (E_inv, z = M^-1 r) of the whole grid's IC(0), this block's
    cells."""
    (p_r, p_a, p_fl, _), ws = _inputs(cfg, comm, r, a_diag, fluid)
    _build.LAUNCHES["P6"] += 1
    return ws.precondition(comm, axes, cfg.solver, p_a, p_fl, p_r)
