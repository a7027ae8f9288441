"""P5: the MG-PCG solve of the whole grid computed on blocks of it
(`csrc/pcg_mg_blocks.cu`): what GSPMD makes of the JAX package's
`pcg_loop` with `make_mg_preconditioner` (euler_tpu/ops/project.py:115,
ops/multigrid.py:492; no pallas_call) in its frame on ("y", "x") blocks
(euler_tpu/parallel/spatial.py:113).

`solve_mg_blocks(cfg, comm, axes, plan, b, a_diag, fluid, ring, x0)`
solves A p = b on this block of the blocks along `axes` of `comm`
(`parallel/comm.py`), with P3's function (`pcg_general_kernel`, csrc/
pcg_mg.cu): P1's loop with one Galerkin W-cycle over the whole grid's
hierarchy as its preconditioner.  `plan` (`parallel/spatial_mg.
BlockPlan`) says where the block lies and at which level G the cycle
gathers: levels 0 .. G - 1 stay on the blocks, each operation one launch
with the neighbours' edges of the plane it reads exchanged before it;
from G down every block runs P3's cycle on the whole coarse grid.  At
G = 0 (a block with an odd side) every block holds the whole grid's
hierarchy, level 0 padded where the grid is odd: the blocks' packed
level 0 is gathered once a solve and their r on every visit, and each
block copies its own cells of the whole cycle's output into z.  The
host drives it all, as P4 (`pcg_shard_kernel`): the loop's stages, the
all-reduce after each reduction, the hierarchy's build steps, and the
cycle's level operations (`_cycle` mirrors `Solve::cycle` of csrc/
mg_levels.cuh).  The stop flag is read after every iteration.  Its
plain version is `parallel/spatial_mg.pcg_blocks_plain`; the launch count
"P5" counts a block's solves.  A gloo group with CUDA tensors raises.

Precision: every buffer, edge and all-reduced value is in the solver
dtype (`solver.dtype`, f32 or f64), so an f64 solve builds its hierarchy
and Chebyshev rows in double, as P3's f64 solve does, and folds doubles
over the blocks.

On an H100 the device work of an iteration is P3's, cut into blocks; the
host's work bounds it: some forty exchanges and all-reduces an iteration
at 1024², each a meeting of the blocks (an in-process `LocalGroup`) or a
collective.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda.mg_kernel import _PLANES_PER_LEVEL, cycle_args
from euler_tpu_torch.ops.cuda.pcg_general_kernel import (
    _F_ITERS,
    _S_RESID,
    GeneralWorkspace,
)
from euler_tpu_torch.parallel.spatial_mg import gather_plane

_F_DONE = 0
# the loop's stages (csrc/pcg_mg_blocks.cu) and the all-reduce after each
HEAD = ((0, "max"), (1, None))
WARM = ((2, "max"),)
HEAD_TAIL = ((3, None),)
HEAD_DOT = ((4, "sum"), (5, None))
ITER_AD = ((6, "sum"),)
ITER_UPDATE = ((7, "max"), (8, None))
ITER_DOT = ((9, "sum"), (10, None))
# the level operations (`Op`) and the hierarchy's build steps (`Build`)
PRE1, RESTRICT, PROLONG, POST1, CHEBY_INIT, CHEBY_STEP, AXPY, COARSE = \
    range(8)
BUILD0, BUILD_LEVEL, BUILD_GATHERED, BUILD_ROWS = range(4)
# the cycle's planes of a level, in the library's order
PLANE_NAMES = ("c", "e", "n", "x", "b", "z", "rr", "d", "dn")
assert len(PLANE_NAMES) == _PLANES_PER_LEVEL


@functools.cache
def blocks_lib():
    """csrc/pcg_mg_blocks.cu: P5 (`eu_pcg_mg_blocks_*`)."""
    lib = _build.load("pcg_mg_blocks", flags=["-fmad=false"])
    P, I = _build.PTR, _build.INT
    D = ctypes.c_double
    _build.bind(lib, "eu_pcg_mg_blocks_create",
                [I] * 5 + [P] * 4 + [I] * 2 + [P] * 3 + [I] * 5 + [D, D]
                + [P] * 14 + [ctypes.POINTER(ctypes.c_void_p)])
    _build.bind(lib, "eu_pcg_mg_blocks_destroy", [P])
    _build.bind(lib, "eu_pcg_mg_blocks_stage", [P, I, I, D, D] + [P] * 9)
    _build.bind(lib, "eu_pcg_mg_blocks_build", [P, I, I] + [P] * 5)
    _build.bind(lib, "eu_pcg_mg_blocks_level", [P, I, I, I] + [P] * 5)
    _build.bind(lib, "eu_pcg_mg_blocks_plan", [P, P])
    return lib


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


class BlocksWorkspace(GeneralWorkspace):
    """One block's buffers: P1's loop planes at the block's shape and the
    one-value reduction buffer; the block's cells of the distributed
    levels 0 .. G (`self.block[l]`: level 0's cycle planes are the loop's,
    as P3 maps them; levels 1 .. G - 1 their c, e, n, the cycle's planes,
    active and the west e / south n edges; level G c, e, n, b and
    active); the gathered levels G .. L - 1 as whole planes at their
    stored shapes (`self.whole[l]`; at G = 0 level 0's are the packed
    operator and the cycle's planes, zero in the pad); the block's packed
    level 0, the Chebyshev rows and the partials, all in the solver dtype;
    and the CUDA solver over them."""

    def __init__(self, cfg: SimConfig, plan, device):
        s = cfg.solver
        f = getattr(torch, s.dtype)
        self.plan = plan
        self.G, self.L = G, L = plan.gather, len(plan.shapes)
        self.deg, _, self.w_cycle, self.w_depth = cycle_args(cfg)
        Y, X = plan.block_shape(0)
        self._planes(Y, X, f, device)
        self.red = torch.zeros(1, dtype=f, device=device)
        self.keep.append(self.red)

        def new(shape, dtype=f):
            t = torch.zeros(shape, dtype=dtype, device=device)
            self.keep.append(t)
            return t

        self.packed0 = new((Y, X))
        deg = [s.mg_cheby_degree] * (L - 1) + [s.mg_coarse_iters]
        self.rows = new((L, 1 + 2 * max(deg)))
        # level 0 of the cycle: b = r, its output in z, pre, q and ad its
        # scratch (pcg_mg.cu's mapping)
        p_, r_, d_, z_, ad, pre, q = self.planes
        if self.deg == 1:
            lv0 = dict(x=pre, b=r_, z=z_, rr=q, d=ad, dn=None)
        else:
            lv0 = dict(x=z_, b=r_, z=None, rr=pre, d=q, dn=ad)
        self.block = [lv0]
        for l in range(1, G + 1):
            Yl, Xl = plan.block_shape(l)
            names = PLANE_NAMES if l < G else ("c", "e", "n", "b")
            lv = {k: new((Yl, Xl)) for k in names}
            lv["act"] = new((Yl, Xl), torch.uint8)
            if l < G:
                lv["ew"], lv["ns"] = new(Yl), new(Xl)
            self.block.append(lv)
        self.whole = [None] * G
        for l, shape in enumerate(plan.shapes[G:], start=G):
            if l == 0:  # the grid's packed level 0 for c, e, n, active
                lv = {k: new(shape) for k in ("packed", *PLANE_NAMES[3:])}
            else:
                lv = {k: new(shape) for k in PLANE_NAMES}
                lv["act"] = new(shape, torch.uint8)
            self.whole.append(lv)
        self.bpart = new(sum(-(-Yl * Xl // 256) for Yl, Xl in
                             map(plan.block_shape, range(G))))
        self.hpart = new(G + sum(-(-Yl * Xl // 256)
                                 for Yl, Xl in plan.shapes[G:]))
        self._zeros = {}
        shapes, planes, act, edges = [], [], [], []
        for l, lv in enumerate(self.block):
            shapes += plan.block_shape(l)
            planes += [_ptr(lv.get(k)) for k in PLANE_NAMES]
            act.append(_ptr(lv.get("act")))
            edges += [_ptr(lv.get("ew")), _ptr(lv.get("ns"))]
        for shape, lv in zip(plan.shapes, self.whole):
            shapes += shape
            planes += [_ptr(lv and lv.get(k)) for k in PLANE_NAMES]
            act.append(_ptr(lv and lv.get("act")))
        r0, c0 = plan.offset(G)
        ptrs = self._loop_ptrs()
        self.lib = blocks_lib()
        self._destroy = self.lib.eu_pcg_mg_blocks_destroy
        self.handle = None
        handle = ctypes.c_void_p()
        with torch.cuda.device(device):
            rc = self.lib.eu_pcg_mg_blocks_create(
                Y, X, int(f == torch.float64), G, L,
                (ctypes.c_int * len(shapes))(*shapes),
                (ctypes.c_void_p * len(planes))(*planes),
                (ctypes.c_void_p * len(act))(*act),
                (ctypes.c_void_p * len(edges))(*edges), r0, c0,
                self.packed0.data_ptr(), _ptr(self.whole[0] and
                                              self.whole[0]["packed"]),
                self.rows.data_ptr(),
                self.rows.shape[1], *cycle_args(cfg), s.mg_cheby_ratio,
                s.mg_coarse_ratio, self.bpart.data_ptr(),
                self.hpart.data_ptr(), *ptrs, self.red.data_ptr(),
                ctypes.byref(handle))
        _build.check(self.lib, rc, "eu_pcg_mg_blocks_create")
        self.handle = handle.value

    def zeros(self, n: int) -> torch.Tensor:
        """An [n] plane of zeros: the edges beyond an axis that no block
        splits."""
        if n not in self._zeros:
            self._zeros[n] = torch.zeros(n, dtype=self.p.dtype,
                                         device=self.p.device)
        return self._zeros[n]

    def cycle_plan(self) -> dict:
        """The gathered cycle's plan on the card (`self.plan` is the
        block's `BlockPlan`): the level where its coarse end runs as one
        cluster launch ("fused"; the level count "levels": none), that
        launch's shared memory in bytes ("smem"), and the gather level
        ("gather")."""
        out = (ctypes.c_int * 4)()
        _build.check(self.lib, self.lib.eu_pcg_mg_blocks_plan(self.handle,
                                                              out),
                     "eu_pcg_mg_blocks_plan")
        return {"fused": out[0], "smem": out[1], "levels": out[2],
                "gather": out[3]}

    def visits(self, l: int) -> int:
        """How often a cycle of level l visits level l + 1 (`Solve::
        visits`, the grid's level count)."""
        return (self.w_cycle if l < self.w_depth and l + 1 < self.L - 1
                else 1)

    # ---- the host's collectives ----

    def _edges(self, comm, axes, plane):
        """(below, above, left, right) of `plane` from the neighbours,
        zeros beyond the grid's edges and on an axis no block splits; the
        tensors stay referenced until the next exchange."""
        below, above = comm.exchange(plane, 1, "y")
        if "x" in axes:
            left, right = comm.exchange(plane, 1, "x")
        else:
            left = right = self.zeros(plane.shape[0])
        self._held = (below, above, left, right)
        return [t.data_ptr() for t in self._held]

    # ---- the library's steps ----

    def _op(self, op, l, k=0, edges=(None,) * 4):
        rc = self.lib.eu_pcg_mg_blocks_level(self.handle, op, l, k, *edges,
                                             _build.stream())
        _build.check(self.lib, rc, "eu_pcg_mg_blocks_level")

    def _build_step(self, step, l=0, ring=(None,) * 4):
        rc = self.lib.eu_pcg_mg_blocks_build(self.handle, step, l, *ring,
                                             _build.stream())
        _build.check(self.lib, rc, "eu_pcg_mg_blocks_build")

    def hierarchy(self, comm, axes, ring):
        """The Galerkin hierarchy and the Chebyshev rows of the packed
        level 0 (`ring`: the fluid one cell beyond each edge of the
        block), as P3 builds them for the whole grid."""
        G = self.G
        if G == 0:
            whole = gather_plane(self.packed0, comm, axes)
            self.whole[0]["packed"][:whole.shape[0],
                                    :whole.shape[1]].copy_(whole)
            self._build_step(BUILD_GATHERED)
            self._build_step(BUILD_ROWS)
            return
        self._build_step(BUILD0, 0, [t.data_ptr() for t in ring])
        for l in range(1, G):
            lv = self.block[l]
            if "x" in axes:
                lv["ew"].copy_(comm.exchange(lv["e"], 1, "x")[0][:, 0])
            lv["ns"].copy_(comm.exchange(lv["n"], 1, "y")[0][0])
            self._build_step(BUILD_LEVEL, l)
        top = self.block[G]
        whole = gather_plane(torch.stack(
            [top["c"], top["e"], top["n"], top["act"].to(top["c"].dtype)]),
            comm, axes)
        Yg, Xg = whole.shape[-2:]
        for k, name in enumerate("cen"):
            self.whole[G][name][:Yg, :Xg].copy_(whole[k])
        self.whole[G]["act"][:Yg, :Xg].copy_(whole[3])
        self._build_step(BUILD_GATHERED)
        comm.all_reduce(self.hpart[:G], "max", axes)
        self._build_step(BUILD_ROWS)

    def _cheby(self, comm, axes, l, from_zero: bool):
        lv = self.block[l]
        self._op(CHEBY_INIT, l, int(from_zero),
                 () if from_zero else self._edges(comm, axes, lv["x"]))
        for k in range(self.deg - 1):
            self._op(CHEBY_STEP, l, k,
                     self._edges(comm, axes, lv["dn" if k % 2 else "d"]))
        self._op(AXPY, l)

    def _cycle(self, comm, axes, l: int):
        """z_l ~= A_l^-1 b_l on the block (`Solve::cycle(l, false)`), from
        the gathered level on its whole planes."""
        if l == self.G:
            whole = gather_plane(self.block[l]["b"], comm, axes)
            Yg, Xg = whole.shape
            self.whole[l]["b"][:Yg, :Xg].copy_(whole)
            self._op(COARSE, l)
            return
        lv = self.block[l]
        if self.deg == 1:
            self._op(PRE1, l, 0, self._edges(comm, axes, lv["b"]))
        else:
            self._cheby(comm, axes, l, True)
            self._op(RESTRICT, l, 0, self._edges(comm, axes, lv["x"]))
        for v in range(self.visits(l)):
            if v:
                self._op(RESTRICT, l, 0, self._edges(comm, axes, lv["x"]))
            self._cycle(comm, axes, l + 1)
            self._op(PROLONG, l)
        if self.deg == 1:
            self._op(POST1, l, 0, self._edges(comm, axes, lv["x"]))
        else:
            self._cheby(comm, axes, l, False)

    def solve(self, comm, axes, s, a_diag, fluid, b, x0, ring):
        """One solve of A p = b on this block (device pointers), the
        collectives through `comm` over `axes`: p stays in `self.p`."""
        lib, h = self.lib, self.handle
        cap, tol, tol_rel = s.max_iterations, float(s.tol), float(s.tol_rel)

        def run(stages, edges=(None,) * 4):
            for k, op in stages:
                rc = lib.eu_pcg_mg_blocks_stage(h, k, cap, tol, tol_rel,
                                                a_diag, fluid, b, x0, *edges,
                                                _build.stream())
                _build.check(lib, rc, "eu_pcg_mg_blocks_stage")
                if op is not None:
                    comm.all_reduce(self.red, op, axes)

        run(HEAD)
        if x0 is not None:
            run(WARM, self._edges(comm, axes, self.p))
        run(HEAD_TAIL)
        # every block holds the same flag: all stop here or none
        if int(self.flags[_F_DONE]):
            return
        self.hierarchy(comm, axes, ring)
        self._cycle(comm, axes, 0)
        run(HEAD_DOT)
        for _ in range(cap):
            run(ITER_AD, self._edges(comm, axes, self.planes[2]))
            run(ITER_UPDATE)
            self._cycle(comm, axes, 0)
            run(ITER_DOT)
            if int(self.flags[_F_DONE]):
                break

    def cycle(self, comm, axes, r):
        """z = M r for this block's `r` on the hierarchy of the last
        solve (every block calls it).  Overwrites the loop's r and z and
        clears the stop flag.  Returns z, fresh."""
        _build.require(r, "r", self.p.dtype, self.p.shape, self.p.device)
        self.flags[_F_DONE] = 0
        self.planes[1].copy_(r)
        self._cycle(comm, axes, 0)
        return self.planes[3].clone()

    def close(self):
        handle, self.handle = self.handle, None
        if handle:  # the solver is host memory only: no wait for the card
            _build.check(self.lib, self._destroy(handle),
                         self._destroy.__name__)


def workspace(cfg: SimConfig, comm, plan, device) -> BlocksWorkspace:
    """This block's P5 workspace for `cfg`'s MG and `plan`, kept by its
    comm (blocks of one process never share one)."""
    s = cfg.solver
    key = ("P5", str(device), plan, s.dtype, *cycle_args(cfg),
           s.mg_cheby_ratio, s.mg_coarse_ratio)
    ws = comm.workspaces.get(key)
    if ws is None:
        ws = comm.workspaces[key] = BlocksWorkspace(cfg, plan, device)
    return ws


def solve_mg_blocks(cfg: SimConfig, comm, axes, plan, b, a_diag, fluid,
                    ring, x0=None):
    """P5 on this block's CUDA tensors (see the top of this module):
    (p, iterations, residual), the last two the same on every block.
    `ring`: (below, above, left, right), the fluid one cell beyond each
    edge of the block."""
    if comm.backend == "gloo":
        raise RuntimeError("P5 on CUDA tensors needs an NCCL group or an "
                           "in-process LocalGroup, not gloo")
    dev = b.device
    shape = plan.block_shape(0)
    dtype = getattr(torch, cfg.solver.dtype)
    p_b = _build.require(b, "b", dtype, shape)
    p_a = _build.require(a_diag, "a_diag", torch.int32, shape, dev)
    p_fl = _build.require(fluid, "fluid", torch.bool, shape, dev)
    p_x0 = (None if x0 is None
            else _build.require(x0, "x0", dtype, shape, dev))
    for t, n in zip(ring, (shape[1], shape[1], shape[0], shape[0])):
        _build.require(t, "ring", torch.bool, (n,), dev)
    ws = workspace(cfg, comm, plan, dev)
    _build.LAUNCHES["P5"] += 1
    ws.solve(comm, axes, cfg.solver, p_a, p_fl, p_b, p_x0, ring)
    return (ws.p.clone(), ws.flags[_F_ITERS].clone(),
            ws.scal[_S_RESID].clone())
