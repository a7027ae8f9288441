"""The collectives of a grid split into blocks: one interface, two groups.

The row-block frame (`parallel/spatial.py`), the sharded marker pass
(`parallel/cuda_shard.py`) and the sharded solve (`parallel/halo.py`,
P4) talk to their neighbours through a `Comm` only:
  * `size(axis)` and `rank(axis)`: the blocks along "y" or "x", and this
    block's place among them;
  * `exchange(x, h, axis)`: (before, after), the `h` rows ("y", dim -2)
    or columns ("x", dim -1) that precede this block and those that
    follow it, from its neighbours; zeros beyond the grid's edges;
  * `all_reduce(t, op, axes)`: `t` summed ("sum") or maxed ("max", NaN
    wins) over the blocks of `axes`, in place, the same on every block;
  * `gather(t, dim, axis)`: every block's `t` along `axis`, in order,
    concatenated along `dim` (for checks and `spatial.gather_spatial`).

`MeshComm` is a rank of a `DeviceMesh` on `torch.distributed`: NCCL on
cards, gloo on the CPU, as the caller initialised the default group.

`LocalGroup` plays the n blocks of a grid in one process, one thread a
block, for a host with fewer cards than blocks (the card's host has one
H100, and NCCL refuses two ranks on one card): its `LocalComm`s run the
same frame and solver code as the ranks.  A collective is a meeting at
which every block enters by posting a copy of its tensor (or of its
edges), and leaves by reading the others' (a fold in rank order for an
all-reduce, the neighbours' edges for an exchange); one block runs at a
time, between meetings, in rank order.  Every block's work goes
to the same stream (the device's default), so the order in which the
threads enqueue is the order in which the card runs it.  It is the
port's counterpart of the 8 virtual CPU devices of tests/conftest.py;
`chip_smoke.py` and the tests use it.
"""

from __future__ import annotations

import threading

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from euler_tpu_torch.parallel.mesh import (
    WIRE,
    all_gather_cat,
    axis_size,
    mesh_device,
)

# how long a block waits for its turn
BARRIER_TIMEOUT_S = 600.0


def _neighbour(mesh: DeviceMesh, axis: str, step: int) -> int:
    """The global rank `step` places along `axis` from this rank."""
    coord = list(mesh.get_coordinate())
    coord[mesh.mesh_dim_names.index(axis)] += step
    return int(mesh.mesh[tuple(coord)])


def exchange_rows(x: torch.Tensor, mesh: DeviceMesh, h: int,
                  axis: str = "y"):
    """(below, above): the `h` rows (along dim -2) that precede this
    rank's block and the `h` that follow it, from the ranks before and
    after it along `axis`; zeros at the global edges."""
    n, r = axis_size(mesh, axis), mesh.get_local_rank(axis)
    if x.shape[-2] < h:
        raise ValueError(f"a block of {x.shape[-2]} rows has no {h} rows "
                         "to send")
    wire = WIRE.get(x.dtype)
    w = x.view(wire) if wire else x
    edge = w.shape[:-2] + (h, w.shape[-1])
    below = torch.zeros(edge, dtype=w.dtype, device=w.device)
    above = torch.zeros(edge, dtype=w.dtype, device=w.device)
    group = mesh.get_group(axis)
    ops = []
    if r > 0:
        prev = _neighbour(mesh, axis, -1)
        ops += [dist.P2POp(dist.irecv, below, prev, group),
                dist.P2POp(dist.isend, w[..., :h, :].contiguous(), prev,
                           group)]
    if r < n - 1:
        nxt = _neighbour(mesh, axis, 1)
        ops += [dist.P2POp(dist.isend, w[..., -h:, :].contiguous(), nxt,
                           group),
                dist.P2POp(dist.irecv, above, nxt, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if wire:
        return below.view(x.dtype), above.view(x.dtype)
    return below, above


def _edges(x: torch.Tensor, h: int, axis: str):
    """(first, last): the `h` rows or columns of `x` this block sends."""
    if axis == "y":
        return x[..., :h, :], x[..., -h:, :]
    return x[..., :h], x[..., -h:]


class MeshComm:
    """This rank of a `DeviceMesh` (see the top of this module)."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh
        self.device = mesh_device(mesh)
        self.backend = dist.get_backend()
        # the solver's workspaces of this rank (parallel/halo.py)
        self.workspaces: dict = {}

    def size(self, axis: str) -> int:
        if axis not in self.mesh.mesh_dim_names:
            return 1
        return axis_size(self.mesh, axis)

    def rank(self, axis: str) -> int:
        if axis not in self.mesh.mesh_dim_names:
            return 0
        return self.mesh.get_local_rank(axis)

    def exchange(self, x: torch.Tensor, h: int, axis: str = "y"):
        if axis == "y":
            return exchange_rows(x, self.mesh, h, "y")
        before, after = exchange_rows(x.transpose(-1, -2), self.mesh, h, "x")
        return (before.transpose(-1, -2).contiguous(),
                after.transpose(-1, -2).contiguous())

    def all_reduce(self, t: torch.Tensor, op: str, axes=("y",)) -> None:
        red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
        for axis in axes:
            if axis in self.mesh.mesh_dim_names:
                dist.all_reduce(t, op=red, group=self.mesh.get_group(axis))

    def gather(self, t: torch.Tensor, dim: int, axis: str = "y"):
        return all_gather_cat(t, self.mesh.get_group(axis), dim)

    def close(self) -> None:
        while self.workspaces:
            self.workspaces.popitem()[1].close()


class LocalGroup:
    """`y` x `x` blocks of one grid in one process (see the top of this
    module): `run(fn, *args)` calls fn(comm, *args) on one thread a
    block, rank r = its row of blocks times `x` plus its column, and
    returns the results in rank order.

    One block runs at a time: a baton passes from rank to rank at every
    meeting (the last to post hands it back to rank 0, which then finds
    every block's value posted).  Threads that each ran between meetings
    would contend for the GIL at every torch call, which costs
    milliseconds a meeting; the baton costs one wake-up a block."""

    def __init__(self, y: int, x: int = 1, device="cuda"):
        if y < 1 or x < 1:
            raise ValueError(f"a group of {y} x {x} blocks")
        self.shape = (y, x)
        self.n = y * x
        self.device = torch.device(device)
        self.comms = [LocalComm(self, r) for r in range(self.n)]

    def _pass(self, rank: int) -> None:
        """Hand the baton to the next block still running, and wait for
        it to come back."""
        nxt = next((k % self.n for k in range(rank + 1, rank + self.n + 1)
                    if not self._finished[k % self.n]), rank)
        if nxt != rank:
            self._go[rank].clear()
            self._go[nxt].set()
            if not self._go[rank].wait(BARRIER_TIMEOUT_S):
                self._failed = True
        if self._failed:
            raise threading.BrokenBarrierError

    def meet(self, rank: int, value, read):
        """Post `value` (which no block may change afterwards), wait until
        every block has posted, return read(every block's value)."""
        board = self._boards[self._turn[rank]]
        self._turn[rank] ^= 1
        board[rank] = value
        if any(self._finished):
            self._failed = True
            raise RuntimeError("a block met after another one had ended")
        self._pass(rank)
        return read(board)

    def run(self, fn, *args):
        results = [None] * self.n
        errors = []
        self._go = [threading.Event() for _ in range(self.n)]
        self._finished = [False] * self.n
        self._failed = False
        # two boards, used in turn: a block that has read may post on the
        # other board while a later one still reads this one
        self._boards = [[None] * self.n, [None] * self.n]
        self._turn = [0] * self.n

        def main(r):
            try:
                if not self._go[r].wait(BARRIER_TIMEOUT_S):
                    raise threading.BrokenBarrierError
                if not self._failed:
                    results[r] = fn(self.comms[r], *args)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append((r, e))
                self._failed = True
            finally:
                self._finished[r] = True
                if self._failed:
                    for ev in self._go:
                        ev.set()
                else:
                    nxt = next((k % self.n for k in range(r + 1, r + self.n)
                                if not self._finished[k % self.n]), None)
                    if nxt is not None:
                        self._go[nxt].set()

        threads = [threading.Thread(target=main, args=(r,), daemon=True)
                   for r in range(self.n)]
        for t in threads:
            t.start()
        self._go[0].set()
        for t in threads:
            t.join()
        if errors:
            first = [e for e in errors
                     if not isinstance(e[1], threading.BrokenBarrierError)]
            r, e = (first or errors)[0]
            raise RuntimeError(f"block {r} of {self.n} failed: "
                               f"{type(e).__name__}: {e}") from e
        return results

    def close(self) -> None:
        for comm in self.comms:
            comm.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class LocalComm:
    """Block `r` of a `LocalGroup`."""

    backend = "local"

    def __init__(self, group: LocalGroup, r: int):
        self.group = group
        self.r = r
        self.device = group.device
        self.workspaces: dict = {}

    def size(self, axis: str) -> int:
        return self.group.shape[0 if axis == "y" else 1]

    def rank(self, axis: str) -> int:
        x = self.group.shape[1]
        return self.r // x if axis == "y" else self.r % x

    def _at(self, y: int, x: int) -> int:
        return y * self.group.shape[1] + x

    def exchange(self, x: torch.Tensor, h: int, axis: str = "y"):
        ry, rx = self.rank("y"), self.rank("x")
        n, me = self.size(axis), self.rank(axis)
        dim = -2 if axis == "y" else -1
        if x.shape[dim] < h:
            raise ValueError(f"a block of {x.shape[dim]} along {axis} has "
                             f"no {h} to send")

        def peer(step):
            k = me + step
            if not 0 <= k < n:
                return None
            return self._at(k, rx) if axis == "y" else self._at(ry, k)

        first, last = (e.clone() for e in _edges(x, h, axis))

        def read(posted):
            before, after = peer(-1), peer(1)
            return (posted[before][1] if before is not None
                    else torch.zeros_like(last),
                    posted[after][0] if after is not None
                    else torch.zeros_like(first))

        b, a = self.group.meet(self.r, (first, last), read)
        return b.contiguous(), a.contiguous()

    def all_reduce(self, t: torch.Tensor, op: str, axes=("y",)) -> None:
        ry, rx = self.rank("y"), self.rank("x")
        ys = range(self.size("y")) if "y" in axes else [ry]
        xs = range(self.size("x")) if "x" in axes else [rx]
        members = [self._at(y, x) for y in ys for x in xs]

        def read(posted):
            acc = posted[members[0]].clone()
            for k in members[1:]:
                acc = acc + posted[k] if op == "sum" else torch.maximum(
                    acc, posted[k])
            return acc

        t.copy_(self.group.meet(self.r, t.clone(), read))

    def gather(self, t: torch.Tensor, dim: int, axis: str = "y"):
        ry, rx = self.rank("y"), self.rank("x")
        members = ([self._at(y, rx) for y in range(self.size("y"))]
                   if axis == "y" else
                   [self._at(ry, x) for x in range(self.size("x"))])
        return self.group.meet(self.r, t.clone(), lambda posted: torch.cat(
            [posted[k] for k in members], dim))

    def close(self) -> None:
        while self.workspaces:
            self.workspaces.popitem()[1].close()


def as_comm(mesh):
    """The `Comm` of `mesh`: a `LocalComm` as it is, a `DeviceMesh`'s
    rank as a `MeshComm`."""
    if isinstance(mesh, (LocalComm, MeshComm)):
        return mesh
    if isinstance(mesh, DeviceMesh):
        return MeshComm(mesh)
    raise TypeError(f"a mesh is a DeviceMesh or a LocalComm, not "
                    f"{type(mesh).__name__}")
