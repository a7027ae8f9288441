"""The data axis: a batch of scenario instances split over ranks
(`euler_tpu/parallel/mesh.py`).

The JAX package lays its devices out as a ("data", "y", "x") mesh and
lets GSPMD split a batch over "data" (and the grid over "y" and "x").
The port runs one process per rank on `torch.distributed`: NCCL with a
card a rank, or gloo on the CPU, as the caller initialises the default
process group (`dryrun.launch` does so; nothing here picks a backend).
`make_mesh` lays the ranks out with the JAX package's rule as a
`DeviceMesh` of the same three named dimensions.

Each rank holds its own slice of the batch (`shard_batch`) and steps it
with `parallel/batch.step_frame_batched`: the instances are independent,
so the step needs no communication.  `gather_batch` all-gathers the
slices over "data" for checks.  On a mesh whose "y" or "x" dimension is
larger than 1 each rank also holds only its block of rows and columns of
every instance's planes, and `make_sharded_step` steps each instance of
its slice with the frame on blocks (`parallel/spatial.Blocks`).  The
global layout's [2, M] store, [M] alive mask and RNG are split over
"data" alone and held whole on every block, as the JAX package's
`state_sharding` replicates them over "y" and "x" (mesh.py:70-74).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.core.state import FluidState, Scenario
from euler_tpu_torch.parallel.batch import step_frame_batched

AXES = ("data", "y", "x")
# the backend each device kind runs on; the caller initialises it
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def world(world_size: int | None, device: str) -> int:
    """The default group's size, checked against `world_size` and against
    the backend that `device` runs on (NCCL for "cuda", gloo for "cpu").
    Raises when no group is initialised, when the backend is the other
    one, or when "cuda" is asked for on a host without a card."""
    if device not in BACKENDS:
        raise ValueError(f"device {device!r}: the mesh runs on 'cuda' "
                         "(NCCL) or 'cpu' (gloo)")
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "init_process_group (NCCL on cards, gloo on the "
                           "CPU) first, or use parallel.dryrun.launch")
    backend = dist.get_backend()
    if backend != BACKENDS[device]:
        raise ValueError(f"a {device!r} mesh runs on {BACKENDS[device]}; "
                         f"the default group runs {backend}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a 'cuda' mesh needs an NVIDIA GPU")
    n = dist.get_world_size()
    if world_size is not None and world_size != n:
        raise ValueError(f"world_size {world_size}: the mesh spans the "
                         f"default group's {n} ranks")
    return n


def square_factor(n: int) -> int:
    """The largest divisor of n not above its square root (the JAX
    package's square-ish split, mesh.py:45-52)."""
    return next(c for c in range(math.isqrt(n), 0, -1) if n % c == 0)


def make_mesh(world_size: int | None = None, data: int | None = None,
              x: int = 1, device: str = "cuda") -> DeviceMesh:
    """A ("data", "y", "x") mesh over the default group's ranks, laid out
    as `euler_tpu/parallel/mesh.py:33` lays its devices: `x` columns, and
    the rest split data-major, square-ish unless `data` is given."""
    n = world(world_size, device)
    if x < 1 or n % x:
        raise ValueError(f"{n} ranks don't split into x={x} columns")
    spatial = n // x
    if data is None:
        data = square_factor(spatial)
    if data < 1 or spatial % data:
        raise ValueError(f"{spatial} ranks don't split into data={data}")
    return init_device_mesh(device, (data, spatial // data, x),
                            mesh_dim_names=AXES)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The ranks along the mesh dimension named `axis`."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# the fields whose last two dimensions are the grid's rows and columns:
# the grid's planes, and the slot layout's spatial store
GRID_PLANES = ("u", "v", "r", "g", "b", "marker_count", "prev_marker_count",
               "p")
STATE_PLANES = GRID_PLANES + ("markers", "alive")
SCENARIO_PLANES = ("solid", "source", "sink")


def state_planes(state: FluidState) -> tuple[str, ...]:
    """The fields of `state` (one instance or a batch) that a block holds
    its rows and columns of: STATE_PLANES with the slot layout's spatial
    store ([.., 2, K, Y, X]), GRID_PLANES with a flat one (the global
    layout's [.., 2, M], which every block holds whole)."""
    spatial = state.markers.ndim == state.u.ndim + 2
    return STATE_PLANES if spatial else GRID_PLANES


def _slice(batch, lo: int, hi: int, device):
    return type(batch)(**{f.name: getattr(batch, f.name)[lo:hi].to(device)
                          .contiguous() for f in dataclasses.fields(batch)})


def block_span(size: int, n: int, r: int, axis: str) -> tuple[int, int]:
    """(first, count) of block r of `size` rows ("y") or columns ("x")
    split evenly into n blocks."""
    if size % n:
        what = "rows" if axis == "y" else "columns"
        raise ValueError(f"{size} {what} do not split over {axis}={n}")
    return r * (size // n), size // n


def cut_block(x, fields, rows, cols, device):
    """`x` with rows [r0, r0 + nr) and columns [c0, c0 + nc) of each of
    its `fields` ([.., Y, X] planes), those on `device`, for rows = (r0,
    nr) and cols = (c0, nc): the one cut of `shard_batch` and
    `spatial.shard_spatial`."""
    (r0, nr), (c0, nc) = rows, cols
    return dataclasses.replace(x, **{
        name: getattr(x, name)[..., r0:r0 + nr, c0:c0 + nc].to(device)
        .contiguous() for name in fields})


def gather_block(state: FluidState, gather, axes=("x", "y")) -> FluidState:
    """`state` with the blocks of each plane put together by
    `gather(t, dim, axis)` (a `Comm`'s, or an all-gather over a mesh
    dimension), over each of `axes` in turn: "x" joins columns (dim -1),
    "y" rows (dim -2).  A flat store (the global layout's) is this
    block's, after a check that every block holds the same.  The one
    gather of `gather_batch` and `spatial.gather_blocks`."""
    dims = {"y": -2, "x": -1}
    planes = state_planes(state)

    def whole(t):
        for axis in axes:
            t = gather(t, dims[axis], axis)
        return t

    if planes == GRID_PLANES:
        for name in ("markers", "alive"):
            every = getattr(state, name)[None]
            for axis in axes:
                every = gather(every, 0, axis)
            if not all(torch.equal(every[0], e) for e in every[1:]):
                raise ValueError(f"the blocks' global {name} differ")
    return state.replace(**{name: whole(getattr(state, name))
                            for name in planes})


def split_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """The dimensions of `mesh` that split the grid: "y" where it or "x"
    has more than one rank, and "x" where it does (columns first, the
    order `gather_block` joins them in)."""
    ny, nx = axis_size(mesh, "y"), axis_size(mesh, "x")
    return (("x",) if nx > 1 else ()) + (("y",) if ny > 1 or nx > 1 else ())


def shard_batch(mesh: DeviceMesh, scn: Scenario, state: FluidState):
    """This rank's slice of a stacked batch (`parallel/batch.py`):
    instances [d B/D, (d+1) B/D) for its coordinate d of the D along
    "data", on its device, and on a mesh with y > 1 or x > 1 its block of
    rows and columns of each plane (the slot store as [B, 2, K, Yl, Xl];
    the global layout's [B, 2, M] store whole).  B must divide by D, as
    in the JAX package."""
    n, d = axis_size(mesh, "data"), mesh.get_local_rank("data")
    B = state.u.shape[0]
    if B % n:
        raise ValueError(f"a batch of {B} does not split over data={n}")
    b = B // n
    dev = mesh_device(mesh)
    blocks = bool(split_axes(mesh))
    scn = _slice(scn, d * b, (d + 1) * b, dev)
    state = _slice(state, d * b, (d + 1) * b, dev)
    if blocks:
        Y, X = state.u.shape[-2:]
        rows = block_span(Y, axis_size(mesh, "y"), mesh.get_local_rank("y"),
                          "y")
        cols = block_span(X, axis_size(mesh, "x"), mesh.get_local_rank("x"),
                          "x")
        scn = cut_block(scn, SCENARIO_PLANES, rows, cols, dev)
        state = cut_block(state, state_planes(state), rows, cols, dev)
    return scn, state


def make_sharded_step(cfg: SimConfig, mesh: DeviceMesh):
    """One frame of this rank's slice of the batch: `step_frame_batched`
    on it, or on a mesh with y > 1 or x > 1 each instance's frame on this
    rank's block (`spatial.Blocks` over "y" and "x", either marker layout,
    rainbow or not: its solve the JAX frame's, MG through P5, IC(0)
    through P6, Jacobi and none through P4; it refuses what it does not
    run)."""
    if not split_axes(mesh):
        def step(scn: Scenario, state: FluidState) -> FluidState:
            return step_frame_batched(cfg, scn, state)

        return step

    from euler_tpu_torch import sim
    from euler_tpu_torch.parallel.batch import instance, stack
    from euler_tpu_torch.parallel.spatial import Blocks

    blocks = Blocks(cfg, mesh)

    def step_blocks(scn: Scenario, state: FluidState) -> FluidState:
        return stack([sim.step_frame(cfg, instance(scn, i),
                                     instance(state, i), blocks=blocks)
                      for i in range(state.u.shape[0])])

    return step_blocks


# the dtypes the collectives carry a tensor of these as: NCCL has no
# unsigned 32-bit type, and a bool travels as its bytes
WIRE = {torch.bool: torch.uint8, torch.uint32: torch.int32}


def all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """`t` of every rank of `group`, in group rank order, concatenated
    along `dim` (equal shapes on every rank)."""
    wire = WIRE.get(t.dtype)
    src = (t.view(wire) if wire else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim)
    return out.view(t.dtype) if wire else out


def gather_batch(mesh: DeviceMesh, state: FluidState) -> FluidState:
    """The whole batch on every rank: each rank's slice all-gathered over
    "data", in instance order (and its block over "x" and "y", in column
    and row order)."""
    axes = split_axes(mesh)
    if axes:
        state = gather_block(state, lambda t, dim, axis: all_gather_cat(
            t, mesh.get_group(axis), dim), axes)
    return FluidState(**{f.name: all_gather_cat(getattr(state, f.name),
                                                mesh.get_group("data"), 0)
                         for f in dataclasses.fields(state)})
