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
slices over "data" for checks.  On a mesh whose "y" dimension is larger
than 1 each rank also holds only its block of rows of every instance,
and `make_sharded_step` steps each instance of its slice with the frame
on row blocks (`parallel/spatial.RowBlocks`, the slot layout); column
blocks (x > 1) are ROADMAP M12 part d.
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
PART_D = "ROADMAP M12 part d"


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


# the fields whose last two dimensions are the grid's rows and columns
STATE_PLANES = ("u", "v", "r", "g", "b", "markers", "alive", "marker_count",
                "prev_marker_count", "p")
SCENARIO_PLANES = ("solid", "source", "sink")


def _slice(batch, lo: int, hi: int, device):
    return type(batch)(**{f.name: getattr(batch, f.name)[lo:hi].to(device)
                          .contiguous() for f in dataclasses.fields(batch)})


def block_rows(ny: int, n: int, r: int) -> tuple[int, int]:
    """(first row, rows) of block r of a grid of `ny` rows split evenly
    into n blocks."""
    if ny % n:
        raise ValueError(f"{ny} rows do not split over y={n}")
    return r * (ny // n), ny // n


def cut_rows(x, fields, lo: int, hi: int, device):
    """`x` with rows [lo, hi) of each of its `fields` ([.., Y, X] planes),
    those on `device`: the one row cut of `shard_batch` and
    `spatial.shard_spatial`."""
    return dataclasses.replace(x, **{
        name: getattr(x, name)[..., lo:hi, :].to(device).contiguous()
        for name in fields})


def gather_rows(state: FluidState, gather) -> FluidState:
    """`state` with the row blocks of each plane put together in row
    order by `gather(t, dim)` (a `Comm`'s, or an all-gather over "y"):
    the one row gather of `gather_batch` and `spatial.gather_spatial`."""
    return state.replace(**{name: gather(getattr(state, name), -2)
                            for name in STATE_PLANES})


def shard_batch(mesh: DeviceMesh, scn: Scenario, state: FluidState):
    """This rank's slice of a stacked batch (`parallel/batch.py`):
    instances [d B/D, (d+1) B/D) for its coordinate d of the D along
    "data", on its device, and on a mesh with y > 1 its block of rows of
    each (the slot store as [B, 2, K, Yl, X]).  B must divide by D, as
    in the JAX package."""
    n, d = axis_size(mesh, "data"), mesh.get_local_rank("data")
    B = state.u.shape[0]
    if B % n:
        raise ValueError(f"a batch of {B} does not split over data={n}")
    b = B // n
    dev = mesh_device(mesh)
    ny = axis_size(mesh, "y")
    if ny > 1 and state.markers.ndim != 5:
        raise NotImplementedError(
            "a batch on row blocks needs the slot layout's spatial store "
            f"[B, 2, K, Y, X]; the global layout on row blocks is {PART_D}")
    scn = _slice(scn, d * b, (d + 1) * b, dev)
    state = _slice(state, d * b, (d + 1) * b, dev)
    if ny > 1:
        lo, rows = block_rows(state.u.shape[-2], ny,
                              mesh.get_local_rank("y"))
        scn = cut_rows(scn, SCENARIO_PLANES, lo, lo + rows, dev)
        state = cut_rows(state, STATE_PLANES, lo, lo + rows, dev)
    return scn, state


def make_sharded_step(cfg: SimConfig, mesh: DeviceMesh):
    """One frame of this rank's slice of the batch: `step_frame_batched`
    on it, or on a mesh with y > 1 each instance's frame on this rank's
    rows (`spatial.RowBlocks` over "y", which refuses what it does not
    run).  Raises NotImplementedError on a mesh with x > 1 (column
    blocks, ROADMAP M12 part d)."""
    if axis_size(mesh, "x") > 1:
        raise NotImplementedError(
            f"make_sharded_step on a mesh of shape {tuple(mesh.shape)}: "
            f"column blocks (x > 1) are {PART_D}")
    if axis_size(mesh, "y") == 1:
        def step(scn: Scenario, state: FluidState) -> FluidState:
            return step_frame_batched(cfg, scn, state)

        return step

    from euler_tpu_torch import sim
    from euler_tpu_torch.parallel.batch import instance, stack
    from euler_tpu_torch.parallel.spatial import RowBlocks

    blocks = RowBlocks(cfg, mesh)

    def step_rows(scn: Scenario, state: FluidState) -> FluidState:
        return stack([sim.step_frame(cfg, instance(scn, i),
                                     instance(state, i), blocks=blocks)
                      for i in range(state.u.shape[0])])

    return step_rows


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
    "data", in instance order (and its rows over "y", in row order)."""
    if axis_size(mesh, "y") > 1:
        state = gather_rows(state, lambda t, dim: all_gather_cat(
            t, mesh.get_group("y"), dim))
    return FluidState(**{f.name: all_gather_cat(getattr(state, f.name),
                                                mesh.get_group("data"), 0)
                         for f in dataclasses.fields(state)})
