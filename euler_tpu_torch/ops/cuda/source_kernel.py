"""S1: source emission, one launch a substep (`csrc/sources.cu`).

`emit_sources` computes the JAX package's `update_fluid_sources_slots`
(euler_tpu/ops/markers_slots.py:415-498, main.c:276-298): the colour pass
on the source cells and the emission of one marker per source, in source
order.  It replaces no `pallas_call`: the JAX package runs the emission
as a `lax.scan` over the S sources, which XLA compiles into one loop.  As
torch ops it would be ~25 small launches a source (60 sources in
scenarios/waterfall.txt); S1 is one.

It updates the state's tensors in place: the [2, K, Y, X] store, the
alive plane, the counts, r, g, b, the RNG (uint32 [2]), alive_count and
source_exhausted.  `active` and `frame_count` are read on the card, so
no call waits for the host.  The kernel is bitwise its plain version,
`markers_slots.source_pass_slots`.

In the global layout (`marker_layout="global"`) the same launch runs
S1's global form (`eu_source_pass_global`), the JAX package's
`update_fluid_sources` (euler_tpu/ops/markers.py:308-403): the cell
limit is markers_per_cell alone, and the emitted markers go, in walk
order, to the first free slots of the [2, M] store in index order, as
the JAX package places them; plain version `markers.source_pass_global`.

On an H100 a call is bound by its launch: it reads the S source entries
and counts and writes a few bytes a source; one thread walks the sources
(the walk is sequential in the reference, and each emission's RNG draw
depends on the ones before).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.core.state import FluidState, Scenario
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.markers import source_pass_global
from euler_tpu_torch.ops.markers_slots import source_pass_slots


@functools.cache
def source_lib():
    """csrc/sources.cu: S1 (`eu_source_pass`, and its global form
    `eu_source_pass_global`), built and bound once."""
    lib = _build.load("sources", flags=["-fmad=false"])
    P, I, Fl = _build.PTR, _build.INT, _build.FLOAT
    _build.bind(lib, "eu_source_pass", [I] * 8 + [Fl, Fl] + [P] * 15)
    _build.bind(lib, "eu_source_pass_global", [I] * 7 + [Fl, Fl] + [P] * 16)
    return lib


def emit_sources(cfg: SimConfig, scn: Scenario, state: FluidState,
                 active=None, row_offset: int = 0, counts=None,
                 col_offset: int = 0) -> None:
    """Source emission, in place on the state's tensors.  CUDA tensors
    run the kernel; CPU tensors the plain version.  `active` (a bool
    scalar tensor, or None for True) suppresses every emission when
    False; the colour pass runs regardless, as in the JAX package.

    On a block (`parallel/spatial.py`) the state and scenario planes are
    the block's cells from grid row `row_offset` and column `col_offset`,
    and `counts` ([S] int32) every source cell's count, all-reduced over
    the blocks; cfg is the whole grid's.  In the global layout the block
    holds the whole store, to which it appends what every block
    appends."""
    if scn.num_sources == 0:
        return
    slots = cfg.marker_layout == "slots"
    if state.markers.device.type == "cpu":
        _build.PLAIN_CALLS["S1"] += 1
        plain = source_pass_slots if slots else source_pass_global
        plain(cfg, scn, state, active, row_offset, counts, col_offset)
        return
    Y, X = ((cfg.ny, cfg.nx) if counts is None
            else tuple(state.marker_count.shape))
    K = cfg.slots_per_cell
    S = scn.num_sources
    dev = state.markers.device
    plane = (Y, X)
    f = torch.float32
    store = (K, Y, X) if slots else (cfg.max_markers,)
    if active is None:
        active = torch.ones((), dtype=torch.bool, device=dev)
    ptrs = [
        _build.require(scn.source_yx, "source_yx", torch.int32, (S, 2), dev),
        _build.require(scn.source_valid, "source_valid", torch.bool, (S,),
                       dev),
        _build.require(active, "active", torch.bool, (), dev),
        _build.require(state.frame_count, "frame_count", torch.int32, (),
                       dev),
    ]
    ptrs.append(None if counts is None else _build.require(
        counts, "counts", torch.int32, (S,), dev))
    ptrs += [
        _build.require(state.markers, "markers", f, (2,) + store, dev),
        _build.require(state.alive, "alive", torch.bool, store, dev),
        _build.require(state.marker_count, "marker_count", torch.int32,
                       plane, dev),
        _build.require(state.r, "r", f, plane, dev),
        _build.require(state.g, "g", f, plane, dev),
        _build.require(state.b, "b", f, plane, dev),
        _build.require(state.rng, "rng", torch.uint32, (2,), dev),
        _build.require(state.alive_count, "alive_count", torch.int32, (),
                       dev),
        _build.require(state.source_exhausted, "source_exhausted",
                       torch.bool, (), dev),
    ]
    q = float(np.float32(0.6) / np.float32(cfg.source_color_period))
    h = float(np.float32(cfg.side_length))
    lib = source_lib()
    _build.LAUNCHES["S1"] += 1
    if slots:
        rc = lib.eu_source_pass(S, Y, X, K, cfg.markers_per_cell,
                                cfg.max_markers, row_offset, col_offset, q,
                                h, *ptrs,
                                _build.stream())
    else:
        free = torch.empty(S, dtype=torch.int32, device=dev)
        rc = lib.eu_source_pass_global(S, cfg.max_markers, Y, X,
                                       cfg.markers_per_cell, row_offset,
                                       col_offset, q, h, *ptrs,
                                       free.data_ptr(), _build.stream())
    _build.check(lib, rc, "eu_source_pass")
