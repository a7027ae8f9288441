"""Several independent scenario instances on one card
(`euler_tpu/parallel/batch.py`).

A batch is a `Scenario` and a `FluidState` whose tensors carry a leading
instance axis.  The JAX package maps its frame over that axis with
`jax.vmap`; its batching rule for the fused marker kernel is already a
loop of one launch per instance (marker_fused_kernel.py:849-873: each
launch fills the chip).  The port computes the same function the same
way: each instance goes through `sim.step_frame` in turn, its kernels
launched once per instance on the current stream, and no kernel has a
batch axis.

Every instance shares the solver workspaces of its configuration (they
are keyed by configuration and device, not by instance); a solve
carries nothing from one call to the next, so an instance stepped in an
interleaved batch equals the same instance stepped alone, bit for bit
(tests/test_torch_cuda_batch.py holds this on the card).

`HostBatchRunner` keeps the instances as separate states and steps them
round-robin, as the JAX package's does (bench.py --batch B).  The port
has no jit, so there are no `_jit` twins.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.core.scenario import build_scenario, parse_scenario_text
from euler_tpu_torch.core.state import FluidState, Scenario
from euler_tpu_torch.sim import step_frame


def stack(items):
    """The dataclasses `items` (all `Scenario` or all `FluidState`) as one
    of the same type whose tensors carry a leading instance axis."""
    return type(items[0])(**{
        f.name: torch.stack([getattr(x, f.name) for x in items])
        for f in dataclasses.fields(items[0])})


def instance(batch, i: int):
    """Instance `i` of a stacked `Scenario` or `FluidState`: views of the
    batch's tensors.  Slice before asking a route question: a stacked
    scenario's `num_sources` is the batch size."""
    return type(batch)(**{f.name: getattr(batch, f.name)[i]
                          for f in dataclasses.fields(batch)})


def build_batch(texts: Sequence[bytes | str], cfg: SimConfig,
                device="cuda"):
    """A stacked (Scenario, FluidState) from scenario texts.

    Source lists are padded to the largest source count of the batch so
    the instances stack; `source_valid` masks the padding.  An instance
    with padded sources takes the routes of a scenario with sources (S1
    and no fused substep), as the JAX package's vmap does, which reads
    the padded shape."""
    max_sources = max(int(parse_scenario_text(t, cfg)[2].sum())
                      for t in texts)
    pairs = [build_scenario(t, cfg, pad_sources=max_sources, device=device)
             for t in texts]
    return stack([p[0] for p in pairs]), stack([p[1] for p in pairs])


def step_frame_batched(cfg: SimConfig, scn: Scenario,
                       state: FluidState) -> FluidState:
    """One frame over a leading batch axis: each instance stepped by
    `sim.step_frame`, the results stacked.  The input batch is not
    written."""
    n = state.u.shape[0]
    return stack([step_frame(cfg, instance(scn, i), instance(state, i))
                  for i in range(n)])


def run_frames_batched(cfg: SimConfig, scn: Scenario, state: FluidState,
                       n: int) -> FluidState:
    """`n` frames of `step_frame_batched`."""
    for _ in range(n):
        state = step_frame_batched(cfg, scn, state)
    return state


class HostBatchRunner:
    """Independent instances stepped round-robin, one frame each in turn:
    the card runs B per-instance frames back to back while the host
    queues the next (a frame reads the device only at its solvers' stop
    flags).  The JAX package's supported single-chip batch path
    (bench.py --batch B).

    The JAX runner's `spatial` argument has no counterpart: it turns the
    JAX package's flat slot store into [2, K, Y, X] planes, the form in
    which the port keeps every slot state it makes (`core/state.py`,
    `convert`, `io/checkpoint`), so there is nothing to convert."""

    def __init__(self, cfg: SimConfig, pairs):
        """pairs: list of (Scenario, FluidState)."""
        self.cfg = cfg
        self.scns = [p[0] for p in pairs]
        self.states = [p[1] for p in pairs]

    def run(self, n_frames: int):
        """Advance every instance n_frames; returns the states.  Each
        instance's state is replaced as soon as its next is queued, so the
        runner holds B states and one frame's in flight, not 2B."""
        for _ in range(n_frames):
            for i, scn in enumerate(self.scns):
                self.states[i] = step_frame(self.cfg, scn, self.states[i])
        return list(self.states)

    def sync(self):
        """Wait until every instance's queued work is done (a host read of
        each instance); returns each instance's `float(u.sum())`."""
        return [float(st.u.sum()) for st in self.states]
