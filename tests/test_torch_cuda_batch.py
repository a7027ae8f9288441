"""The single-card batch on the card: an instance stepped in an
interleaved batch equals the same instance stepped alone, bit for bit.

The solver workspaces (MG: `mg_kernel.workspace`; Jacobi:
`pcg_kernel.workspace`; P1 and P3: `pcg_general_kernel.workspace`) and
the global-marker workspace are keyed by configuration and device, so
every instance of a batch shares one of each, its CUDA graph included,
and the instances take turns on one stream.  Anything a workspace
carried from one solve to the next (a warm start, the cap, tol or stop
flag on the device, a hierarchy, a scratch plane) would leak from
instance to instance and show here.  The instances of each case differ
in their solves' iteration counts.  Cases: the main path's config (K1,
K2, K3) and the Jacobi speed mode (K1, K10) over dam breaks and block
obstacles through `HostBatchRunner`; the five text scenarios through
`step_frame_batched` in the CLI's config (K1, S1, K7, K8) and in the
global layout (G1, G2, S1, K7, K8), and in the golden configuration
(f64 Jacobi: P1); the converged dam break at 150², whose MG levels need
padding (K1, K7, P3).

Marked `cuda`: each test skips on a host without an NVIDIA GPU (the
kernels have no CPU mode).  Imports nothing of JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda_batch.py
"""

import dataclasses
from pathlib import Path

import pytest
import torch

from euler_tpu_torch import cli, sim
from euler_tpu_torch.config import SimConfig, SolverConfig
from euler_tpu_torch.core.presets import block_obstacles, dam_break
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.parallel.batch import (
    HostBatchRunner,
    build_batch,
    instance,
    step_frame_batched,
)

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parents[1]
FRAMES = 3
TEXTS = [(REPO / "scenarios" / f"{n}.txt").read_bytes()
         for n in ("basic", "block", "filter", "waterfall", "weird-edges")]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _main(size, **solver):
    cfg = SimConfig(nx=size, ny=size, marker_layout="slots",
                    solver=SolverConfig(max_iterations=100, tol_rel=1e-4,
                                        preconditioner="mg", warm_start=True,
                                        fuse_projection=True))
    return dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, **solver))


def _equal(a, b, what):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x.dtype == torch.uint32:
            x, y = x.to(torch.int64), y.to(torch.int64)
        assert torch.equal(x, y), f"{what}: {f.name} differs"


def _alone(cfg, scn, st, frames):
    """`st` stepped `frames` frames by itself; returns the state and the
    PCG iterations each frame's solves took."""
    iters = []
    for _ in range(frames):
        st, stats = sim.step_frame_stats(cfg, scn, st)
        iters.append(int(stats["pcg_iters"]))
    return st, iters


PRESET_CASES = {
    # case: (config, kernels each substep launches)
    "mg_main_path": (_main(256), {"K1", "K2", "K3"}),
    "jacobi_speed_mode": (_main(128, preconditioner="jacobi", tol_rel=1e-6,
                                warm_start=False), {"K1", "K10"}),
    "mg_padded_p3": (cli.build_config(cli.parse_args(
        ["preset:dam_break", "--size", "150x150", "--converged"])),
                     {"K1", "K7", "P3"}),
}


@pytest.mark.parametrize("case", list(PRESET_CASES))
def test_host_batch_equals_instances_alone(case):
    _card()
    cfg, kernels = PRESET_CASES[case]
    pairs = [dam_break(cfg, seed=0, device="cuda"),
             block_obstacles(cfg, seed=1, device="cuda"),
             dam_break(cfg, seed=2, device="cuda")]
    runner = HostBatchRunner(cfg, pairs)
    _build.LAUNCHES.clear()
    _build.PLAIN_CALLS.clear()
    states = runner.run(FRAMES)
    runner.sync()
    launches = dict(_build.LAUNCHES)
    assert not _build.PLAIN_CALLS
    for k in kernels:
        assert launches.get(k, 0) == len(pairs) * cfg.max_substeps * FRAMES, k
    iters = []
    for i, ((scn, st), st_b) in enumerate(zip(pairs, states)):
        st, it = _alone(cfg, scn, st, FRAMES)
        _equal(st_b, st, f"{case} instance {i}")
        iters.append(it)
    assert len({tuple(it) for it in iters}) > 1, iters


TEXT_CASES = {
    "cli_slots": (cli.build_config(cli.parse_args(
        ["scenarios/waterfall.txt"])), {"K1", "S1", "K7", "K8"}),
    "global": (SimConfig(solver=SolverConfig(max_iterations=100)),
               {"G1", "G2", "S1", "K7", "K8"}),
    "global_f64_p1": (SimConfig(solver=SolverConfig(
        dtype="float64", max_iterations=400)), {"G1", "G2", "S1", "K7",
                                                "P1"}),
}


@pytest.mark.parametrize("case", list(TEXT_CASES))
def test_text_batch_equals_instances_alone(case):
    """The five scenarios, sources padded to waterfall's 60, through
    `step_frame_batched`; each instance against itself stepped alone, and
    the input batch unchanged."""
    _card()
    cfg, kernels = TEXT_CASES[case]
    scn, st0 = build_batch(TEXTS, cfg, device="cuda")
    before = [getattr(st0, f.name).clone()
              for f in dataclasses.fields(st0)]
    _build.LAUNCHES.clear()
    _build.PLAIN_CALLS.clear()
    st = st0
    for _ in range(FRAMES):
        st = step_frame_batched(cfg, scn, st)
    launches = dict(_build.LAUNCHES)
    assert not _build.PLAIN_CALLS
    n = len(TEXTS)
    for k in kernels:
        assert launches.get(k, 0) >= n * cfg.max_substeps * FRAMES, k
    for f, t in zip(dataclasses.fields(st0), before):
        assert torch.equal(getattr(st0, f.name), t), f.name
    iters = []
    for i in range(n):
        one, it = _alone(cfg, instance(scn, i), instance(st0, i), FRAMES)
        _equal(instance(st, i), one, f"{case} {i}")
        iters.append(it)
    assert len({tuple(it) for it in iters}) > 1, iters
