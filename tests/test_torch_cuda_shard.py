"""K1 on row shards (`euler_tpu_torch/parallel/cuda_shard.py`) on the
card, and the port's dry run on one NCCL rank.

A card holds every shard of a plane here: shard r of n is its rows with
8 rows of each neighbour (`cuda_shard.block_with_halo`, which is what
`exchange_rows` delivers to a rank), and K1 runs on it with clamp_ny = Y
and row_offset = r Yl - 8.  Cases: the developed 256² dam break, and
seeded marker states (tests/marker_states.py) on heights whose shards
do not fill whole tiles, full stores that drop, at K = 8 and 16.
  * each shard's launch equals its plain version with the same two
    arguments, bit for bit, the whole padded output;
  * the shards' interiors put together equal the unsharded launch, bit
    for bit;
  * clamp_ny = Y, row_offset = 0 is the unsharded launch.
The multi-rank exchange runs on gloo ranks (tests/test_torch_shard.py);
the card's host has one card, so its NCCL run has one rank.

Marked `cuda`: each test skips on a host without an NVIDIA GPU.  Imports
nothing of JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda_shard.py
"""

import dataclasses

import pytest
import torch

from euler_tpu_torch import sim
from euler_tpu_torch.config import SimConfig, SolverConfig
from euler_tpu_torch.core.presets import dam_break
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda import marker_fused_kernel as k1
from euler_tpu_torch.ops.forces import max_speed_sq
from euler_tpu_torch.parallel.cuda_shard import H, block_with_halo
from euler_tpu_torch.parallel.dryrun import dryrun_multichip

from marker_states import marker_state

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _dam_break(size):
    _card()
    cfg = SimConfig(nx=size, ny=size, marker_layout="slots",
                    solver=SolverConfig(max_iterations=100, tol_rel=1e-4,
                                        preconditioner="mg",
                                        warm_start=True,
                                        fuse_projection=True))
    scn, st = dam_break(cfg, device="cuda")
    for _ in range(3):
        st = sim.step_frame(cfg, scn, st)
    dt = sim._dt_from_msq(cfg, max_speed_sq(cfg, st.u, st.v),
                          torch.full((), cfg.frame_time, device="cuda"))
    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    return (cfg, st.u, st.v, st.fluid, scn.solid,
            st.markers.reshape(2 * K, Y, X), dt, st.marker_count,
            scn.sink | scn.solid)


def _seeded(Y, X, K):
    _card()
    return marker_state(Y, X, K, fill="full", seed=3, device="cuda")


CASES = {
    "dam_break_256": lambda: _dam_break(256),
    "full_200x136_k8": lambda: _seeded(200, 136, 8),
    "full_120x72_k16": lambda: _seeded(120, 72, 16),
}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_k1_shards_bitwise(case, n):
    cfg, u, v, fluid, solid, slots, dt, count, dead = CASES[case]()
    Y = cfg.ny
    Yl = Y // n
    assert Y % n == 0 and Yl >= H
    whole = k1.march_rebin(cfg, u, v, fluid, solid, slots, dt, count,
                           dead=dead)
    cfg_l = dataclasses.replace(cfg, ny=Yl + 2 * H)
    for r in range(n):
        p = [block_with_halo(a, n, r)
             for a in (u, v, fluid, solid, slots, count, dead)]
        args = (cfg_l, *p[:5], dt, p[5])
        kw = dict(dead=p[6], clamp_ny=Y, row_offset=r * Yl - H)
        _build.LAUNCHES.clear()
        got = k1.march_rebin(*args, **kw)
        assert _build.LAUNCHES["K1"] == 1
        want = k1.march_rebin_plain(*args, **kw)
        for a, b, name in zip(got, want, ("slots", "count", "drop")):
            assert torch.equal(a, b), f"shard {r}: {name} differs from plain"
        for a, b, name in zip(got, whole, ("slots", "count", "drop")):
            assert torch.equal(a[..., H:H + Yl, :],
                               b[..., r * Yl:(r + 1) * Yl, :]), (
                f"shard {r}: {name} differs from the unsharded K1")
    assert int(whole[2].sum()) > 0 or case == "dam_break_256"


def test_k1_identity_arguments():
    cfg, *args, dead = _dam_break(256)
    a = k1.march_rebin(cfg, *args, dead=dead)
    b = k1.march_rebin(cfg, *args, dead=dead, clamp_ny=cfg.ny, row_offset=0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_dryrun_on_one_nccl_rank():
    _card()
    results = dryrun_multichip(1, "nccl")
    assert int(results[0]["frames"]) == 2 and int(results[0]["iters"]) > 0
