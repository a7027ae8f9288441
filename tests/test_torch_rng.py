"""The port's xorshift64* (`euler_tpu_torch/core/rng.py`) against the
JAX package's (`euler_tpu/core/rng.py`): the host generator, and 64
device draws of `next32` / `randf32` as torch ops on int64 lanes,
bitwise against the JAX functions and the host generator."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.core import rng as jrng
from euler_tpu_torch.core import rng

DRAWS = 64
SEEDS = [rng.SEED, 1, 0xFFFFFFFFFFFFFFFF, 0x8000000000000001]


def _lanes(seed):
    return torch.tensor([seed >> 32, seed & 0xFFFFFFFF], dtype=torch.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_host_generator_matches_jax(seed):
    a, b = rng.XorShift64Star(seed), jrng.XorShift64Star(seed)
    for _ in range(DRAWS):
        assert a.next32() == b.next32()
        assert np.float32(a.randf()).tobytes() == np.float32(
            b.randf()).tobytes()
    np.testing.assert_array_equal(a.state_u32_pair(), b.state_u32_pair())
    assert rng.state_from_u32_pair(a.state_u32_pair()) == a.state


@pytest.mark.parametrize("seed", SEEDS)
def test_next32_matches_jax_and_host(seed):
    lanes = _lanes(seed)
    jstate = jnp.asarray(np.array([seed >> 32, seed & 0xFFFFFFFF],
                                  np.uint32))
    host = rng.XorShift64Star(seed)
    for _ in range(DRAWS):
        out, lanes = rng.next32(lanes)
        jout, jstate = jrng.next32(jstate)
        assert int(out) == int(jout) == int(host.next32())
        np.testing.assert_array_equal(lanes.numpy(), np.asarray(jstate))


@pytest.mark.parametrize("seed", SEEDS)
def test_randf32_matches_jax(seed):
    lanes = _lanes(seed)
    jstate = jnp.asarray(np.array([seed >> 32, seed & 0xFFFFFFFF],
                                  np.uint32))
    got, want = [], []
    for _ in range(DRAWS):
        x, lanes = rng.randf32(lanes)
        jx, jstate = jrng.randf32(jstate)
        got.append(x)
        want.append(jx)
    got = torch.stack(got).numpy()
    want = np.asarray(want, np.float32)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert ((got >= 0) & (got <= 1)).all()


def test_lanes_round_trip_and_batches():
    """uint32 state <-> int64 lanes, and a batch of states steps lane by
    lane like each state alone."""
    pair = rng.initial_device_state()
    np.testing.assert_array_equal(pair, jrng.initial_device_state())
    t = torch.as_tensor(pair)
    assert torch.equal(t.to(torch.int64).to(torch.uint32), t)
    batch = torch.stack([_lanes(s) for s in SEEDS])
    out, new = rng.next32(batch)
    for i, s in enumerate(SEEDS):
        o, n = rng.next32(_lanes(s))
        assert int(out[i]) == int(o) and torch.equal(new[i], n)
