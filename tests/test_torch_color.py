"""Rainbow colours against the JAX package: `hsv_basis` and `colorize`
bitwise (the rainbow 64² dam break's whole initial state), `advect_p`
atol 1e-6 on the developed 64² state with random colours (the
interpolation's products may round differently between XLA's CPU code
and PyTorch's)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.core import presets as jpresets
from euler_tpu.ops import advect as jadvect
from euler_tpu.ops import color as jcolor
from euler_tpu_torch import convert
from euler_tpu_torch.core import presets as tpresets
from euler_tpu_torch.ops import advect as tadvect
from euler_tpu_torch.ops import color as tcolor
from euler_tpu_torch.ops.cuda.grid_kernel import extrapolate_zero

from torch_parity import (
    developed_numpy,
    jax_config,
    n,
    port_config,
    port_state,
)


def test_hsv_basis_bitwise():
    t = np.concatenate([
        np.linspace(-20.0, 20.0, 4001, dtype=np.float32),
        np.arange(-12, 13, dtype=np.float32),           # the breakpoints
        np.random.default_rng(0).normal(0, 50, 1000).astype(np.float32),
    ])
    got = n(tcolor.hsv_basis(torch.as_tensor(t)))
    want = np.asarray(jcolor.hsv_basis(jnp.asarray(t)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("preset", ["dam_break", "block_obstacles"])
def test_rainbow_preset_bitwise(preset):
    cfg = port_config(64, rainbow=True)
    jcfg = jax_config(cfg, interpret=False)
    _, st = getattr(tpresets, preset)(cfg, seed=2, device="cpu")
    _, jst = getattr(jpresets, preset)(jcfg, seed=2)
    got = convert.state_to_numpy(st)
    for f in dataclasses.fields(jst):
        np.testing.assert_array_equal(got[f.name],
                                      np.asarray(getattr(jst, f.name)),
                                      err_msg=f.name)
    assert got["r"].any() and got["g"].any() and got["b"].any()


@pytest.mark.parametrize("dt", [0.03, 0.0])
def test_advect_p_matches_jax(dt):
    cfg = port_config(64)
    jcfg = jax_config(cfg, interpret=False)
    scn, st = port_state(developed_numpy(64))
    uu, vv = extrapolate_zero(cfg, st.u, st.v, st.fluid, st.prev_fluid,
                              scn.solid)
    q = np.random.default_rng(1).random((cfg.ny, cfg.nx), np.float32)
    got = tadvect.advect_p(cfg, torch.as_tensor(q), uu, vv, st.fluid,
                           torch.tensor(dt))
    want = jadvect.advect_p(jcfg, jnp.asarray(q), jnp.asarray(n(uu)),
                            jnp.asarray(n(vv)), jnp.asarray(n(st.fluid)),
                            jnp.float32(dt))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-6, rtol=0)
    outside = ~n(st.fluid)
    np.testing.assert_array_equal(n(got)[outside], q[outside])
    if dt == 0.0:
        np.testing.assert_array_equal(n(got), q)
