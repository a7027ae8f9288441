"""K2's plain version (grid stage + MG-PCG projection) against the JAX
fused-substep Pallas kernel in interpret mode, at the tolerances of
tests/test_substep_fused.py: velocities atol 2e-3, PCG iterations
within 1, msq rtol 1e-3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.ops.pallas.substep_kernel import (
    project_substep_mg as jproject_substep_mg,
)
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda import substep_kernel as k2

from torch_parity import (
    developed_numpy,
    jax_config,
    jax_state,
    n,
    port_config,
    port_state,
)


def _run_both(dt, dt_proj, warm):
    cfg = port_config(64, warm=warm)
    jcfg = jax_config(cfg, interpret=False)
    scn, st = port_state(developed_numpy(64))
    jscn, jst = jax_state(developed_numpy(64))
    got = k2.project_substep_mg(
        cfg, torch.tensor(dt), torch.tensor(dt_proj), st.u, st.v, st.fluid,
        st.prev_fluid, scn.solid, st.p)
    want = jproject_substep_mg(
        jcfg, jnp.float32(dt), jnp.float32(dt_proj), jst.u, jst.v,
        jst.fluid, jst.prev_fluid, jscn.solid, jst.p, True)
    return got, want


@pytest.mark.parametrize("warm", [True, False])
def test_substep_matches_pallas_kernel(warm):
    (u2, v2, it, resid, msq, p), (ju2, jv2, jit, jres, jmsq, jp) = _run_both(
        0.03, 0.03, warm)
    np.testing.assert_allclose(n(u2), n(ju2), atol=2e-3, rtol=0)
    np.testing.assert_allclose(n(v2), n(jv2), atol=2e-3, rtol=0)
    assert abs(int(it) - int(jit)) <= 1
    assert int(it) > 0
    np.testing.assert_allclose(float(msq), float(jmsq), rtol=1e-3)
    scale = float(np.abs(n(jp)).max())
    np.testing.assert_allclose(n(p), n(jp), atol=5e-4 * scale, rtol=0)
    assert (n(p) >= 0).all()


def test_inactive_substep_is_free():
    """dt = 0 with dt_proj = +inf: an exactly-zero RHS, 0 iterations,
    zero pressure, finite outputs (as the JAX kernel gives)."""
    (u2, v2, it, resid, msq, p), (ju2, jv2, jit, jres, jmsq, jp) = _run_both(
        0.0, float("inf"), True)
    assert int(it) == 0 == int(jit)
    assert float(resid) == 0.0 == float(jres)
    assert not p.any()
    for a in (u2, v2, msq):
        assert torch.isfinite(a).all()
    np.testing.assert_allclose(n(u2), n(ju2), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(v2), n(jv2), atol=1e-5, rtol=0)


def test_wrapper_takes_plain_version_on_cpu():
    cfg = port_config(64)
    scn, st = port_state(developed_numpy(64))
    before = _build.PLAIN_CALLS["K2"]
    dt = torch.tensor(0.02)
    got = k2.project_substep_mg(cfg, dt, dt, st.u, st.v, st.fluid,
                                st.prev_fluid, scn.solid, st.p)
    want = k2.project_substep_mg_plain(cfg, dt, dt, st.u, st.v, st.fluid,
                                       st.prev_fluid, scn.solid, st.p)
    assert _build.PLAIN_CALLS["K2"] == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
