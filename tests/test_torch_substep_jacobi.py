"""K10's plain version (grid stage + Jacobi projection) against the JAX
`project_substep_jacobi` Pallas kernel in interpret mode, on the
developed 64² dam break, at the tolerances of
tests/test_substep_fused.py:149-190: velocities atol 2e-3, PCG
iterations within 1, msq rtol 1e-3.  And the inactive substep (dt = 0,
dt_proj = +inf): 0 iterations, finite outputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.ops.pallas.substep_kernel import (
    project_substep_jacobi as jproject_substep_jacobi,
)
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda import substep_kernel as k10

from torch_parity import (
    developed_numpy,
    jax_config,
    jax_state,
    n,
    port_state,
    speed_config,
)


def _run_both(dt, dt_proj):
    cfg = speed_config(64)
    scn, st = port_state(developed_numpy(64))
    jscn, jst = jax_state(developed_numpy(64))
    got = k10.project_substep_jacobi(
        cfg, torch.tensor(dt), torch.tensor(dt_proj), st.u, st.v, st.fluid,
        st.prev_fluid, scn.solid)
    want = jproject_substep_jacobi(
        jax_config(cfg), jnp.float32(dt), jnp.float32(dt_proj), jst.u,
        jst.v, jst.fluid, jst.prev_fluid, jscn.solid, True)
    return got, want


@pytest.fixture(scope="module")
def active():
    return _run_both(0.03, 0.03)


@pytest.fixture(scope="module")
def inactive():
    return _run_both(0.0, float("inf"))


def test_substep_jacobi_matches_pallas_kernel(active):
    (u2, v2, it, _res, msq), (ju2, jv2, jit_, _jres, jmsq) = active
    np.testing.assert_allclose(n(u2), n(ju2), atol=2e-3, rtol=0)
    np.testing.assert_allclose(n(v2), n(jv2), atol=2e-3, rtol=0)
    assert abs(int(it) - int(jit_)) <= 1
    assert int(it) > 0
    np.testing.assert_allclose(float(msq), float(jmsq), rtol=1e-3)


def test_inactive_substep_is_free(inactive):
    """dt_proj = +inf gives an exactly-zero RHS: 0 iterations, and the
    face update with dt = 0 keeps the outputs finite, as in the JAX
    kernel."""
    (u2, v2, it, res, msq), (ju2, jv2, jit_, jres, jmsq) = inactive
    assert int(it) == 0 == int(jit_)
    assert float(res) == 0.0 == float(jres)
    for a in (u2, v2, msq):
        assert torch.isfinite(a).all()
    np.testing.assert_allclose(n(u2), n(ju2), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(v2), n(jv2), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(msq), float(jmsq), rtol=1e-5)


def test_wrapper_takes_plain_version_on_cpu():
    cfg = speed_config(64)
    scn, st = port_state(developed_numpy(64))
    dt = torch.tensor(0.02)
    args = (cfg, dt, dt, st.u, st.v, st.fluid, st.prev_fluid, scn.solid)
    before = _build.PLAIN_CALLS["K10"]
    got = k10.project_substep_jacobi(*args)
    want = k10.project_substep_jacobi_plain(*args)
    assert _build.PLAIN_CALLS["K10"] == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
