"""What K3's graph-replayed solve must reproduce, checked on the CPU: the
iteration cap of the plain MG-PCG against the JAX package's Pallas MG
kernel (interpret mode), and the workspace cache (its key and its bound)
as plain Python, without CUDA."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.ops.pallas import mg_kernel as jmgk
from euler_tpu_torch.ops.cuda import mg_kernel as tmgk
from euler_tpu_torch.ops.project import pressure_matrix_diag

from torch_parity import jax_config, n, pallas_interpret, port_config, t


@pytest.fixture(scope="module")
def system():
    """A speckled 64² dam-break-like mask inside solid walls and a random
    RHS on its fluid cells, from a seed."""
    rng = np.random.default_rng(7)
    Y = X = 64
    fluid = np.zeros((Y, X), bool)
    fluid[2:40, 2:34] = True
    fluid |= rng.random((Y, X)) < 0.05
    fluid[[0, -1], :] = fluid[:, [0, -1]] = False
    solid = np.zeros((Y, X), bool)
    solid[1, 1:-1] = solid[1:-1, 1] = solid[1:-1, X - 2] = True
    fluid &= ~solid
    b = np.where(fluid, rng.standard_normal((Y, X)), 0).astype(np.float32)
    a = pressure_matrix_diag(port_config(64), t(solid), t(fluid))
    return b, a, fluid, solid


@pytest.mark.parametrize("cap", [1, 3])
def test_iteration_cap_matches_pallas_kernel(system, cap):
    """With a tolerance no iterate meets, the solve stops at exactly
    `max_iterations`, with the Pallas kernel's count and pressure: the cap
    that K3's guarded chunks must reproduce."""
    b, a, fluid, solid = system
    cfg = port_config(64)
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, max_iterations=cap, tol=0.0, tol_rel=0.0))
    p, iters, _ = tmgk.solve_pressure_mg_plain(cfg, t(b), a, t(fluid))
    with pallas_interpret():
        jp, jiters, _ = jmgk.solve_pressure_mg_pallas(
            jax_config(cfg, interpret=False), jnp.asarray(b),
            jnp.asarray(n(a)), jnp.asarray(fluid), jnp.asarray(solid))
    assert int(iters) == int(jiters) == cap
    scale = float(np.abs(np.asarray(jp)).max())
    assert scale > 0
    np.testing.assert_allclose(n(p), np.asarray(jp), atol=5e-4 * scale,
                               rtol=0)


def _solver(**over):
    cfg = port_config(128)
    return dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver,
                                                               **over))


@pytest.mark.parametrize("field,value", [
    ("tol_rel", 1e-6), ("mg_w_depth", 3), ("max_iterations", 50),
    ("mg_cheby_degree", 2), ("tol", 1e-5), ("mg_coarse_iters", 8)])
def test_workspace_key_separates_launch_parameters(field, value):
    """Two configs that differ in one field the captured launches bake in
    get different workspaces; the same config and device the same one."""
    base = _solver()
    assert getattr(base.solver, field) != value
    key = tmgk.workspace_key(base, "cuda:0")
    assert key == tmgk.workspace_key(_solver(), "cuda:0")
    assert key != tmgk.workspace_key(_solver(**{field: value}), "cuda:0")
    assert key != tmgk.workspace_key(base, "cuda:1")


def test_workspace_key_follows_grid_size():
    assert (tmgk.workspace_key(port_config(64), "cuda:0")
            != tmgk.workspace_key(port_config(128), "cuda:0"))


def test_workspace_cache_is_bounded_lru(monkeypatch):
    """At most _MAX_WORKSPACES entries; a hit is the same object and
    becomes the most recent; the least recently used goes first and is
    closed, as every entry is by `clear_workspaces`."""
    made = []

    closed = []

    class Fake:
        nbytes = 0

        def __init__(self, cfg, device, ls=0):
            made.append((cfg.solver.tol_rel, device))

        def close(self):
            closed.append(self)

    monkeypatch.setattr(tmgk, "MgWorkspace", Fake)
    monkeypatch.setattr(tmgk, "_WORKSPACES", type(tmgk._WORKSPACES)())
    cfgs = [_solver(tol_rel=10.0 ** -k) for k in range(1, 7)]
    first = tmgk.workspace(cfgs[0], "cuda:0")
    for cfg in cfgs[1:tmgk._MAX_WORKSPACES]:
        tmgk.workspace(cfg, "cuda:0")
    assert tmgk.workspace(cfgs[0], "cuda:0") is first
    assert len(made) == tmgk._MAX_WORKSPACES
    second = tmgk._WORKSPACES[tmgk.workspace_key(cfgs[1], "cuda:0")]
    tmgk.workspace(cfgs[-1], "cuda:0")
    assert closed == [second]
    assert len(tmgk._WORKSPACES) == tmgk._MAX_WORKSPACES
    assert tmgk.workspace_key(cfgs[1], "cuda:0") not in tmgk._WORKSPACES
    assert tmgk.workspace_key(cfgs[0], "cuda:0") in tmgk._WORKSPACES
    tmgk.clear_workspaces()
    assert not tmgk._WORKSPACES and len(closed) == 1 + tmgk._MAX_WORKSPACES


def test_cpu_solve_takes_the_plain_version(system):
    """CPU tensors never build a workspace."""
    b, a, fluid, _ = system
    before = dict(tmgk._WORKSPACES)
    p, iters, _ = tmgk.solve_pressure_mg(port_config(64), t(b), a,
                                         t(fluid))
    assert int(iters) > 0 and torch.isfinite(p).all()
    assert dict(tmgk._WORKSPACES) == before
