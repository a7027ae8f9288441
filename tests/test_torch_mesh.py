"""The data axis (`euler_tpu_torch/parallel/mesh.py`), the data-parallel
K2 (`parallel/cuda_shard.make_dp_substep_mg`), `sim.step_frame`'s
`marker_pass` hook and the port's dry run, on gloo ranks against the JAX
package's single-device functions.

One spawn of 2 ranks on a data-only mesh serves the checks that need a
group (tests/torch_shard_ranks.py `mesh_rank`):
  * `make_sharded_step` on tests/test_parallel.py's batch (the global
    layout, 32 x 16), gathered: against JAX's `step_frame_batched_jit`
    at tests/test_parallel.py:55-72's tolerances (u, v within 1e-5,
    counts bitwise), and bitwise the port's unsharded
    `step_frame_batched`;
  * `make_dp_substep_mg`, each rank its own developed 64² dam break,
    against JAX's `project_substep_mg` in interpret mode at K2's pinned
    tolerances (tests/test_torch_substep.py: velocities within 2e-3,
    iterations within 1);
  * the row-sharded marker pass inside `step_frame` on each rank's "y"
    of one rank: bitwise the frame without it, K1 once a substep;
  * `make_sharded_step` on a "y" of 2 ranks (blocks of 8 x 32) with the
    same batch in the global marker layout: every block marches the
    whole store; held to the unsharded batch (counts, alive, the store's
    order, the RNG equal; u, v and live positions within 1e-4);
  * the refusals: a "cuda" mesh on the gloo group and a world size the
    group does not have raise.
In process: the hook against JAX's `step_frame(..., marker_pass=)`
(counts, alive, drops bitwise, u and v within 5e-3: tests/
test_torch_sim.py's frame tolerances), a block under the halo's 8 rows
refused, and the row-block step with IC(0) built (its MG runs:
tests/test_torch_global_mg.py); a split that does not divide the grid
refused by both packages (JAX's `shard_spatial`, the port's
`block_span`).  And one `dryrun_multichip(4, "gloo")`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.core import state as jstate
from euler_tpu.ops import markers_slots as jms
from euler_tpu.ops.pallas.substep_kernel import project_substep_mg
from euler_tpu.parallel.batch import build_batch as jbuild_batch
from euler_tpu.parallel.batch import step_frame_batched_jit
from euler_tpu.parallel import spatial as jspatial
from euler_tpu.sim import step_frame as jstep_frame
from euler_tpu_torch import convert, sim
from euler_tpu_torch.core.presets import dam_break
from euler_tpu_torch.ops.markers_slots import marker_pass_slots
from euler_tpu_torch.parallel.batch import build_batch, step_frame_batched
from euler_tpu_torch.parallel.comm import LocalGroup
from euler_tpu_torch.parallel.cuda_shard import make_spatial_step_pallas
from euler_tpu_torch.parallel.dryrun import dryrun_multichip, launch
from euler_tpu_torch.parallel.mesh import block_span, make_mesh
from euler_tpu_torch.parallel.spatial import Blocks

import torch_shard_ranks as ranks
from torch_parity import jax_config, jax_state, pallas_interpret

N = 2


@pytest.fixture(scope="module")
def run():
    return launch(N, "gloo", ranks.mesh_rank)


def _jax(cfg):
    return dataclasses.replace(jax_config(cfg, interpret=False),
                               use_pallas_markers=False)


def test_data_axis_matches_jax(run):
    jcfg = _jax(ranks.DATA_CFG)
    jscn, jst = jbuild_batch(ranks.DATA_TEXTS, jcfg)
    with pallas_interpret():
        ref = step_frame_batched_jit(jcfg, jscn, jst)
    for got in run:
        assert bool(got["data_bitwise"])
        for k in ("u", "v"):
            np.testing.assert_allclose(got[f"data_{k}"],
                                       np.asarray(getattr(ref, k)),
                                       atol=1e-5, rtol=0, err_msg=k)
        np.testing.assert_array_equal(got["data_marker_count"],
                                      np.asarray(ref.marker_count))
        assert list(got["data_frame_count"]) == [1] * len(ranks.DATA_TEXTS)


def test_dp_substep_matches_pallas_kernel(run):
    jcfg = jax_config(ranks.DP_CFG)
    dt = jnp.float32(ranks.DP_DT)
    for rank, got in enumerate(run):
        x = {k: jnp.asarray(got[f"dp_in_{k}"]) for k in
             ("u", "v", "fluid", "prev_fluid", "solid", "p")}
        u, v, iters, _, msq, _ = project_substep_mg(
            jcfg, dt, dt, *x.values(), interpret=True)
        assert got["dp_out_u"].shape == (1, 64, 64)
        np.testing.assert_allclose(got["dp_out_u"][0], np.asarray(u),
                                   atol=2e-3, rtol=0)
        np.testing.assert_allclose(got["dp_out_v"][0], np.asarray(v),
                                   atol=2e-3, rtol=0)
        assert abs(int(got["dp_out_iters"][0]) - int(iters)) <= 1
        assert int(iters) > 0 and float(got["dp_out_msq"][0]) > 0.0
    # the ranks stepped different instances
    assert not np.array_equal(run[0]["dp_out_u"], run[1]["dp_out_u"])


def test_sharded_marker_pass_in_the_frame(run):
    for got in run:
        assert bool(got["hook_bitwise"])
        assert int(got["hook_k1_calls"]) == (
            ranks.HOOK_FRAMES * ranks.main_config(32, 32).max_substeps)


def test_refusals(run):
    for got in run:
        assert "ValueError" in str(got["refuse_cuda"])
        assert "ValueError" in str(got["refuse_world"])
    # the global layout on blocks runs: y = 2 held to the unsharded batch
    scn, st = build_batch(ranks.DATA_TEXTS, ranks.DATA_CFG, device="cpu")
    want = convert.state_to_numpy(step_frame_batched(ranks.DATA_CFG, scn,
                                                     st))
    for got in run:
        got = {k[7:]: v for k, v in got.items() if k.startswith("yblock_")}
        for k in ("marker_count", "alive", "alive_count", "dropped_markers",
                  "frame_count"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got["rng"].astype(np.int64),
                                      want["rng"].astype(np.int64))
        for k in ("u", "v"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0,
                                       err_msg=k)
        live = want["alive"][:, None].repeat(2, 1)  # [B, 2, M]
        np.testing.assert_allclose(got["markers"][live],
                                   want["markers"][live], atol=1e-4, rtol=0)
    assert int(want["alive_count"].sum()) > 0
    # a block under the halo's 8 rows: DATA_CFG's 16 rows on 4 "y" blocks
    with LocalGroup(4, device="cpu") as g:
        with pytest.raises(RuntimeError, match="shallower"):
            g.run(lambda comm: Blocks(ranks.DATA_CFG, comm))
    # the frame on blocks runs MG (the global cycle, P5) and IC(0) (the
    # global sweeps, P6): the row-block step with IC(0) is built
    cfg = ranks.main_config(32, 32)
    ic0 = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, preconditioner="ic0", dtype="float64"))
    with LocalGroup(2, device="cpu") as g:
        steps = g.run(lambda comm: make_spatial_step_pallas(ic0, comm))
    assert all(callable(step) for step in steps)


def test_uneven_split_refused_as_jax():
    """A 10-row grid over 4 row blocks: the JAX package's `shard_spatial`
    (a `device_put` onto `spatial_mesh(4, x=1)` of the virtual CPU
    devices of tests/conftest.py, no compile) refuses it, and so does the
    port's `mesh.block_span`: neither package pads a split that does not
    divide the grid."""
    cfg = dataclasses.replace(ranks.main_config(16, 16), ny=10)
    scn, st = dam_break(cfg, device="cpu")
    jscn, jst = jax_state((convert.scenario_to_numpy(scn),
                           convert.state_to_numpy(st)))
    jcfg = _jax(cfg)
    with pytest.raises(ValueError, match="divisible by 4.*equal to 10"):
        jspatial.shard_spatial(jcfg, jspatial.spatial_mesh(4, x=1), jscn,
                               jst)
    for r in range(4):
        with pytest.raises(ValueError, match="10 rows do not split over "
                                             "y=4"):
            block_span(cfg.ny, 4, r, "y")
    assert block_span(12, 4, 3, "y") == (9, 3)


def test_mesh_needs_an_initialised_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(device="cpu")


def test_marker_pass_hook_matches_jax():
    """A marker_pass given to step_frame runs in place of the route's on
    every substep, with the deferred alive plane, in both packages."""
    cfg = ranks.main_config(32, 32)
    jcfg = _jax(cfg)
    scn, st = dam_break(cfg, device="cpu")
    jscn = jstate.Scenario(**{k: jnp.asarray(v) for k, v in
                              convert.scenario_to_numpy(scn).items()})
    jst = jstate.FluidState(**{k: jnp.asarray(v) for k, v in
                               convert.state_to_numpy(st).items()})
    calls = []

    def counted(*args, **kw):
        calls.append(kw.get("defer_alive"))
        return marker_pass_slots(*args, **kw)

    step = jax.jit(lambda a, b: jstep_frame(jcfg, a, b,
                                            marker_pass=jms.marker_pass_slots))
    for frame in range(2):
        st = sim.step_frame(cfg, scn, st, marker_pass=counted)
        jst = step(jscn, jst)
        got = convert.state_to_numpy(st)
        for k in ("marker_count", "alive", "dropped_markers", "alive_count"):
            np.testing.assert_array_equal(got[k], np.asarray(getattr(jst, k)),
                                          err_msg=k)
        for k in ("u", "v"):
            np.testing.assert_allclose(got[k], np.asarray(getattr(jst, k)),
                                       atol=5e-3, rtol=0, err_msg=k)
    assert calls == [True] * (2 * cfg.max_substeps)
    with pytest.raises(ValueError, match="global layout"):
        gcfg = dataclasses.replace(cfg, marker_layout="global")
        sim.step_frame(gcfg, *dam_break(gcfg, device="cpu"),
                       marker_pass=counted)


def test_dryrun_multichip(capsys):
    results = dryrun_multichip(4, "gloo")
    assert len(results) == 4
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "batch", "spatial step", "pallas step", "marker pass", "dp substep"]
    assert all(int(r["alive_count"]) > 0 for r in results)
