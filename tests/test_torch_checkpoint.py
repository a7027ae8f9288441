"""Checkpoints in the port (`euler_tpu_torch/io/checkpoint.py`): a bit
exact round trip, a bit exact resume (save, load, one frame equals the
frame run on), and cross-loads with the JAX package's checkpoints in
both directions (JAX npz -> port -> JAX npz), the store flat or
spatial."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from euler_tpu.io import checkpoint as jckpt
from euler_tpu.core.scenario import load_scenario as jload_scenario
from euler_tpu.parallel.spatial import to_spatial
from euler_tpu_torch import cli, convert, sim
from euler_tpu_torch.core.scenario import load_scenario
from euler_tpu_torch.io import checkpoint

from torch_parity import jax_config


def _waterfall(frames=2, rainbow=False):
    argv = ["scenarios/waterfall.txt"] + (["--rainbow"] if rainbow else [])
    cfg = cli.build_config(cli.parse_args(argv))
    scn, st = load_scenario("scenarios/waterfall.txt", cfg, device="cpu")
    for _ in range(frames):
        st = sim.step_frame(cfg, scn, st)
    return cfg, scn, st


def _assert_states_equal(a, b):
    for k, v in a.items():
        assert v.dtype == b[k].dtype and v.shape == b[k].shape, k
        assert v.tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("rainbow", [False, True])
def test_round_trip_is_bit_exact(tmp_path, rainbow):
    cfg, scn, st = _waterfall(rainbow=rainbow)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, cfg, scn, st)
    cfg2, scn2, st2 = checkpoint.load(path, device="cpu")
    assert cfg2 == cfg
    _assert_states_equal(convert.state_to_numpy(st2),
                         convert.state_to_numpy(st))
    _assert_states_equal(convert.scenario_to_numpy(scn2),
                         convert.scenario_to_numpy(scn))
    assert st2.markers.shape == st.markers.shape


def test_resume_is_bit_exact(tmp_path):
    cfg, scn, st = _waterfall()
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, cfg, scn, st)
    on = sim.step_frame(cfg, scn, st)
    cfg2, scn2, st2 = checkpoint.load(path, device="cpu")
    resumed = sim.step_frame(cfg2, scn2, st2)
    _assert_states_equal(convert.state_to_numpy(resumed),
                         convert.state_to_numpy(on))


@pytest.mark.parametrize("spatial", [False, True])
def test_jax_checkpoint_round_trips_through_the_port(tmp_path, spatial):
    """A JAX checkpoint (its CLI's spatial store, or the flat one) loads
    in the port, equal field for field; the port saves it again and the
    JAX package loads that back equal."""
    cfg, _, _ = _waterfall(0)
    jcfg = jax_config(cfg)  # its Pallas re-bin in interpret mode
    jscn, jst = jload_scenario("scenarios/waterfall.txt", jcfg)
    if spatial:
        jst = to_spatial(jcfg, jst)
    jst = jst.replace(frame_count=jnp.int32(3),
                      source_exhausted=jnp.bool_(True))
    jpath = str(tmp_path / "jax.npz")
    jckpt.save(jpath, jcfg, jscn, jst)
    pcfg, scn, st = checkpoint.load(jpath, device="cpu")
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    got = convert.state_to_numpy(st)
    for k, v in got.items():
        want = np.asarray(getattr(jst, k)).reshape(v.shape)
        assert v.tobytes() == want.tobytes() and v.dtype == want.dtype, k
    assert scn.num_sources == 60
    ppath = str(tmp_path / "port.npz")
    checkpoint.save(ppath, pcfg, scn, st)
    jcfg2, jscn2, jst2 = jckpt.load(ppath)
    assert jcfg2 == jcfg
    for k, v in got.items():
        assert np.asarray(getattr(jst2, k)).tobytes() == v.tobytes(), k
    for k, v in convert.scenario_to_numpy(scn).items():
        np.testing.assert_array_equal(np.asarray(getattr(jscn2, k)), v)


def test_old_checkpoints_without_drops_or_pressure(tmp_path):
    cfg, scn, st = _waterfall(1)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, cfg, scn, st)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files
                  if k not in ("state.dropped_markers", "state.p")}
    np.savez(path, **arrays)
    _, _, st2 = checkpoint.load(path, device="cpu")
    assert int(st2.dropped_markers) == 0 and not st2.p.any()
    assert st2.p.shape == st.p.shape and st2.p.dtype == st.p.dtype
