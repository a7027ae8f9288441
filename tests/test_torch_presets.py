"""Presets: the port builds bit-identical initial states to the JAX
package (same numpy seeding, same re-binning refresh)."""

import dataclasses

import numpy as np
import pytest

from euler_tpu.core import presets as jpresets
from euler_tpu_torch import convert
from euler_tpu_torch.core import presets as tpresets
from euler_tpu_torch.core import rng as trng

from torch_parity import jax_config, port_config


@pytest.mark.parametrize("preset,size", [
    ("dam_break", 64), ("dam_break", 256), ("block_obstacles", 64),
])
def test_preset_states_bitwise(preset, size):
    cfg = port_config(size)
    jcfg = jax_config(cfg, interpret=False)
    jscn, jst = getattr(jpresets, preset)(jcfg, seed=3)
    scn, st = getattr(tpresets, preset)(cfg, seed=3, device="cpu")

    got = convert.state_to_numpy(st)
    for f in dataclasses.fields(jst):
        want = np.asarray(getattr(jst, f.name))
        assert got[f.name].dtype == want.dtype, f.name
        np.testing.assert_array_equal(got[f.name], want, err_msg=f.name)
    got_scn = convert.scenario_to_numpy(scn)
    for f in dataclasses.fields(jscn):
        np.testing.assert_array_equal(got_scn[f.name],
                                      np.asarray(getattr(jscn, f.name)),
                                      err_msg=f.name)
    assert int(st.marker_count.sum()) > 0


def test_convert_round_trip():
    cfg = port_config(32)
    _, st = tpresets.dam_break(cfg, device="cpu")
    arrays = convert.state_to_numpy(st)
    assert arrays["markers"].shape == (2, cfg.max_markers)
    back = convert.state_to_numpy(convert.state_from_numpy(arrays,
                                                              device="cpu"))
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert convert.state_from_numpy(arrays, device="cpu").markers.shape == (
        2, cfg.slots_per_cell, cfg.ny, cfg.nx)


def test_initial_rng_pair_matches():
    from euler_tpu.core import rng as jrng

    np.testing.assert_array_equal(trng.initial_device_state(),
                                  jrng.initial_device_state())
