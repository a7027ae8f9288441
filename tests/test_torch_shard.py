"""K1 per row shard (`euler_tpu_torch/parallel/cuda_shard.py`) on gloo
ranks against the JAX package's single-device functions.

One spawn of 2 ranks (the dam break at 128 x 32) and one of 4 (128 x 64)
serve every check of this module (tests/torch_shard_ranks.py `k1_rank`).
The JAX side stays on one device: its own sharded tests
(tests/test_pallas_shard.py) run on 8 virtual devices and take minutes
here.
  * the exchanged halo: each rank's padded [.., Yl + 16, X] inputs are
    the rows of the zero-padded global planes, bitwise;
  * per-shard K1: the port's plain version on those inputs with
    clamp_ny = Y and row_offset = r Yl - 8 against JAX's
    `march_rebin_pallas` (interpret mode) with the same two arguments:
    counts and drops bitwise over the whole padded plane, live positions
    within 1e-4, the tolerance tests/test_torch_marker_pass.py holds the
    unsharded kernel to (XLA contracts the march's products into FMAs on
    the CPU; the port's arithmetic is the CUDA kernel's, -fmad=false);
  * the exchanged pass: `make_sharded_march_rebin`'s blocks, put
    together, bitwise the port's unsharded K1, and against the JAX
    kernel's shard interiors put together (which tests/
    test_pallas_shard.py:44 pins bitwise to the unsharded JAX kernel) as
    above;
  * the pass's state contract: `make_sharded_marker_pass`'s blocks
    against JAX's `marker_pass_slots` (jnp) at tests/
    test_pallas_shard.py:74-99's tolerances: counts, alive, alive_count
    and drops bitwise, live positions within 1e-4;
  * the mesh layouts of `make_mesh` and `spatial_mesh` are the JAX
    package's for the same counts.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.ops import markers_slots as jms
from euler_tpu.ops.pallas.marker_fused_kernel import march_rebin_pallas
from euler_tpu.parallel.mesh import make_mesh as jmake_mesh
from euler_tpu.parallel.spatial import spatial_mesh as jspatial_mesh
from euler_tpu_torch import convert
from euler_tpu_torch.ops.cuda import marker_fused_kernel as k1
from euler_tpu_torch.parallel.cuda_shard import H, block_with_halo
from euler_tpu_torch.parallel.dryrun import launch

import torch_shard_ranks as ranks
from torch_parity import assert_live_close, jax_config, jax_state

SHARDS = {2: 32, 4: 64}  # ranks: the grid's rows
PLANES = ("u", "v", "fluid", "solid", "slots", "count", "dead")


@pytest.fixture(scope="module", params=sorted(SHARDS))
def run(request):
    """The ranks' arrays, and the whole developed state and its JAX
    form."""
    n = request.param
    ny = SHARDS[n]
    out = launch(n, "gloo", ranks.k1_rank, ny, n)
    cfg = ranks.main_config(ranks.SHARD_NX, ny)
    full = out[0]
    st_np = {k[5:]: v for k, v in full.items() if k.startswith("full_")
             and k[5:] in convert._STATE_FIELDS}
    scn_np = {k: full[f"full_{k}"] for k in convert._SCENARIO_FIELDS}
    scn = convert.scenario_from_numpy(scn_np, device="cpu")
    st = convert.state_from_numpy(st_np, device="cpu")
    return dict(n=n, cfg=cfg, ranks=out, scn=scn, st=st,
                jax=jax_state((scn_np, st_np)))


def _global_planes(cfg, scn, st):
    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    return {"u": st.u, "v": st.v, "fluid": st.fluid, "solid": scn.solid,
            "slots": st.markers.reshape(2 * K, Y, X),
            "count": st.marker_count, "dead": scn.sink | scn.solid}


def test_halo_rows_are_the_global_rows(run):
    cfg, n = run["cfg"], run["n"]
    Yl = cfg.ny // n
    for name, a in _global_planes(cfg, run["scn"], run["st"]).items():
        z = torch.zeros(a.shape[:-2] + (H, cfg.nx), dtype=a.dtype)
        padded = torch.cat([z, a, z], -2).numpy()
        for r, got in enumerate(run["ranks"]):
            want = padded[..., r * Yl:r * Yl + Yl + 2 * H, :]
            np.testing.assert_array_equal(got[f"pad_{name}"], want,
                                          err_msg=f"{name}, rank {r}")
            np.testing.assert_array_equal(
                block_with_halo(a, n, r).numpy(), want)


@pytest.fixture(scope="module")
def jax_shards(run):
    """JAX's kernel on each rank's padded inputs, with the same clamp_ny
    and row_offset."""
    cfg, n = run["cfg"], run["n"]
    cfg_l = dataclasses.replace(cfg, ny=cfg.ny // n + 2 * H)
    jcfg = jax_config(cfg_l)
    out = []
    for got in run["ranks"]:
        p = {k: got[f"pad_{k}"] for k in PLANES}
        out.append([np.asarray(a) for a in march_rebin_pallas(
            jcfg, *(jnp.asarray(p[k]) for k in PLANES[:5]),
            jnp.float32(got["dt"]), jnp.asarray(p["count"]), True,
            dead=jnp.asarray(p["dead"]).astype(jnp.float32),
            clamp_ny=cfg.ny, row_offset=int(got["row_offset"]))])
    return out


def test_k1_per_shard_matches_pallas(run, jax_shards):
    cfg, n = run["cfg"], run["n"]
    cfg_l = dataclasses.replace(cfg, ny=cfg.ny // n + 2 * H)
    moved = 0
    for r, (got, (jslots, jcount, jdrop)) in enumerate(
            zip(run["ranks"], jax_shards)):
        assert int(got["row_offset"]) == r * (cfg.ny // n) - H
        np.testing.assert_array_equal(got["out_count"], jcount)
        np.testing.assert_array_equal(got["out_drop"], jdrop)
        assert_live_close(cfg_l, got["out_slots"], jslots, got["out_count"])
        moved += (got["out_count"] != got["pad_count"]).sum()
        assert int(got["k1_plain_calls"]) == 3  # two sharded + the direct
    assert moved > 0  # markers crossed cells


def test_exchanged_pass_matches_unsharded(run, jax_shards):
    cfg, n = run["cfg"], run["n"]
    Yl = cfg.ny // n
    p = _global_planes(cfg, run["scn"], run["st"])
    dt = torch.as_tensor(run["ranks"][0]["dt"])
    want = k1.march_rebin_plain(cfg, *(p[k] for k in PLANES[:5]), dt,
                                p["count"], dead=p["dead"])
    got = [np.concatenate([g[f"shard_{k}"] for g in run["ranks"]], -2)
           for k in ("slots", "count", "drop")]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.numpy())
    # across the shard boundaries too
    assert (want[1].numpy() != p["count"].numpy())[Yl - 1:Yl + 1].any()
    jgot = [np.concatenate([j[i][..., H:H + Yl, :] for j in jax_shards], -2)
            for i in range(3)]
    np.testing.assert_array_equal(got[1], jgot[1])
    np.testing.assert_array_equal(got[2], jgot[2])
    assert_live_close(cfg, got[0], jgot[0], got[1])


def test_marker_pass_state_contract(run):
    cfg = run["cfg"]
    jscn, jst = run["jax"]
    jcfg = dataclasses.replace(jax_config(cfg, interpret=False),
                               use_pallas_markers=False)
    ref = jax.jit(functools.partial(jms.marker_pass_slots, jcfg))(
        jscn, jst, jnp.float32(run["ranks"][0]["dt"]))
    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    cat = lambda k: np.concatenate(  # noqa: E731
        [g[f"pass_{k}"] for g in run["ranks"]], -2)
    np.testing.assert_array_equal(cat("marker_count"),
                                  np.asarray(ref.marker_count))
    np.testing.assert_array_equal(cat("alive").reshape(-1),
                                  np.asarray(ref.alive))
    for g in run["ranks"]:
        assert int(g["pass_alive_count"]) == int(ref.alive_count)
        assert int(g["pass_dropped_markers"]) == int(ref.dropped_markers)
    markers = cat("markers")
    np.testing.assert_array_equal(markers, run["ranks"][0]["gathered_markers"])
    assert_live_close(cfg, markers.reshape(2 * K, Y, X),
                      np.asarray(ref.markers).reshape(2 * K, Y, X),
                      cat("marker_count"))


def test_mesh_layouts_match_jax(run):
    n = run["n"]
    got = run["ranks"][0]
    assert tuple(got["layout_mesh"]) == jmake_mesh(n).devices.shape
    assert tuple(got["layout_mesh_x2"]) == jmake_mesh(n, x=2).devices.shape
    assert tuple(got["layout_spatial"]) == jspatial_mesh(n).devices.shape
