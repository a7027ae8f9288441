"""Column blocks: the frame, the sharded marker pass and the batch on
("y", "x") blocks with x > 1 (`euler_tpu_torch/parallel/spatial.py`,
`parallel/cuda_shard.py`, `parallel/mesh.py`), their kernels' plain
versions on the CPU, against the JAX package's single-device functions.

The JAX package's 2-D frames run under GSPMD on 8 virtual devices
(tests/test_spatial.py:57-95), which takes minutes here; the reference
is its single-device function on the same state (`torch_parity.
jax_frames`: the marker pass on its jnp path, the solve on its jnp
`pcg_loop`), held as tests/test_torch_spatial_step.py holds the row
blocks: marker counts, the alive plane, the RNG, alive_count and the
drops equal, u and v within 1e-5, live positions within 1e-4.
  (a) K1, K7 and S1 (their plain versions, as the wrappers run them on
      CPU tensors) on the 2 x 2 blocks of a developed 64² state with
      sources in every block, K1 and K7 on blocks padded with 8 rows and
      columns of each neighbour (`cuda_shard.block_with_halo`), put
      together: bitwise the port's unsharded kernels, and against JAX's
      `marker_pass_slots`, its grid stage's jnp op sequence
      (tests/test_pallas_grid.py:27-36) and `update_fluid_sources_slots`;
  (b) `make_spatial_step` on 4 x 2 in-process blocks of 16 x 32
      (tests/test_spatial.py's mesh shape; its 32 x 16 grid is narrower
      than two halos) on tests/test_pallas_shard.py:30-33's 64² dam
      break, 3 frames;
  (c) 2 x 2 in-process blocks of tests/test_spatial.py:29-37's 32 x 16
      text, and of a 40 x 100 scenario with sources in each block;
  (d) one spawn of 4 gloo ranks (tests/torch_shard_ranks.py
      `col_frame_rank`): `spatial_mesh(4, x=2)` frames of the dam break,
      and `make_sharded_step` on `make_mesh(4, data=1, x=2)` with the
      text and its mirror (the Jacobi, the global MG and the global
      IC(0) solves, and the global marker layout in rainbow), each
      instance against JAX;
  (e) `make_spatial_step_pallas` raises ValueError on x > 1, as the JAX
      package asserts (pallas_shard.py:146-148).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.ops import advect as jadvect
from euler_tpu.ops import extrapolate as jextrapolate
from euler_tpu.ops import forces as jforces
from euler_tpu.ops import markers_slots as jms
from euler_tpu_torch import convert, sim
from euler_tpu_torch.core.scenario import build_scenario
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda import grid_kernel as k7
from euler_tpu_torch.ops.cuda import marker_fused_kernel as k1
from euler_tpu_torch.ops.cuda.source_kernel import emit_sources
from euler_tpu_torch.parallel.comm import LocalGroup
from euler_tpu_torch.parallel.cuda_shard import (
    H,
    block_with_halo,
    make_spatial_step_pallas,
)
from euler_tpu_torch.parallel.dryrun import launch

import torch_shard_ranks as ranks
from torch_parity import (
    assert_frame,
    assert_live_close,
    block_frames,
    cfl_dt,
    jax_config,
    jax_frames,
    jax_state,
)

N = 2  # blocks a side of the kernels' layout
KERNEL_SIZE = 64


def sources_text(rows: int, width: int, every: int = 4, left: int = 2,
                 water=(0, 0), floor: bool = False) -> bytes:
    """A scenario text `width` cells across with a source at both ends of
    every `every`-th row (sources in each quarter of the grid), `left`
    cells of water at the left of each row, water across the rows of
    `water` = (first, end), and with `floor` a row of solid below."""
    lines = []
    for k in range(rows):
        src = "?" if k % every == 0 else " "
        fill = "0" if water[0] <= k < water[1] else " "
        lines.append(src + "0" * left + fill * (width - 2 - left) + src)
    if floor:
        lines.append("X" * width)
    return ("\n".join(lines) + "\n").encode()


@functools.lru_cache(maxsize=None)
def _kernel_state():
    """(cfg, scn, state) at 64² with sources in each 32 x 32 block,
    developed 3 frames by the unsharded port."""
    cfg = dataclasses.replace(ranks.TEXT_CFG, nx=KERNEL_SIZE,
                              ny=KERNEL_SIZE)
    scn, st = build_scenario(sources_text(56, 60, left=24, water=(10, 20),
                                          floor=True), cfg, device="cpu")
    for _ in range(3):
        st = sim.step_frame(cfg, scn, st)
    return cfg, scn, st


def _quarters(cfg, scn):
    """The blocks of the N x N layout that hold a source."""
    Yl, Xl = cfg.ny // N, cfg.nx // N
    return {(int(y) // Yl, int(x) // Xl) for y, x in scn.source_yx.tolist()}


def _blocks(planes, cfg):
    """Each (r, c) block of `planes` with its halo, the block's config and
    its place in the grid."""
    Yl, Xl = cfg.ny // N, cfg.nx // N
    cfg_b = dataclasses.replace(cfg, ny=Yl + 2 * H, nx=Xl + 2 * H)
    for r in range(N):
        for c in range(N):
            yield r, c, cfg_b, [block_with_halo(a, N, r, H, N, c)
                                for a in planes], dict(
                clamp_ny=cfg.ny, row_offset=r * Yl - H, clamp_nx=cfg.nx,
                col_offset=c * Xl - H)


def _together(parts, cfg):
    """Put the N x N blocks' cropped [.., Yl, Xl] outputs back together."""
    return torch.cat([torch.cat(parts[r * N:(r + 1) * N], -1)
                      for r in range(N)], -2)


def _crop(a):
    return a[..., H:-H, H:-H]


def test_k1_on_2x2_blocks_matches_jax():
    cfg, scn, st = _kernel_state()
    K = cfg.slots_per_cell
    assert _quarters(cfg, scn) == {(r, c) for r in range(N)
                                   for c in range(N)}
    dt = cfl_dt(cfg, st)
    planes = (st.u, st.v, st.fluid, scn.solid,
              st.markers.reshape(2 * K, cfg.ny, cfg.nx), st.marker_count,
              scn.sink | scn.solid)
    _build.PLAIN_CALLS.clear()
    outs = [[], [], []]
    for _, _, cfg_b, p, at in _blocks(planes, cfg):
        for out, a in zip(outs, k1.march_rebin(cfg_b, *p[:5], dt, p[5],
                                               dead=p[6], **at)):
            out.append(_crop(a))
    assert _build.PLAIN_CALLS["K1"] == N * N
    slots, count, drop = (_together(o, cfg) for o in outs)
    whole = k1.march_rebin(cfg, *planes[:5], dt, planes[5], dead=planes[6])
    for a, b in zip((slots, count, drop), whole):
        assert torch.equal(a, b)
    # markers crossed the blocks' edges
    assert (count != st.marker_count)[:, 31:33].any()
    assert (count != st.marker_count)[31:33].any()

    jcfg = dataclasses.replace(jax_config(cfg, interpret=False),
                               use_pallas_markers=False)
    jscn, jst = jax_state((convert.scenario_to_numpy(scn),
                           convert.state_to_numpy(st)))
    ref = jax.jit(functools.partial(jms.marker_pass_slots, jcfg))(
        jscn, jst, jnp.float32(dt))
    np.testing.assert_array_equal(count.numpy(),
                                  np.asarray(ref.marker_count))
    assert int(count.sum()) == int(ref.alive_count)
    assert int(drop.sum()) + int(st.dropped_markers) == int(
        ref.dropped_markers)
    assert_live_close(cfg, slots.numpy(),
                      np.asarray(ref.markers).reshape(2 * K, cfg.ny, cfg.nx),
                      count)


def _jax_grid_stage(cfg, u, v, fluid, prev, solid, dt):
    """tests/test_pallas_grid.py:27-36's jnp op sequence."""
    jcfg = jax_config(cfg, interpret=False)
    u = jextrapolate.extrapolate(jcfg, u, fluid, prev, "u")
    v = jextrapolate.extrapolate(jcfg, v, fluid, prev, "v")
    u = jforces.zero_bounds(jcfg, u, fluid, solid, "u")
    v = jforces.zero_bounds(jcfg, v, fluid, solid, "v")
    ut = jadvect.advect_u(jcfg, u, v, fluid, dt)
    vt = jadvect.advect_v(jcfg, u, v, fluid, dt)
    vt = jforces.apply_body_forces(jcfg, vt, dt)
    return (jforces.zero_bounds(jcfg, ut, fluid, solid, "u"),
            jforces.zero_bounds(jcfg, vt, fluid, solid, "v"))


def test_k7_on_2x2_blocks_matches_jax():
    cfg, scn, st = _kernel_state()
    # one frame on: fluid and prev_fluid differ, so the extrapolation works
    st = sim.step_frame(cfg, scn, st)
    dt = cfl_dt(cfg, st)
    planes = (st.u, st.v, st.fluid, st.prev_fluid, scn.solid)
    assert (st.fluid != st.prev_fluid).any()
    _build.PLAIN_CALLS.clear()
    outs = [[], []]
    for _, _, cfg_b, p, at in _blocks(planes, cfg):
        for out, a in zip(outs, k7.grid_stage(cfg_b, *p, dt, **at)):
            out.append(_crop(a))
    assert _build.PLAIN_CALLS["K7"] == N * N
    got = [_together(o, cfg) for o in outs]
    whole = k7.grid_stage(cfg, *planes, dt)
    for a, b in zip(got, whole):
        assert torch.equal(a, b)
    want = _jax_grid_stage(cfg, *(jnp.asarray(a.numpy()) for a in planes),
                           jnp.float32(dt))
    for a, b, name in zip(got, want, ("ut", "vt")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0, err_msg=name)
    assert float(got[0].abs().max()) > 0.0


S1_FIELDS = ("markers", "alive", "marker_count", "r", "g", "b", "rng",
             "alive_count", "source_exhausted")


def test_s1_on_2x2_blocks_matches_jax():
    """Every block walks every source with the all-reduced counts and
    writes the sources of its own cells: put together, bitwise the
    unsharded S1 and JAX's `update_fluid_sources_slots`."""
    cfg, scn, st = _kernel_state()
    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    Yl, Xl = Y // N, X // N
    ys, xs = scn.source_yx[:, 0].long(), scn.source_yx[:, 1].long()
    counts = torch.where(scn.source_valid, st.marker_count[ys, xs],
                         0).to(torch.int32)
    planes = ("markers", "alive", "marker_count", "r", "g", "b")
    parts = {k: [] for k in planes}
    scalars = []
    _build.PLAIN_CALLS.clear()
    for r in range(N):
        for c in range(N):
            cut = (slice(r * Yl, (r + 1) * Yl), slice(c * Xl, (c + 1) * Xl))
            b = st.replace(**{k: getattr(st, k)[(..., *cut)].clone(
                memory_format=torch.contiguous_format) for k in planes},
                **{k: getattr(st, k).clone() for k in
                   ("rng", "alive_count", "source_exhausted")})
            bs = dataclasses.replace(scn, **{
                k: getattr(scn, k)[cut].contiguous()
                for k in ("solid", "source", "sink")})
            emit_sources(cfg, bs, b, None, row_offset=r * Yl, counts=counts,
                         col_offset=c * Xl)
            for k in planes:
                parts[k].append(getattr(b, k))
            scalars.append([getattr(b, k).to(torch.int64) for k in
                            ("rng", "alive_count", "source_exhausted")])
    assert _build.PLAIN_CALLS["S1"] == N * N
    assert all(torch.equal(a, b) for s in scalars for a, b in
               zip(s, scalars[0]))
    got = {k: _together(v, cfg) for k, v in parts.items()}
    got.update(zip(("rng", "alive_count", "source_exhausted"), scalars[0]))
    whole = st.replace(**{k: getattr(st, k).clone() for k in S1_FIELDS})
    emit_sources(cfg, scn, whole)
    for k in S1_FIELDS:
        assert torch.equal(got[k], getattr(whole, k).to(got[k].dtype)), k
    assert int(got["alive_count"]) > int(st.alive_count)

    from euler_tpu.ops.markers_slots import update_fluid_sources_slots

    jscn, jst = jax_state((convert.scenario_to_numpy(scn),
                           convert.state_to_numpy(st)))
    jout = update_fluid_sources_slots(jax_config(cfg, interpret=False),
                                      jscn, jst)
    for k in S1_FIELDS:
        want = np.asarray(getattr(jout, k))
        np.testing.assert_array_equal(
            got[k].numpy().astype(want.dtype).reshape(want.shape), want,
            err_msg=k)


@functools.lru_cache(maxsize=None)
def _developed():
    return ranks.developed(ranks.FRAME_CFG, ranks.FRAME_DEVELOP)


COL_FRAMES = 3


def test_dam_break_on_4x2_local_blocks_matches_jax():
    cfg = ranks.FRAME_CFG
    scn, st = _developed()
    _build.PLAIN_CALLS.clear()
    got = block_frames(cfg, scn, st, 4, 2, COL_FRAMES)
    per = 8 * COL_FRAMES * cfg.max_substeps
    assert [_build.PLAIN_CALLS[k] for k in ("K1", "S1", "K7", "P4")] == \
        [per, 0, per, per]
    assert_frame(cfg, got, jax_frames(cfg, scn, st, COL_FRAMES))


def test_text_on_2x2_local_blocks_matches_jax():
    cfg = ranks.TEXT_CFG
    scn, st = build_scenario(ranks.TEXT, cfg, device="cpu")
    _build.PLAIN_CALLS.clear()
    got = block_frames(cfg, scn, st, 2, 2, ranks.TEXT_STEPS)
    per = 4 * ranks.TEXT_STEPS * cfg.max_substeps
    assert [_build.PLAIN_CALLS[k] for k in ("K1", "S1", "K7", "P4")] == \
        [per] * 4
    assert_frame(cfg, got, jax_frames(cfg, scn, st, ranks.TEXT_STEPS))


def test_sources_in_each_2x2_block_match_jax():
    """40 x 100 on 2 x 2 blocks of 20 x 50, a source in each block: S1 on
    each block walks every source and writes its own."""
    cfg = dataclasses.replace(ranks.TEXT_CFG, nx=100, ny=40)
    scn, st = build_scenario(sources_text(36, 64, every=6), cfg,
                             device="cpu")
    assert {(int(y) // 20, int(x) // 50) for y, x in
            scn.source_yx.tolist()} == {(0, 0), (0, 1), (1, 0), (1, 1)}
    got = block_frames(cfg, scn, st, 2, 2, 2)
    assert_frame(cfg, got, jax_frames(cfg, scn, st, 2))


@pytest.fixture(scope="module")
def gloo():
    return launch(4, "gloo", ranks.col_frame_rank)


def test_spatial_step_on_2x2_ranks_matches_jax(gloo):
    cfg = ranks.FRAME_CFG
    scn, st = _developed()
    want = jax_frames(cfg, scn, st, ranks.FRAME_STEPS)
    per = ranks.FRAME_STEPS * cfg.max_substeps
    for g in gloo:
        got = {k[6:]: v for k, v in g.items() if k.startswith("frame_")
               and k != "frame_calls"}
        assert_frame(cfg, got, want)
        assert g["frame_calls"].tolist() == [per, 0, per, per]


def test_sharded_step_on_y_and_x_matches_jax(gloo):
    """`make_sharded_step` on make_mesh(4, data=1, x=2): one data rank,
    each instance of the batch on 2 x 2 blocks of 8 x 16."""
    cfg = ranks.TEXT_CFG
    assert gloo[0]["batch_layout"].tolist() == [1, 2, 2]
    texts = (ranks.TEXT,
             b"\n".join(r[::-1] for r in ranks.TEXT.split(b"\n")))
    for i, text in enumerate(texts):
        scn, st = build_scenario(text, cfg, device="cpu")
        want = jax_frames(cfg, scn, st, ranks.TEXT_STEPS)
        for g in gloo:
            got = {k[6:]: v[i] for k, v in g.items()
                   if k.startswith("batch_") and k != "batch_layout"}
            assert_frame(cfg, got, want)


def test_sharded_step_mg_on_y_and_x_matches_jax(gloo):
    """`make_sharded_step` on make_mesh(4, data=1, x=2) with the global MG
    solve (P5's plain version, once a block a substep; no P4): each
    instance against JAX, u and v within 2e-3 (the converged solve's
    frames, tests/test_torch_global_mg.py)."""
    cfg = ranks.TEXT_MG_CFG
    texts = (ranks.TEXT,
             b"\n".join(r[::-1] for r in ranks.TEXT.split(b"\n")))
    per = 2 * ranks.TEXT_STEPS * cfg.max_substeps
    for i, text in enumerate(texts):
        scn, st = build_scenario(text, cfg, device="cpu")
        want = jax_frames(cfg, scn, st, ranks.TEXT_STEPS)
        for g in gloo:
            assert g["mg_batch_layout"].tolist() == [1, 2, 2]
            assert g["mg_batch_calls"].tolist() == [per, 0]
            got = {k[9:]: v[i] for k, v in g.items()
                   if k.startswith("mg_batch_")
                   and k not in ("mg_batch_layout", "mg_batch_calls")}
            assert_frame(cfg, got, want, 2e-3)


def test_sharded_step_ic0_on_y_and_x_matches_jax(gloo):
    """`make_sharded_step` on make_mesh(4, data=1, x=2) with the global
    IC(0) solve (P6's plain version, once a block a substep, its sweeps
    staged across the gloo ranks; no P4): each instance against JAX."""
    cfg = ranks.TEXT_IC0_CFG
    texts = (ranks.TEXT,
             b"\n".join(r[::-1] for r in ranks.TEXT.split(b"\n")))
    per = 2 * ranks.TEXT_STEPS * cfg.max_substeps
    for i, text in enumerate(texts):
        scn, st = build_scenario(text, cfg, device="cpu")
        want = jax_frames(cfg, scn, st, ranks.TEXT_STEPS)
        for g in gloo:
            assert g["ic0_batch_layout"].tolist() == [1, 2, 2]
            assert g["ic0_batch_calls"].tolist() == [per, 0]
            got = {k[10:]: v[i] for k, v in g.items()
                   if k.startswith("ic0_batch_")
                   and k not in ("ic0_batch_layout", "ic0_batch_calls")}
            assert_frame(cfg, got, want)


def test_sharded_step_global_rainbow_on_y_and_x_matches_jax(gloo):
    """`make_sharded_step` on make_mesh(4, data=1, x=2) in the global
    marker layout in rainbow (the reference's configuration): every block
    holds the whole [2, M] store and runs G1, G2 and S1's global form on
    it (their plain versions, once a block a substep); each instance
    against JAX, the store in marker order."""
    cfg = ranks.TEXT_GLOBAL_CFG
    texts = (ranks.TEXT,
             b"\n".join(r[::-1] for r in ranks.TEXT.split(b"\n")))
    per = 2 * ranks.TEXT_STEPS * cfg.max_substeps
    for i, text in enumerate(texts):
        scn, st = build_scenario(text, cfg, device="cpu")
        want = jax_frames(cfg, scn, st, ranks.TEXT_STEPS)
        for g in gloo:
            assert g["global_batch_layout"].tolist() == [1, 2, 2]
            assert g["global_batch_calls"].tolist() == [per] * 4
            got = {k[13:]: v[i] for k, v in g.items()
                   if k.startswith("global_batch_")
                   and k not in ("global_batch_layout",
                                 "global_batch_calls")}
            assert_frame(cfg, got, want)
        assert int(want["alive_count"]) > int(st.alive_count)


def test_pallas_step_refuses_column_blocks():
    def rank(comm):
        make_spatial_step_pallas(ranks.FRAME_CFG, comm)

    with LocalGroup(2, 2, device="cpu") as g:
        with pytest.raises(RuntimeError, match="ValueError.*row-"):
            g.run(rank)
    with pytest.raises(ValueError, match="row blocks split 'y'"):
        make_spatial_step_pallas(ranks.FRAME_CFG, None, axis="x")
