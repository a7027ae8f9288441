"""Rainbow colour and the global marker layout on ("y", "x") blocks
(`euler_tpu_torch/parallel/spatial.Blocks`), their kernels' plain
versions on the CPU, against the JAX package's single-device functions
(`torch_parity.jax_frames`: the marker pass on its jnp path, the solve on
its jnp `pcg_loop`), held as tests/test_torch_col_blocks.py holds the
frame on blocks: marker counts, the alive plane or mask, the RNG,
alive_count and the drops equal, u and v within 1e-5 (the converged MG
solve 2e-3), live positions within 1e-4, and in rainbow r, g and b within
5e-3 (tests/test_torch_sim_routes.py's rainbow tolerance).
  (a) `advect_p` on blocks padded with 8 rows and columns of each
      neighbour, told their place in the grid: the cropped blocks
      bitwise the whole plane's, and the whole plane's within 1e-6 of
      JAX `advect_p`;
  (b) rainbow frames on 2 x 2 blocks of tests/test_spatial.py:29-37's
      32 x 16 text and on 4 x 1 blocks of the text at 32 x 32, with the
      Jacobi solve (P4) and with the global MG solve (P5);
  (c) rainbow with sources in each 2 x 2 block of 40 x 100, some within
      the halo's 8 rows of a block edge, so a neighbour's S1 writes
      colours in a block's halo: in the slot and the global layout;
  (d) S1's global form on 2 x 2 blocks, put together, bitwise the whole
      grid's and JAX's `update_fluid_sources`; global-layout frames of
      tests/test_parallel.py's scenario and of the 40 x 100 basic.txt in
      rainbow (the golden configuration) on 2 x 2 blocks, the store in
      marker order; the global pass takes each scenario's whole solid
      and sink planes once.
The gloo ranks of `mesh.make_sharded_step` in the global layout are in
tests/test_torch_col_blocks.py and tests/test_torch_mesh.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.ops.advect import advect_p as jadvect_p
from euler_tpu.ops.markers import update_fluid_sources as jsources
from euler_tpu_torch import convert, sim
from euler_tpu_torch.core.scenario import build_scenario
from euler_tpu_torch.ops.advect import advect_p
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda.grid_kernel import extrapolate_zero
from euler_tpu_torch.ops.cuda.source_kernel import emit_sources
from euler_tpu_torch.parallel.cuda_shard import H, block_with_halo

import torch_shard_ranks as ranks
from global_states import golden_config
from helpers import read_scenario
from test_torch_col_blocks import sources_text
from torch_parity import (
    assert_frame,
    block_frames,
    cfl_dt,
    developed_numpy,
    jax_config,
    jax_frames,
    jax_state,
    port_config,
    port_state,
)


@pytest.mark.parametrize("y,x", [(2, 2), (4, 1)])
def test_advect_p_on_padded_blocks(y, x):
    cfg = port_config(64)
    scn, st = port_state(developed_numpy(64))
    dt = cfl_dt(cfg, st)
    uu, vv = extrapolate_zero(cfg, st.u, st.v, st.fluid, st.prev_fluid,
                              scn.solid)
    q = torch.as_tensor(np.random.default_rng(3).random(
        (cfg.ny, cfg.nx), dtype=np.float32))
    whole = advect_p(cfg, q, uu, vv, st.fluid, dt)
    assert not torch.equal(whole, q)
    Yl, Xl = cfg.ny // y, cfg.nx // x
    cols = x > 1
    cfg_b = dataclasses.replace(cfg, ny=Yl + 2 * H,
                                nx=Xl + 2 * H if cols else cfg.nx)
    rows = []
    for r in range(y):
        parts = []
        for c in range(x):
            at = dict(clamp_ny=cfg.ny, row_offset=r * Yl - H)
            if cols:
                at.update(clamp_nx=cfg.nx, col_offset=c * Xl - H)
            pad = [block_with_halo(a, y, r, H, x, c)
                   for a in (q, uu, vv, st.fluid)]
            out = advect_p(cfg_b, *pad, dt, **at)[H:H + Yl]
            parts.append(out[:, H:H + Xl] if cols else out)
        rows.append(torch.cat(parts, -1))
    assert torch.equal(torch.cat(rows, -2), whole)

    jcfg = jax_config(cfg, interpret=False)
    want = jadvect_p(jcfg, *(jnp.asarray(a.numpy()) for a in
                             (q, uu, vv, st.fluid)), jnp.float32(dt))
    np.testing.assert_allclose(whole.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


TALL = dataclasses.replace(ranks.TEXT_CFG, ny=32)
RAINBOW = {
    "text_2x2": (ranks.TEXT_CFG, 2, 2, 1e-5),
    "text_mg_2x2": (ranks.TEXT_MG_CFG, 2, 2, 2e-3),
    "text_4x1": (TALL, 4, 1, 1e-5),
    "text_mg_4x1": (dataclasses.replace(ranks.TEXT_MG_CFG, ny=32), 4, 1,
                    2e-3),
}


@pytest.mark.parametrize("case", sorted(RAINBOW))
def test_rainbow_frames_on_blocks_match_jax(case):
    """K7's extrapolated form on the padded blocks, the colours'
    extrapolation and `advect_p` on them: every block's plain K7 and solve
    once a substep."""
    base, y, x, atol = RAINBOW[case]
    cfg = dataclasses.replace(base, rainbow=True)
    scn, st = build_scenario(ranks.TEXT, cfg, device="cpu")
    _build.PLAIN_CALLS.clear()
    got = block_frames(cfg, scn, st, y, x, ranks.TEXT_STEPS)
    per = y * x * ranks.TEXT_STEPS * cfg.max_substeps
    solve = "P5" if cfg.solver.preconditioner == "mg" else "P4"
    assert [_build.PLAIN_CALLS[k] for k in ("K1", "S1", "K7", solve)] == \
        [per] * 4
    assert_frame(cfg, got, jax_frames(cfg, scn, st, ranks.TEXT_STEPS), atol)
    assert np.abs(got["r"] - convert.state_to_numpy(st)["r"]).max() > 0.0


@pytest.mark.parametrize("layout", ["slots", "global"])
def test_rainbow_sources_near_block_edges(layout):
    """40 x 100 on 2 x 2 blocks of 20 x 50, a source in each block and
    sources in rows 14 and 20, on either side of the blocks' edge at row
    20 and within 8 rows of it, water in rows 12-19 below a row of
    sources in row 20, falling.  The colours start from a seeded random
    field, so S1 rewrites its cells' colours by far more than COLOR_ATOL,
    and the upper blocks' row 19 reads the lower blocks' row-20 sources
    in `advect_p`: their halo must be exchanged after S1 (exchanged once
    before it, the colours stray 0.012 from JAX's)."""
    cfg = dataclasses.replace(ranks.TEXT_CFG, nx=100, ny=40, rainbow=True,
                              marker_layout=layout)
    lines = sources_text(36, 64, every=6, water=(4, 12)).split(b"\n")
    lines[12] = b"?" * 64  # grid row 20: a row of sources above the water
    scn, st = build_scenario(b"\n".join(lines), cfg, device="cpu")
    rng = np.random.default_rng(5)
    st = st.replace(v=torch.full((cfg.ny, cfg.nx), -1.0), **{
        c: torch.as_tensor(rng.random((cfg.ny, cfg.nx), dtype=np.float32))
        for c in ("r", "g", "b")})
    ys = {int(y) for y in scn.source_yx[:, 0]}
    assert {(int(y) // 20, int(x) // 50) for y, x in
            scn.source_yx.tolist()} == {(0, 0), (0, 1), (1, 0), (1, 1)}
    assert {14, 20} <= ys and bool(st.fluid[19].any())
    got = block_frames(cfg, scn, st, 2, 2, 2)
    want = jax_frames(cfg, scn, st, 2)
    assert_frame(cfg, got, want)
    assert int(want["alive_count"]) > int(st.alive_count)


S1_FIELDS = ("markers", "alive", "marker_count", "r", "g", "b", "rng",
             "alive_count", "source_exhausted")


def test_s1_global_on_2x2_blocks_matches_jax():
    """Every block walks every source with the all-reduced counts and
    appends the emitted markers to its whole store; each writes its own
    cells' counts and colours: put together, bitwise the whole grid's S1
    and JAX's `update_fluid_sources`."""
    cfg = dataclasses.replace(ranks.TEXT_CFG, nx=64, ny=64,
                              marker_layout="global")
    # tests/test_torch_col_blocks.py's S1 state: a source in each 32 x 32
    # block, some cells below markers_per_cell after 3 frames
    scn, st = build_scenario(sources_text(56, 60, left=24, water=(10, 20),
                                          floor=True), cfg, device="cpu")
    for _ in range(3):
        st = sim.step_frame(cfg, scn, st)
    n, Y, X = 2, cfg.ny, cfg.nx
    Yl, Xl = Y // n, X // n
    ys, xs = scn.source_yx[:, 0].long(), scn.source_yx[:, 1].long()
    counts = torch.where(scn.source_valid, st.marker_count[ys, xs],
                         0).to(torch.int32)
    planes = ("marker_count", "r", "g", "b")
    whole_fields = ("markers", "alive", "rng", "alive_count",
                    "source_exhausted")
    rows, held = [], []
    _build.PLAIN_CALLS.clear()
    for r in range(n):
        parts = []
        for c in range(n):
            cut = (slice(r * Yl, (r + 1) * Yl), slice(c * Xl, (c + 1) * Xl))
            b = st.replace(**{k: getattr(st, k)[cut].clone() for k in planes},
                           **{k: getattr(st, k).clone()
                              for k in whole_fields})
            bs = dataclasses.replace(scn, **{
                k: getattr(scn, k)[cut].contiguous()
                for k in ("solid", "source", "sink")})
            emit_sources(cfg, bs, b, None, row_offset=r * Yl, counts=counts,
                         col_offset=c * Xl)
            parts.append(b)
            # torch has few uint32 ops: the RNG compares as int64
            held.append([getattr(b, k).to(torch.int64) if k == "rng"
                         else getattr(b, k) for k in whole_fields])
        rows.append(parts)
    assert _build.PLAIN_CALLS["S1"] == n * n
    assert all(torch.equal(a, b) for h in held for a, b in zip(h, held[0]))
    got = {k: torch.cat([torch.cat([getattr(b, k) for b in parts], -1)
                         for parts in rows], -2) for k in planes}
    got.update(zip(whole_fields, held[0]))
    whole = st.replace(**{k: getattr(st, k).clone() for k in S1_FIELDS})
    emit_sources(cfg, scn, whole)
    for k in S1_FIELDS:
        assert torch.equal(got[k], getattr(whole, k).to(got[k].dtype)), k
    assert int(got["alive_count"]) > int(st.alive_count)

    jscn, jst = jax_state((convert.scenario_to_numpy(scn),
                           convert.state_to_numpy(st)))
    jout = jsources(jax_config(cfg, interpret=False), jscn, jst)
    for k in S1_FIELDS:
        want = np.asarray(getattr(jout, k))
        np.testing.assert_array_equal(
            got[k].numpy().astype(want.dtype).reshape(want.shape), want,
            err_msg=k)


GLOBAL = {
    "data": (ranks.DATA_CFG, ranks.DATA_TEXTS[1], 3),
    "basic_rainbow": (golden_config(rainbow=True),
                      read_scenario("basic.txt"), 2),
}


@pytest.mark.parametrize("case", sorted(GLOBAL))
def test_global_frames_on_2x2_blocks_match_jax(case):
    """G1 + G2 on the gathered grid on every block (their plain versions,
    once a block a substep), the whole store on every block (checked by
    `gather_blocks`), against JAX in marker order."""
    cfg, text, frames = GLOBAL[case]
    scn, st = build_scenario(text, cfg, device="cpu")
    _build.PLAIN_CALLS.clear()
    got = block_frames(cfg, scn, st, 2, 2, frames)
    per = 4 * frames * cfg.max_substeps
    assert [_build.PLAIN_CALLS[k] for k in ("G1", "G2", "K7", "P4")] == \
        [per] * 4
    assert _build.PLAIN_CALLS["K1"] == 0
    want = jax_frames(cfg, scn, st, frames)
    assert_frame(cfg, got, want)
    # markers moved: the store is not the one it started from
    start = convert.state_to_numpy(st)["markers"]
    assert np.abs(got["markers"] - start).max() > 0.0


def test_global_pass_gathers_each_scenario_once():
    """`Blocks.whole_scenario`: the global marker pass takes a scenario's
    whole solid and sink planes at the first substep that sees it and
    keeps them; a second scenario gets its own, equal to its whole
    planes."""
    from euler_tpu_torch.parallel import spatial
    from euler_tpu_torch.parallel.comm import LocalGroup

    cfg = ranks.DATA_CFG
    whole = [build_scenario(t, cfg, device="cpu") for t in ranks.DATA_TEXTS]

    def rank(comm):
        blocks = spatial.Blocks(cfg, comm)
        kept = []
        for scn, st in whole:
            bscn, b = spatial.shard_blocks(cfg, comm, scn, st)
            for _ in range(2):
                b = sim.step_frame(cfg, bscn, b, blocks=blocks)
            kept.append(len(blocks.grids))
        grid = blocks.whole_scenario(bscn)
        return kept, len(blocks.grids), grid.solid, grid.sink

    with LocalGroup(2, 2, device="cpu") as g:
        out = g.run(rank)
    scn = whole[-1][0]
    assert bool(scn.solid.any())
    for kept, n, solid, sink in out:
        assert kept == [1, 2] and n == 2
        assert torch.equal(solid, scn.solid) and torch.equal(sink, scn.sink)
