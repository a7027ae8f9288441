"""The frame on row blocks (`euler_tpu_torch/parallel/spatial.py`
`make_spatial_step`, `parallel/cuda_shard.make_spatial_step_pallas`,
`parallel/mesh.make_sharded_step` with y > 1), its kernels' plain
versions on the CPU, against JAX `step_frame_jit`.

The JAX package's sharded frames run under GSPMD on 8 virtual devices
(tests/test_spatial.py, tests/test_pallas_shard.py), which takes minutes
here; the reference is its single-device frame on the same state, with
the marker pass on its jnp path (bitwise its Pallas pass) and the solve
on its jnp `pcg_loop` (`use_pallas=False`, as its row-sharded frame,
pallas_shard.py:150-154, solves).  Marker counts, the alive plane, the
RNG, alive_count and the drops must be equal; u and v within 1e-5, as
those tests pin; live marker positions within 1e-4 (XLA contracts the
JAX march's products into FMAs on the CPU, the tolerance
tests/test_torch_shard.py holds K1 to).
  * 4 gloo ranks (one spawn, tests/torch_shard_ranks.py `frame_rank`):
    `make_spatial_step_pallas` on tests/test_pallas_shard.py:30-33's
    64² dam break, developed 3 frames, then 2 frames; and
    `make_sharded_step` on `make_mesh(4)` (data 2 x y 2) with the 32 x 16
    text and its mirror, 3 frames;
  * in process (`comm.LocalGroup`): `make_spatial_step` on 2 blocks of
    tests/test_spatial.py:29-37's 32 x 16 text (a source, solids), 3
    frames; the 64² dam break on 4 blocks, bitwise the gloo ranks'
    counts; sources in every block of a 40 x 100 scenario, 2 frames;
  * the refusals, each naming its ROADMAP item (RB-GS M14), the global
    layout refused by both steps with a ValueError naming the JAX
    package's assert (spatial.py:43; `spatial.Blocks` runs it:
    tests/test_torch_blocks_color_global.py), rainbow and f64 MG (refused
    until M15 part b) built and run by both, and what stays refused of
    column blocks
    (tests/test_torch_col_blocks.py runs them): a block narrower than the
    halo, the pallas step on x > 1.
"""

import dataclasses
import functools

import pytest

from euler_tpu_torch.core.scenario import build_scenario
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.parallel import spatial
from euler_tpu_torch.parallel.comm import LocalGroup
from euler_tpu_torch.parallel.cuda_shard import make_spatial_step_pallas
from euler_tpu_torch.parallel.dryrun import launch

import torch_shard_ranks as ranks
from torch_parity import assert_frame as _assert_frame
from torch_parity import block_frames, jax_frames as _jax_frames


def _local_frames(cfg, scn, st, n, frames):
    """`make_spatial_step` on n in-process row blocks; the whole state as
    numpy (flat layout)."""
    return block_frames(cfg, scn, st, n, 1, frames)


@pytest.fixture(scope="module")
def gloo():
    return launch(4, "gloo", ranks.frame_rank)


@functools.lru_cache(maxsize=None)
def _developed():
    return ranks.developed(ranks.FRAME_CFG, ranks.FRAME_DEVELOP)


def test_pallas_step_on_4_ranks_matches_jax(gloo):
    cfg = ranks.FRAME_CFG
    scn, st = _developed()
    want = _jax_frames(cfg, scn, st, ranks.FRAME_STEPS)
    for g in gloo:
        got = {k[6:]: v for k, v in g.items() if k.startswith("frame_")
               and k != "frame_calls"}
        _assert_frame(cfg, got, want)
        # every grid operation on the blocks: K1, K7 and P4's plain
        # versions once a block a substep (no sources: no S1)
        per = ranks.FRAME_STEPS * cfg.max_substeps
        assert g["frame_calls"].tolist() == [per, 0, per, per]
    assert int(want["alive_count"]) > 500


def test_dam_break_on_4_local_blocks():
    """The same frames on 4 in-process blocks: counts, alive and RNG
    those of JAX (u, v within 1e-5)."""
    cfg = ranks.FRAME_CFG
    scn, st = _developed()
    got = _local_frames(cfg, scn, st, 4, ranks.FRAME_STEPS)
    _assert_frame(cfg, got, _jax_frames(cfg, scn, st, ranks.FRAME_STEPS))


def test_spatial_step_text_on_2_blocks_matches_jax():
    cfg = ranks.TEXT_CFG
    scn, st = build_scenario(ranks.TEXT, cfg, device="cpu")
    _build.PLAIN_CALLS.clear()
    got = _local_frames(cfg, scn, st, 2, ranks.TEXT_STEPS)
    per = 2 * ranks.TEXT_STEPS * cfg.max_substeps
    assert [_build.PLAIN_CALLS[k] for k in ("K1", "S1", "K7", "P4")] == \
        [per] * 4
    _assert_frame(cfg, got, _jax_frames(cfg, scn, st, ranks.TEXT_STEPS))


def test_sharded_step_on_data_and_rows_matches_jax(gloo):
    """`make_sharded_step` on make_mesh(4) = data 2 x y 2: each data rank
    steps its instance on its rows."""
    cfg = ranks.TEXT_CFG
    assert gloo[0]["batch_layout"].tolist() == [2, 2, 1]
    texts = (ranks.TEXT,
             b"\n".join(r[::-1] for r in ranks.TEXT.split(b"\n")))
    for i, text in enumerate(texts):
        scn, st = build_scenario(text, cfg, device="cpu")
        want = _jax_frames(cfg, scn, st, ranks.TEXT_STEPS)
        for g in gloo:
            got = {k[6:]: v[i] for k, v in g.items()
                   if k.startswith("batch_") and k != "batch_layout"}
            _assert_frame(cfg, got, want)


def test_sources_in_every_block():
    """40 x 100 with sources on every row band, 4 blocks of 10 rows: S1 on
    each block walks every source; the frames match JAX."""
    cfg = dataclasses.replace(ranks.TEXT_CFG, nx=100, ny=40)
    text = "\n".join("?" * (k % 3 + 1) + " " * 40 + "00"
                     for k in range(36)) + "\n"
    scn, st = build_scenario(text.encode(), cfg, device="cpu")
    rows = {int(y) // 10 for y in scn.source_yx[:, 0]}
    assert rows == {0, 1, 2, 3}
    got = _local_frames(cfg, scn, st, 4, 2)
    _assert_frame(cfg, got, _jax_frames(cfg, scn, st, 2))


# what each refusal raises and names: the ROADMAP item, or the JAX
# package's assert that spatial sharding keeps the slot layout
REFUSED = {"MG galerkin / rbgs": (NotImplementedError,
                                  "MG galerkin / rbgs.*M14"),
           "global marker layout": (
               ValueError, "slot markers.*euler_tpu/parallel/spatial.py:43")}


@pytest.mark.parametrize("over,what", [
    (dict(solver=dataclasses.replace(ranks.TEXT_MG_CFG.solver,
                                     dtype="float64")), "f64 MG"),
    (dict(rainbow=True), "rainbow"),
    (dict(marker_layout="global"), "global marker layout"),
    (dict(solver=dataclasses.replace(ranks.TEXT_MG_CFG.solver,
                                     mg_smoother="rbgs")),
     "MG galerkin / rbgs"),
])
def test_frame_refusals(over, what):
    """What the frame on blocks refuses, each naming its ROADMAP item or
    the JAX assert (the global MG cycle and the global IC(0) run:
    tests/test_torch_global_mg.py, tests/test_torch_ic0_blocks.py); and
    rainbow and f64 MG, which both steps build and run on 2 row blocks
    (f64 MG: P5's plain version in f64, a solve a block a substep)."""
    cfg = dataclasses.replace(ranks.TEXT_CFG, **over)
    if what in ("rainbow", "f64 MG"):
        scn, st = build_scenario(ranks.TEXT, cfg, device="cpu")

        def rank(comm):
            out = []
            for make in (spatial.make_spatial_step,
                         make_spatial_step_pallas):
                bscn, b = spatial.shard_spatial(cfg, comm, scn, st)
                out.append(int(make(cfg, comm)(bscn, b).frame_count))
            return out

        _build.PLAIN_CALLS.clear()
        with LocalGroup(2, device="cpu") as g:
            assert g.run(rank) == [[1, 1]] * 2
        if what == "f64 MG":
            assert _build.PLAIN_CALLS["P5"] == 2 * 2 * cfg.max_substeps
        return
    exc, match = REFUSED[what]
    with pytest.raises(exc, match=match):
        spatial.make_spatial_step(cfg, None)
    with pytest.raises(exc, match=match):
        make_spatial_step_pallas(cfg, None)


def test_column_blocks_refused():
    """Column blocks run (tests/test_torch_col_blocks.py); what stays
    refused is a block narrower than the halo's 8 columns, and the JAX
    package's row-sharded pallas step on a mesh with x > 1 (ValueError,
    as pallas_shard.py:146-148 asserts)."""
    def narrow(comm):
        spatial.make_spatial_step(ranks.TEXT_CFG, comm)

    with LocalGroup(1, 8, device="cpu") as g:
        with pytest.raises(RuntimeError, match="narrower than the halo"):
            g.run(narrow)

    def pallas(comm):
        make_spatial_step_pallas(ranks.TEXT_CFG, comm)

    with LocalGroup(2, 2, device="cpu") as g:
        with pytest.raises(RuntimeError, match="ValueError.*x = 1 mesh"):
            g.run(pallas)
