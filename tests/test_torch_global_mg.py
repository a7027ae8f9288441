"""The frame's global MG solve on ("y", "x") blocks
(`euler_tpu_torch/parallel/spatial_mg.py`; P5's plain version, as
`solve_pressure_blocks` runs it on CPU tensors), against the JAX
package's single-device functions, which its frame on blocks runs under
GSPMD (`parallel/spatial.py:113`: the jnp `pcg_loop` with
`make_mg_preconditioner`, one W-cycle over the whole grid's hierarchy).

In-process blocks (`comm.LocalGroup`) on the CPU; JAX compiles nothing
larger than 108 x 64, mg_min_size 8:
  * the hierarchy, gathered, bit for bit JAX `build_galerkin_hierarchy`
    (c, e, n, active, inv_c, lmax) on 2 x 2 and 4 x 1 blocks of a 64²
    dam-break system, on 2 x 1 blocks of 108 x 64 (blocks of 54 rows:
    the gather is at the 27-row level 1, and the grid's 27-row level 2
    is padded in the gathered part), and on blocks of an odd side, which
    gather at level 0: 4 x 1 blocks of 108 x 64 (27 rows) and 3 x 2 of
    81 x 66 (27 x 33, the grid's level 0 padded);
  * the gather level forced to every level it may take, 0 included: the
    hierarchy and one cycle bit for bit the same;
  * one cycle z = M r, gathered: bit for bit the port's single-device
    `cycle_galerkin`, within 1e-5 of scale of JAX's;
  * the solve against JAX `solve_pressure` (use_pallas=False, MG), cold,
    warm and with a zero RHS: p within 5e-4 of scale, iterations within 1
    (the pinned tolerances of tests/test_torch_mg_padded.py for P3);
  * in f64 (`solver.dtype="float64"`, the JAX package's f64 hierarchy and
    cycle): the hierarchy on 2 x 2 blocks of the 64² system bit for bit,
    and the solve, cold, warm and with a zero RHS, on 2 x 2 blocks of 64²
    and 4 x 1 of 108 x 64 (gather level 0): p within 1e-10 of scale,
    iterations within 1 (three jitted JAX compiles: the hierarchy and
    one solve a grid);
  * `make_spatial_step` with MG (tol_rel 1e-4, warm start) on 2 x 2
    blocks of tests/test_spatial.py's 32 x 16 text and on 4 row blocks of
    the 64² dam break, 3 frames each, against JAX `step_frame_jit`:
    counts, alive, RNG and drops exact, u and v within 2e-3 (the
    frames' tolerance of tests/test_torch_mg_padded.py);
  * the block plan at the card's sizes, f32 and f64 (no JAX).
The gloo ranks' case (`make_sharded_step` with MG on 2 x 2 ranks) is in
tests/test_torch_col_blocks.py, the refusals in
tests/test_torch_spatial_step.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.ops import multigrid as jmg
from euler_tpu.ops import project as jproject
from euler_tpu_torch import sim
from euler_tpu_torch.config import SimConfig, SolverConfig
from euler_tpu_torch.core.presets import dam_break
from euler_tpu_torch.core.scenario import build_scenario
from euler_tpu_torch.ops import multigrid as tmg
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda.grid_kernel import grid_stage_plain
from euler_tpu_torch.ops.forces import max_speed_sq
from euler_tpu_torch.ops.project import divergence_rhs, pressure_matrix_diag
from euler_tpu_torch.parallel import spatial_mg as smg
from euler_tpu_torch.parallel.comm import LocalGroup
from euler_tpu_torch.parallel.cuda_shard import padded

import torch_shard_ranks as ranks
from torch_parity import assert_frame, block_frames, jax_config, jax_frames

MIN_SIZE = 8
FRAME_ATOL = 2e-3


def _config(Y, X, **solver):
    """bench.py's MG (f32 Galerkin + Chebyshev, tol_rel 1e-4, warm start)
    at Y x X, mg_min_size 8."""
    return SimConfig(nx=X, ny=Y, marker_layout="slots",
                     solver=SolverConfig(**{
                         "max_iterations": 100, "dtype": "float32",
                         "tol_rel": 1e-4, "preconditioner": "mg",
                         "warm_start": True, "mg_min_size": MIN_SIZE,
                         **solver}))


@functools.lru_cache(maxsize=None)
def _system(Y, X, dtype="float32"):
    """(cfg, b, a_diag, fluid, solid, p0): a substep's own system on the
    dam break at Y x X, 3 frames on at 64² and 1 at 108 x 64 (the RHS of
    the advected velocities), and the state's pressure, masked, as the
    warm start; with dtype "float64" the same system with the solve, b
    and p0 in f64."""
    if dtype == "float64":
        cfg, b, a_diag, fluid, solid, p0 = _system(Y, X)
        cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, dtype=dtype))
        return cfg, b.double(), a_diag, fluid, solid, p0.double()
    cfg = _config(Y, X)
    scn, st = dam_break(cfg, device="cpu")
    for _ in range(3 if Y == 64 else 1):
        st = sim.step_frame(cfg, scn, st)
    dt = sim._dt_from_msq(cfg, max_speed_sq(cfg, st.u, st.v),
                          torch.tensor(cfg.frame_time))
    ut, vt = grid_stage_plain(cfg, dt, st.u, st.v, st.fluid, st.prev_fluid,
                              scn.solid)
    b = divergence_rhs(cfg, ut, vt, st.fluid, dt)
    a_diag = pressure_matrix_diag(cfg, scn.solid, st.fluid)
    p0 = torch.where(st.fluid, st.p, 0.0)
    return cfg, b, a_diag, st.fluid, scn.solid, p0


def _run(shape, y, x, fn):
    Y, X = shape

    def rank(comm):
        Yl, Xl = Y // y, X // x
        ry, rx = comm.rank("y"), comm.rank("x")
        cut = (slice(ry * Yl, (ry + 1) * Yl), slice(rx * Xl, (rx + 1) * Xl))
        return fn(comm, cut, ("y", "x") if x > 1 else ("y",))

    with LocalGroup(y, x, device="cpu") as g:
        return g.run(rank)


def _ring(comm, fluid, cut, axes):
    return smg.fluid_ring(padded(fluid[cut].contiguous(), comm, 1),
                          "x" in axes)


def _hierarchy(cfg, a_diag, fluid, y, x, gather=None, r=None):
    """The block hierarchy on y x x blocks, gathered: ([(c, e, n, active,
    inv_c, lmax)] of every level, the gather level), and with `r` one
    cycle z = M r put together."""
    def fn(comm, cut, axes):
        h = smg.build_block_hierarchy(
            cfg, comm, axes, a_diag[cut].contiguous(),
            fluid[cut].contiguous(), _ring(comm, fluid, cut, axes), gather)
        levels = [tuple(smg.gather_plane(getattr(lv, f), comm, axes)
                        for f in ("c", "e", "n", "active", "inv_c"))
                  + (lv.lmax,) for lv in h.levels]
        levels += [tuple(getattr(lv, f) for f in ("c", "e", "n", "active",
                                                   "inv_c", "lmax"))
                   for lv in h.coarse[h.gather:]]
        z = None
        if r is not None:
            z = smg.gather_plane(smg.block_cycle(cfg, comm, axes, h,
                                                 r[cut].contiguous()),
                                 comm, axes)
        return levels, h.gather, z

    return _run(tuple(fluid.shape), y, x, fn)[0]


LAYOUTS = {"64x64_2x2": ((64, 64), 2, 2), "64x64_4x1": ((64, 64), 4, 1),
           "108x64_2x1": ((108, 64), 2, 1), "108x64_4x1": ((108, 64), 4, 1),
           "81x66_3x2": ((81, 66), 3, 2)}
# the plan's gather level: blocks of an odd side gather level 0
GATHER = {"64x64_2x2": 2, "64x64_4x1": 2, "108x64_2x1": 1, "108x64_4x1": 0,
          "81x66_3x2": 0}


# the f64 cases: the solves' layouts (blocks of 64² and of 108 x 64, which
# gather at level 0) and the hierarchy's
F64_SOLVES = ("64x64_2x2", "108x64_4x1")
F64_HIERARCHY = "64x64_2x2"


@pytest.mark.parametrize("layout", list(LAYOUTS) + [f"{F64_HIERARCHY}_f64"])
def test_hierarchy_matches_jax_bitwise(layout):
    f64 = layout.endswith("_f64")
    (Y, X), y, x = LAYOUTS[layout.removesuffix("_f64")]
    dtype = "float64" if f64 else "float32"
    cfg, _, a_diag, fluid, _, _ = _system(Y, X, dtype)
    levels, gather, _ = _hierarchy(cfg, a_diag, fluid, y, x)
    assert levels[0][0].dtype == getattr(torch, dtype)
    want = jax.jit(functools.partial(
        jmg.build_galerkin_hierarchy, dtype=getattr(jnp, dtype),
        min_size=MIN_SIZE))(jnp.asarray(a_diag.numpy()),
                            jnp.asarray(fluid.numpy()))
    assert len(levels) == len(want) >= 4
    assert gather == GATHER[layout.removesuffix("_f64")]
    for got, lw in zip(levels, want):
        for g, f in zip(got, ("c", "e", "n", "active", "inv_c", "lmax")):
            np.testing.assert_array_equal(g.numpy(),
                                          np.asarray(getattr(lw, f)),
                                          err_msg=f)
    if Y == 108:  # the grid's 27-row level, padded in the gathered part
        assert [tuple(lv[0].shape) for lv in levels] == [
            (108, 64), (54, 32), (28, 16), (14, 8)]


@functools.lru_cache(maxsize=None)
def _jax_cycle(Y, X):
    cfg, b, a_diag, fluid, solid, _ = _system(Y, X)
    jcfg = jax_config(cfg, interpret=False)

    @jax.jit
    def precon(a, fluid, solid, r):
        return jmg.make_mg_preconditioner(jcfg, solid, fluid, jnp.float32,
                                          a_diag=a)(r)

    return np.asarray(precon(*(jnp.asarray(v.numpy()) for v in
                               (a_diag, fluid, solid, b))))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cycle_matches_single_device(layout):
    """One cycle on the blocks, gathered: bit for bit the port's
    single-device cycle, and within 1e-5 of scale of JAX's (one JAX
    compile a grid)."""
    (Y, X), y, x = LAYOUTS[layout]
    cfg, b, a_diag, fluid, _, _ = _system(Y, X)
    _, _, z = _hierarchy(cfg, a_diag, fluid, y, x, r=b)
    whole = tmg.build_galerkin_hierarchy(a_diag, fluid, torch.float32,
                                         min_size=MIN_SIZE)
    want = tmg.cycle_galerkin(whole, b, **tmg.cycle_kwargs(cfg))
    assert torch.equal(z, want)
    jz = _jax_cycle(Y, X)
    scale = float(np.abs(jz).max())
    assert scale > 0
    np.testing.assert_allclose(z.numpy(), jz, atol=1e-5 * scale, rtol=0)


@pytest.mark.parametrize("layout", ["64x64_2x2", "64x64_4x1"])
def test_every_gather_level_gives_the_same_bits(layout):
    """The gather forced at each level from 0 (the whole level 0 on every
    block, as blocks of an odd side take it) to the plan's: the gathered
    hierarchy and one cycle bit for bit the same."""
    (Y, X), y, x = LAYOUTS[layout]
    cfg, b, a_diag, fluid, _, _ = _system(Y, X)
    levels, top, z = _hierarchy(cfg, a_diag, fluid, y, x, r=b)
    assert top == 2
    for gather in range(top):
        got_levels, g, got_z = _hierarchy(cfg, a_diag, fluid, y, x, gather,
                                          r=b)
        assert g == gather and torch.equal(got_z, z)
        for got, want in zip(got_levels, levels):
            for a, c in zip(got, want):
                assert torch.equal(a, c)
    with pytest.raises(RuntimeError, match="gather level 3"):
        _hierarchy(cfg, a_diag, fluid, y, x, 3)


@pytest.fixture(scope="module")
def jax_solve():
    """The JAX `solve_pressure` (use_pallas False: `pcg_loop` with
    `make_mg_preconditioner`), always given a guess: x0 = 0 is bitwise
    its cold start (p = 0, r = b - A 0 = b)."""
    return jax.jit(jproject.solve_pressure, static_argnums=0)


@pytest.mark.parametrize("case", ["cold", "warm", "zero"])
@pytest.mark.parametrize("layout", ["64x64_2x2", "64x64_4x1", "108x64_4x1",
                                    "81x66_3x2"]
                         + [f"{k}_f64" for k in F64_SOLVES])
def test_solve_matches_jax(layout, case, jax_solve):
    """`solve_pressure_blocks` on the blocks against the JAX solve: p
    within 5e-4 of scale (f64: 1e-10), iterations within 1 (0 on a zero
    RHS), the same iterations and residual on every block; one plain call
    a block."""
    f64 = layout.endswith("_f64")
    layout = layout.removesuffix("_f64")
    (Y, X), y, x = LAYOUTS[layout]
    cfg, b, a_diag, fluid, solid, p0 = _system(
        Y, X, "float64" if f64 else "float32")
    if case == "zero":
        b = torch.zeros_like(b)
    x0 = p0 if case == "warm" else None
    before = _build.PLAIN_CALLS["P5"]

    def fn(comm, cut, axes):
        f1 = padded(fluid[cut].contiguous(), comm, 1)
        out = smg.solve_pressure_blocks(
            cfg, comm, axes, b[cut].contiguous(), a_diag[cut].contiguous(),
            fluid[cut].contiguous(), f1,
            None if x0 is None else x0[cut].contiguous())
        return (smg.gather_plane(out[0], comm, axes), int(out[1]),
                float(out[2]))

    out = _run((Y, X), y, x, fn)
    assert _build.PLAIN_CALLS["P5"] == before + y * x
    assert len({o[1:] for o in out}) == 1
    p, it, res = out[0]
    assert p.dtype == b.dtype
    jp, jit, jres = jax_solve(
        jax_config(cfg, interpret=False),
        *(jnp.asarray(v.numpy()) for v in (b, a_diag, fluid, solid)),
        jnp.asarray((torch.zeros_like(b) if x0 is None else x0).numpy()))
    scale = max(float(np.abs(np.asarray(jp)).max()), 1e-30)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp),
                               atol=(1e-10 if f64 else 5e-4) * scale, rtol=0)
    if case == "zero":
        assert it == int(jit) == 0 and not p.any()
        return
    assert abs(it - int(jit)) <= 1 and it > 0
    tol = max(cfg.solver.tol, cfg.solver.tol_rel * float(b.abs().max()))
    assert res <= tol and float(jres) <= tol


# tests/test_spatial.py's text and the dam break of tests/test_pallas_
# shard.py:30-33 with the converged MG solve (the dam break's mg_min_size
# 16: levels 64², 32², 16², the blocks' level 0 distributed; the deeper
# layouts are the solve's above, the smaller JAX frame compiles faster)
TEXT_MG = ranks.TEXT_MG_CFG
DAM_MG = dataclasses.replace(ranks.FRAME_CFG, solver=dataclasses.replace(
    TEXT_MG.solver, mg_min_size=16))
FRAMES = 3


def test_text_frames_on_2x2_blocks_match_jax():
    cfg = TEXT_MG
    scn, st = build_scenario(ranks.TEXT, cfg, device="cpu")
    _build.PLAIN_CALLS.clear()
    got = block_frames(cfg, scn, st, 2, 2, FRAMES)
    per = 4 * FRAMES * cfg.max_substeps
    assert [_build.PLAIN_CALLS[k] for k in ("K1", "S1", "K7", "P5", "P4")] \
        == [per] * 4 + [0]
    assert_frame(cfg, got, jax_frames(cfg, scn, st, FRAMES), FRAME_ATOL)


def test_dam_break_frames_on_4_row_blocks_match_jax():
    cfg = DAM_MG
    scn, st = ranks.developed(ranks.FRAME_CFG, ranks.FRAME_DEVELOP)
    _build.PLAIN_CALLS.clear()
    got = block_frames(cfg, scn, st, 4, 1, FRAMES)
    per = 4 * FRAMES * cfg.max_substeps
    assert [_build.PLAIN_CALLS[k] for k in ("K1", "K7", "P5", "P4")] == \
        [per] * 3 + [0]
    assert_frame(cfg, got, jax_frames(cfg, scn, st, FRAMES), FRAME_ATOL)


class _Comm:
    """A block's place without a group (the plan reads sizes and ranks)."""

    def __init__(self, y, x, ry=0, rx=0):
        self.shape, self.at = (y, x), (ry, rx)

    def size(self, axis):
        return self.shape[axis == "x"]

    def rank(self, axis):
        return self.at[axis == "x"]


@pytest.mark.parametrize("size,blocks,gather,at", [
    ((1024, 1024), (2, 2), 3, (1, 1)),   # 1024², 512², 256² on the blocks
    ((1024, 1024), (4, 1), 3, (3, 0)),
    ((1024, 1024), (1, 1), 3, (0, 0)),
    ((1080, 1920), (2, 1), 2, (1, 0)),   # blocks of 540 rows: 135 at level 2
    ((1080, 1920), (2, 2), 2, (0, 1)),
    ((1080, 1920), (8, 1), 0, (3, 0)),   # blocks of 135 rows
    ((999, 999), (3, 3), 0, (1, 2)),     # 333², the grid's level 0 padded
])
def test_block_plan(size, blocks, gather, at):
    """The gather level: P3's coarse cluster launch level (128² at 1024²,
    126² at 999², 68 x 120 at 1080 x 1920; mg_min_size 32), or the first
    level where a block's extent is odd, level 0 where a side of the
    block is; the block's offset there."""
    _check_plan(size, blocks, gather, at, "float32",
                4 if size[0] == 1080 else 3)


@pytest.mark.parametrize("size,blocks,gather,at", [
    ((1024, 1024), (2, 2), 4, (1, 1)),   # 128² on the blocks too
    ((1024, 1024), (1, 1), 4, (0, 0)),
    ((1080, 1920), (2, 1), 2, (1, 0)),
    ((1080, 1920), (8, 1), 0, (3, 0)),
])
def test_block_plan_f64(size, blocks, gather, at):
    """The gather level in f64: P3-f64's coarse cluster launch level, one
    lower than f32's at 1024² (64²: the 9 planes of 64² and 32² in f64,
    368,640 bytes, do not fit a CTA's 227 KiB), the same at 1080 x 1920
    (68 x 120: 183,600 bytes below it); the blocks of an odd extent
    gather where f32's do."""
    _check_plan(size, blocks, gather, at, "float64", 4)


def _check_plan(size, blocks, gather, at, dtype, fused):
    Y, X = size
    cfg = dataclasses.replace(_config(Y, X), solver=dataclasses.replace(
        _config(Y, X).solver, mg_min_size=32, dtype=dtype))
    y, x = blocks
    comm = _Comm(y, x, *at)
    axes = ("y", "x") if x > 1 else ("y",)
    plan = smg.block_plan(cfg, comm, axes)
    assert plan.gather == gather
    assert smg.fused_level(cfg, plan.shapes) == fused
    rows, cols = Y // y, (X // x if x > 1 else X)
    assert plan.block_shape(gather) == (rows >> gather, cols >> gather)
    assert plan.offset(gather) == (at[0] * rows >> gather,
                                   at[1] * cols >> gather)


def test_block_plan_refusals():
    """A grid of one MG level raises ValueError; blocks of an odd side,
    refused before they gathered at level 0, gather there (any gather
    level above 0 is refused)."""
    cfg = _config(54, 64)
    assert smg.block_plan(cfg, _Comm(2, 1), ("y",)).gather == 0
    with pytest.raises(ValueError, match="gather level 1: 0 .. 0"):
        smg.block_plan(cfg, _Comm(2, 1), ("y",), gather=1)
    small = _config(32, 16, mg_min_size=32)
    with pytest.raises(ValueError, match="one level"):
        smg.block_plan(small, _Comm(2, 1), ("y",))
