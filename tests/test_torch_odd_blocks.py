"""MG on blocks with an odd side, against the JAX package's single-device
functions, on in-process `comm.LocalGroup` blocks on the CPU (the plain
versions of P4 and P5; mg_min_size 8, JAX compiles nothing larger than
81 x 64):
  * halo.py's block MG (block-Jacobi additive Schwarz) on 3 row blocks of
    27 rows of an 81 x 64 system, so each block's level 0 is padded to 28
    rows: one application on each block within 1e-5 of scale of JAX
    `cycle_galerkin` on that block's JAX hierarchy, and the solve within
    1e-4 of scale of the composite JAX reference (JAX `pcg_loop` with
    JAX `apply_a` and those cycles block by block), iterations within 1;
  * the frame on 2 x 4 blocks of 20 x 25 cells (so the global MG solve,
    P5, gathers at level 0): scenarios/waterfall.txt at 40 x 100 with
    bench.py's MG (f32 Galerkin + Chebyshev, tol_rel 1e-4, warm start), 2
    frames against JAX `step_frame_jit`: counts, alive, RNG and drops
    exact, u and v within 2e-3 (tests/test_torch_global_mg.py's frame
    tolerance).
The global MG solve's hierarchy, cycle and solve on blocks of an odd side
are in tests/test_torch_global_mg.py (layouts 108x64_4x1 and 81x66_3x2).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from euler_tpu.ops import multigrid as jmg
from euler_tpu.ops import project as jproject
from euler_tpu_torch import cli
from euler_tpu_torch.config import SimConfig, SolverConfig
from euler_tpu_torch.core.scenario import load_scenario
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.project import pressure_matrix_diag
from euler_tpu_torch.parallel import halo
from euler_tpu_torch.parallel.comm import LocalGroup

from torch_parity import assert_frame, block_frames, jax_config, jax_frames

Y, X, BLOCKS = 81, 64, 3  # 3 row blocks of 27 rows
MIN_SIZE = 8


def _config(tol: float = 1e-4) -> SimConfig:
    return SimConfig(nx=X, ny=Y, solver=SolverConfig(
        max_iterations=600, tol=tol, dtype="float32", preconditioner="mg",
        mg_min_size=MIN_SIZE))


@functools.lru_cache(maxsize=None)
def _system():
    """(b f32, a_diag, fluid) as numpy: an 81 x 64 tank with a solid bar
    (tests/test_halo.py:18-49's system, 17 rows taller), b from seed 0."""
    rng = np.random.default_rng(0)
    fluid = np.zeros((Y, X), bool)
    fluid[1:-1, 1:-1] = True
    solid = np.zeros((Y, X), bool)
    solid[20:24, 5:50] = True
    solid[50:53, 30:60] = True
    fluid &= ~solid
    b = (rng.standard_normal((Y, X)) * fluid).astype(np.float32)
    a = pressure_matrix_diag(_config(), torch.as_tensor(solid),
                             torch.as_tensor(fluid)).numpy()
    return b, a, fluid


@functools.lru_cache(maxsize=None)
def _jax_block_cycle():
    """JAX `cycle_galerkin` on each block's own JAX hierarchy (its level 0
    padded to 28 rows), masked by fluid, as a function of one block's
    (a, fluid, r)."""
    s = _config().solver

    def cycle(a, fl, r):
        levels = jmg.build_galerkin_hierarchy(a, fl, jnp.float32,
                                              min_size=s.mg_min_size)
        assert levels[0].c.shape == (Y // BLOCKS + 1, X)
        z = jmg.cycle_galerkin(
            levels, r, pre=s.mg_pre_smooth, post=s.mg_post_smooth,
            coarse_iters=s.mg_coarse_iters,
            w=2 if s.mg_cycle == "w" else 1, smoother=s.mg_smoother,
            cheby_degree=s.mg_cheby_degree, cheby_ratio=s.mg_cheby_ratio,
            coarse_ratio=s.mg_coarse_ratio, w_depth=s.mg_w_depth)
        return jnp.where(fl, z, 0)

    return cycle


def _split(a):
    return jnp.stack(jnp.split(a, BLOCKS, axis=0))


def test_block_mg_application_on_padded_blocks_matches_jax():
    """One application of the block-MG preconditioner on each of the 3
    blocks of 27 rows: the port's `block_preconditioner` against JAX
    `cycle_galerkin` on the block's JAX hierarchy, within 1e-5 of the
    result's scale (f32; the levels' sums round apart)."""
    cfg = _config()
    b, a, fl = _system()
    want = np.asarray(jax.jit(jax.vmap(_jax_block_cycle()))(
        _split(jnp.asarray(a)), _split(jnp.asarray(fl)),
        _split(jnp.asarray(b))))
    Yl = Y // BLOCKS
    for k in range(BLOCKS):
        rows = slice(k * Yl, (k + 1) * Yl)
        precon = halo.block_preconditioner(
            cfg, torch.as_tensor(a[rows]), torch.as_tensor(fl[rows]),
            torch.float32)
        got = precon(torch.as_tensor(b[rows])).numpy()
        scale = np.abs(want[k]).max()
        assert got.shape == (Yl, X) and scale > 0
        np.testing.assert_allclose(got, want[k], atol=1e-5 * scale, rtol=0)


def test_block_mg_solve_on_padded_blocks_matches_jax():
    """The block-MG solve on the 3 blocks (f32, tol 1e-4) through
    `make_sharded_pressure_solver`: against the composite JAX reference,
    p within 1e-4 of its scale and iterations within 1; the same
    iterations and residual on every block, one plain P4 call a block."""
    cfg = _config()
    b, a, fl = _system()
    jcfg = jax_config(cfg, interpret=False)
    cycle = jax.vmap(_jax_block_cycle())

    def solve(b, a, fl):
        def precon(r):
            return cycle(_split(a), _split(fl), _split(r)).reshape(Y, X)

        return jproject.pcg_loop(jcfg, b, lambda s: jproject.apply_a(
            a, fl, s), precon)

    jp, jit, _ = jax.jit(solve)(*(jnp.asarray(v) for v in (b, a, fl)))
    Yl = Y // BLOCKS

    def rank(comm):
        rows = slice(comm.rank("y") * Yl, (comm.rank("y") + 1) * Yl)
        fn = halo.make_sharded_pressure_solver(cfg, comm, stats=True)
        return fn(*(torch.as_tensor(v[rows]) for v in (b, a, fl)))

    before = _build.PLAIN_CALLS["P4"]
    with LocalGroup(BLOCKS, 1, device="cpu") as g:
        out = g.run(rank)
    assert _build.PLAIN_CALLS["P4"] == before + BLOCKS
    assert len({(int(o[1]), float(o[2])) for o in out}) == 1
    p = torch.cat([o[0] for o in out]).numpy()
    scale = np.abs(np.asarray(jp)).max()
    assert abs(int(out[0][1]) - int(jit)) <= 1 and int(jit) > 0
    assert float(out[0][2]) <= cfg.solver.tol
    np.testing.assert_allclose(p, np.asarray(jp), atol=1e-4 * scale, rtol=0)


FRAMES = 2
FRAME_ATOL = 2e-3


def test_waterfall_frames_on_2x4_odd_blocks_match_jax():
    """scenarios/waterfall.txt at 40 x 100 on 2 x 4 blocks of 20 x 25
    cells with the converged MG solve: the global solve (P5's plain
    version) gathers at level 0, every substep a plain P5 call a block
    and no P4; 2 frames against JAX `step_frame_jit`."""
    cfg = cli.build_config(cli.parse_args(["scenarios/waterfall.txt"]))
    cfg = dataclasses.replace(cfg, solver=SolverConfig(
        max_iterations=100, dtype="float32", tol_rel=1e-4,
        preconditioner="mg", warm_start=True, mg_min_size=MIN_SIZE))
    assert (cfg.ny, cfg.nx) == (40, 100)
    scn, st = load_scenario("scenarios/waterfall.txt", cfg, device="cpu")
    _build.PLAIN_CALLS.clear()
    got = block_frames(cfg, scn, st, 2, 4, FRAMES)
    per = 8 * FRAMES * cfg.max_substeps
    assert [_build.PLAIN_CALLS[k] for k in ("K1", "S1", "K7", "P5", "P4")] \
        == [per] * 4 + [0]
    assert_frame(cfg, got, jax_frames(cfg, scn, st, FRAMES), FRAME_ATOL)
