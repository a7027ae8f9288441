"""The frame's global IC(0) solve on ("y", "x") blocks
(`euler_tpu_torch/parallel/spatial_ic0.py`; P6's plain version, as
`solve_pressure_blocks_ic0` runs it on CPU tensors), against the JAX
package's single-device functions, which its frame on blocks runs under
GSPMD (`parallel/spatial.py:113`: the jnp `pcg_loop` with
`make_ic0_preconditioner` over the whole grid).

In-process blocks (`comm.LocalGroup`) on the CPU; the solver is the
golden configuration's with IC(0) (f64, cap 400, tol 1e-6):
  * the staged sweeps on 2 x 2, 4 x 1 and 1 x 2 blocks of a 64²
    dam-break system, f64 and f32: E_inv and z = M^-1 r, gathered, bit
    for bit the port's `make_ic0_preconditioner` on the whole grid, and z
    within tests/test_torch_ic0.py's tolerances of JAX's (1e-12 of scale
    in f64, 1e-5 in f32);
  * the solve against JAX `solve_pressure` (use_pallas=False, IC(0)),
    cold, warm and with a zero RHS: iterations within 1 (0 on a zero
    RHS), p within 1e-9 of scale in f64 and 5e-4 in f32 (to tol_rel
    1e-4; the pinned tolerances of tests/test_torch_global_project.py);
    on 1 x 1 blocks the port's single-device solve (P1 + P2's plain
    version) bit for bit;
  * `make_spatial_step` with IC(0) on 2 x 2 blocks of tests/
    test_spatial.py's 32 x 16 text and on 4 row blocks of the 64² dam
    break, against JAX `step_frame_jit` (`torch_parity.assert_frame`).
The gloo ranks' case (`make_sharded_step` with IC(0) on 2 x 2 ranks) is
in tests/test_torch_col_blocks.py; halo.py's own solver, which runs
Jacobi for IC(0), in tests/test_torch_halo.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.ops import ic0 as jic0
from euler_tpu.ops import project as jproject
from euler_tpu_torch import sim
from euler_tpu_torch.config import SolverConfig
from euler_tpu_torch.core.scenario import build_scenario
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda.grid_kernel import grid_stage_plain
from euler_tpu_torch.ops.cuda.pcg_general_kernel import (
    solve_pressure_general_plain,
)
from euler_tpu_torch.ops.forces import max_speed_sq
from euler_tpu_torch.ops.ic0 import make_ic0_preconditioner
from euler_tpu_torch.ops.project import divergence_rhs, pressure_matrix_diag
from euler_tpu_torch.parallel import spatial_ic0
from euler_tpu_torch.parallel.comm import LocalGroup
from euler_tpu_torch.parallel.spatial_mg import gather_plane

import torch_shard_ranks as ranks
from torch_parity import assert_frame, block_frames, jax_config, jax_frames

IC0 = SolverConfig(dtype="float64", preconditioner="ic0", max_iterations=400)
N = 64


def _config(dtype="float64"):
    return dataclasses.replace(ranks.FRAME_CFG, solver=dataclasses.replace(
        IC0, dtype=dtype))


@functools.lru_cache(maxsize=None)
def _system(dtype="float64"):
    """(cfg, b, a_diag, fluid, solid, p0): a substep's own system of the
    64² dam break developed by tests/torch_shard_ranks.py (the RHS of the
    advected velocities), in `dtype`, and the state's pressure, masked,
    as the warm start."""
    cfg = _config(dtype)
    scn, st = ranks.developed(ranks.FRAME_CFG, ranks.FRAME_DEVELOP)
    dt = sim._dt_from_msq(cfg, max_speed_sq(cfg, st.u, st.v),
                          torch.tensor(cfg.frame_time))
    ut, vt = grid_stage_plain(cfg, dt, st.u, st.v, st.fluid, st.prev_fluid,
                              scn.solid)
    b = divergence_rhs(cfg, ut, vt, st.fluid, dt).to(getattr(torch, dtype))
    a_diag = pressure_matrix_diag(cfg, scn.solid, st.fluid)
    p0 = torch.where(st.fluid, st.p, 0.0).to(b.dtype)
    return cfg, b, a_diag, st.fluid, scn.solid, p0


def _run(y, x, fn):
    """fn(comm, cut, axes) on y x x in-process blocks of the 64² grid,
    every block's result in rank order."""
    Yl, Xl = N // y, N // x

    def rank(comm):
        ry, rx = comm.rank("y"), comm.rank("x")
        cut = (slice(ry * Yl, (ry + 1) * Yl), slice(rx * Xl, (rx + 1) * Xl))
        return fn(comm, cut, ("y", "x") if x > 1 else ("y",))

    with LocalGroup(y, x, device="cpu") as g:
        return g.run(rank)


@functools.lru_cache(maxsize=None)
def _jax_z(dtype):
    _, b, a_diag, fluid, _, _ = _system(dtype)
    a, fl = jnp.asarray(a_diag.numpy()), jnp.asarray(fluid.numpy())
    return np.asarray(jax.jit(lambda a, fl, r: jic0.make_ic0_preconditioner(
        a, fl, jnp.dtype(dtype))(r))(a, fl, jnp.asarray(b.numpy())))


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-12),
                                        ("float32", 1e-5)])
@pytest.mark.parametrize("layout", [(2, 2), (4, 1), (1, 2)])
def test_sweeps_match_the_whole_grid_bitwise(layout, dtype, rtol):
    cfg, b, a_diag, fluid, _, _ = _system(dtype)
    before = _build.PLAIN_CALLS["P6"]

    def fn(comm, cut, axes):
        e_inv, z = spatial_ic0.precondition_blocks(
            cfg, comm, axes, a_diag[cut].contiguous(),
            fluid[cut].contiguous(), b[cut].contiguous())
        return gather_plane(e_inv, comm, axes), gather_plane(z, comm, axes)

    e_inv, z = _run(*layout, fn)[0]
    assert _build.PLAIN_CALLS["P6"] == before + layout[0] * layout[1]
    whole = make_ic0_preconditioner(a_diag, fluid, b.dtype)
    want = whole(b)
    assert torch.equal(e_inv, whole.e_inv) and bool(e_inv.any())
    assert torch.equal(z, want)
    jz = _jax_z(dtype)
    scale = float(np.abs(jz).max())
    assert scale > 0
    np.testing.assert_allclose(z.numpy(), jz, rtol=0, atol=rtol * scale)


@pytest.fixture(scope="module")
def jax_solve():
    """The JAX `solve_pressure` (use_pallas False: `pcg_loop` with
    `make_ic0_preconditioner`), always given a guess: x0 = 0 is bitwise
    its cold start (p = 0, r = b - A 0 = b)."""
    return jax.jit(jproject.solve_pressure, static_argnums=0)


def _solve(cfg, b, a_diag, fluid, x0, layout):
    """The IC(0) solve on the blocks: (p gathered, iterations, residual),
    the same on every block."""
    def fn(comm, cut, axes):
        out = spatial_ic0.solve_pressure_blocks_ic0(
            cfg, comm, axes, b[cut].contiguous(), a_diag[cut].contiguous(),
            fluid[cut].contiguous(),
            None if x0 is None else x0[cut].contiguous())
        return gather_plane(out[0], comm, axes), int(out[1]), float(out[2])

    out = _run(*layout, fn)
    assert len({o[1:] for o in out}) == 1
    return out[0]


@pytest.mark.parametrize("layout,case,dtype", [
    ((2, 2), "cold", "float64"), ((2, 2), "warm", "float64"),
    ((2, 2), "zero", "float64"), ((4, 1), "cold", "float32")])
def test_solve_matches_jax(layout, case, dtype, jax_solve):
    """f32 solves to tol_rel 1e-4 (the main path's): at the golden tol
    1e-6 this RHS (max |b| 11.9) stops at f32's rounding floor (residual
    ~5.6e-7), where the count depends on the rounding, on one device too
    (the port's P1 + P2 plain version 41 iterations, JAX 46)."""
    cfg, b, a_diag, fluid, solid, p0 = _system(dtype)
    if dtype == "float32":
        cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, tol_rel=1e-4))
    if case == "zero":
        b = torch.zeros_like(b)
    x0 = p0 if case == "warm" else None
    before = _build.PLAIN_CALLS["P6"]
    p, it, res = _solve(cfg, b, a_diag, fluid, x0, layout)
    assert _build.PLAIN_CALLS["P6"] == before + layout[0] * layout[1]
    jp, jit, jres = jax_solve(
        jax_config(cfg, interpret=False),
        *(jnp.asarray(v.numpy()) for v in (b, a_diag, fluid, solid)),
        jnp.asarray((torch.zeros_like(b) if x0 is None else x0).numpy()))
    if case == "zero":
        assert it == int(jit) == 0 and not p.any()
        return
    scale = float(np.abs(np.asarray(jp)).max())
    close = 1e-9 if dtype == "float64" else 5e-4
    np.testing.assert_allclose(p.numpy(), np.asarray(jp),
                               atol=close * scale, rtol=0)
    assert abs(it - int(jit)) <= 1 and it > 1
    tol = max(cfg.solver.tol, cfg.solver.tol_rel * float(b.abs().max()))
    assert res <= tol and float(jres) <= tol


def test_one_block_is_the_single_device_solve_bitwise():
    """On 1 x 1 blocks the solve is the port's single-device one (P1 + P2's
    plain version) bit for bit: p, iterations, residual."""
    cfg, b, a_diag, fluid, _, p0 = _system()
    for x0 in (None, p0):
        p, it, res = _solve(cfg, b, a_diag, fluid, x0, (1, 1))
        want = solve_pressure_general_plain(cfg, b, a_diag, fluid, x0)
        assert torch.equal(p, want[0]) and it == int(want[1])
        assert res == float(want[2])


TEXT_IC0 = dataclasses.replace(ranks.TEXT_CFG, solver=IC0)


def test_text_frames_on_2x2_blocks_match_jax():
    cfg = TEXT_IC0
    scn, st = build_scenario(ranks.TEXT, cfg, device="cpu")
    _build.PLAIN_CALLS.clear()
    got = block_frames(cfg, scn, st, 2, 2, ranks.TEXT_STEPS)
    per = 4 * ranks.TEXT_STEPS * cfg.max_substeps
    assert [_build.PLAIN_CALLS[k] for k in ("K1", "S1", "K7", "P6", "P4")] \
        == [per] * 4 + [0]
    assert_frame(cfg, got, jax_frames(cfg, scn, st, ranks.TEXT_STEPS))


def test_dam_break_frames_on_4_row_blocks_match_jax():
    cfg = _config()
    scn, st = ranks.developed(ranks.FRAME_CFG, ranks.FRAME_DEVELOP)
    _build.PLAIN_CALLS.clear()
    got = block_frames(cfg, scn, st, 4, 1, ranks.FRAME_STEPS)
    per = 4 * ranks.FRAME_STEPS * cfg.max_substeps
    assert [_build.PLAIN_CALLS[k] for k in ("K1", "K7", "P6", "P4")] == \
        [per] * 3 + [0]
    assert_frame(cfg, got, jax_frames(cfg, scn, st, ranks.FRAME_STEPS))


def test_solve_refuses_another_preconditioner():
    cfg = dataclasses.replace(_config(), solver=dataclasses.replace(
        IC0, preconditioner="jacobi"))
    with pytest.raises(ValueError, match="preconditioner='ic0'"):
        spatial_ic0.solve_pressure_blocks_ic0(cfg, None, ("y",), None, None,
                                              None)


def test_p6_refuses_a_gloo_group():
    """P6 does not copy to the host: a gloo group with CUDA tensors
    raises before anything launches."""
    from euler_tpu_torch.ops.cuda import pcg_ic0_blocks_kernel as p6

    class Gloo:
        backend = "gloo"

    with pytest.raises(RuntimeError, match="not gloo"):
        p6.solve_ic0_blocks(_config(), Gloo(), ("y",), None, None, None)
