"""RB-GS and rediscretized MG on one card (P3's RB-GS form and P7) on the
CPU: the JAX package's `mg_smoother="rbgs"` and `mg_scheme=
"rediscretize"`, which it solves at every size in its jnp `pcg_loop`
with `make_mg_preconditioner` (every Pallas MG gate refuses them), against
the port's routes and their plain versions.

Against the JAX package (four jitted compiles: the hierarchies, the
transfers and the cycles; the four solves; the frames of each setting):
  * the rediscretized hierarchy (masks, a_diag, inv_diag) bit for bit at
    63 x 99 with mg_min_size 8 (odd levels), f32 and f64;
  * `_restrict`, `_prolong` and one f64 `v_cycle` within 1e-12 of scale,
    and one f64 RB-GS Galerkin cycle (`cycle_galerkin` with smoother
    "rbgs") within 1e-12 of scale;
  * the plain solve of each setting against `solve_pressure` (use_pallas
    False) at 63 x 99: iterations within 1, p within 5e-4 of scale (f32)
    and 1e-8 of scale (f64);
  * 3 frames of a 64² dam break with each setting against `step_frame`:
    counts, alive and drops exact, u and v within 5e-3.
Without JAX compiles: the V-cycle linear and symmetric (JAX's own
`test_vcycle_linear_and_symmetric`); the routes P3 / P7 at 64², 1024²,
1080 x 1920 and 2048², never K2, K3 or K11; the workspace keys of a
Chebyshev and an RB-GS config apart; `python -m euler_tpu_torch --load`
of a 40 x 100 checkpoint whose config is RB-GS MG runs a headless frame
on the CPU, bitwise the frame stepped here.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.ops import multigrid as jmg
from euler_tpu.ops import project as jproject
from euler_tpu.ops.pallas import mg_kernel as jmgk
from euler_tpu.ops.pallas import mg_stream_kernel as jms
from euler_tpu.ops.pallas import pcg_kernel as jpcg
from euler_tpu.ops.pallas import pcg_stream_kernel as jps
from euler_tpu.sim import _use_fused_substep as j_use_fused_substep
from euler_tpu.sim import step_frame as jstep_frame
from euler_tpu_torch import cli, convert, sim
from euler_tpu_torch.core.presets import dam_break
from euler_tpu_torch.io import checkpoint
from euler_tpu_torch.ops import multigrid as tmg
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda import mg_kernel as tmgk
from euler_tpu_torch.ops.cuda import pcg_general_kernel as tp3
from euler_tpu_torch.ops.project import (
    make_preconditioner,
    pressure_matrix_diag,
    solve_pressure,
    solver_route,
)

from torch_parity import jax_config, jax_state, n, port_config, t

REPO = Path(__file__).resolve().parents[1]
# the two settings: (solver change, the port's solve)
SETTINGS = {"rbgs": (dict(mg_smoother="rbgs"), "P3"),
            "rediscretize": (dict(mg_scheme="rediscretize"), "P7")}
SHAPE = (63, 99)   # rediscretized: 63 x 99, 32 x 50, 16 x 25, 8 x 13
DTYPES = {"f32": "float32", "f64": "float64"}


def _config(kind, Y=SHAPE[0], X=SHAPE[1], min_size=8, dtype="float64",
            **solver):
    cfg = port_config(64)
    solver = {**SETTINGS[kind][0], "dtype": dtype, "mg_min_size": min_size,
              **solver}
    return dataclasses.replace(cfg, ny=Y, nx=X, solver=dataclasses.replace(
        cfg.solver, **solver))


def _system(Y, X, seed=0):
    """A dam-break-like fluid with speckles inside a solid wall, the
    solid mask, a_diag, and a seeded f64 RHS on the fluid."""
    rng = np.random.default_rng(seed)
    fluid = np.zeros((Y, X), bool)
    fluid[2:int(Y * 0.6), 2:int(X * 0.55)] = True
    fluid |= rng.random((Y, X)) < 0.08
    fluid[[0, -1], :] = fluid[:, [0, -1]] = False
    solid = np.zeros((Y, X), bool)
    solid[1, 1:-1] = solid[1:-1, 1] = solid[1:-1, X - 2] = True
    solid |= (rng.random((Y, X)) < 0.03) & ~fluid
    fluid &= ~solid
    a = n(pressure_matrix_diag(_config("rbgs", Y, X), t(solid), t(fluid)))
    b = np.where(fluid, rng.standard_normal((Y, X)), 0.0)
    return fluid, solid, a, b


@pytest.fixture(scope="module")
def jax_ops():
    """Compile 1: the JAX rediscretized hierarchy of SHAPE (mg_min_size 8)
    in f32 and f64, `_restrict` and `_prolong` of seeded f64 planes, one
    f64 `v_cycle` and one f64 RB-GS Galerkin cycle, in one jit."""
    fluid, solid, a, b = _system(*SHAPE)
    rng = np.random.default_rng(7)
    fine = rng.standard_normal(SHAPE)
    coarse = rng.standard_normal(((SHAPE[0] + 1) // 2, (SHAPE[1] + 1) // 2))
    s = _config("rbgs").solver
    jcfg = jax_config(_config("rbgs"), interpret=False)

    @jax.jit
    def ops(fluid, solid, a, b, fine, coarse):
        lv = {d: jmg.build_hierarchy(solid, fluid, d, min_size=8)
              for d in (jnp.float32, jnp.float64)}
        z_v = jmg.v_cycle(lv[jnp.float64], b, pre=s.mg_pre_smooth,
                          post=s.mg_post_smooth,
                          coarse_iters=s.mg_coarse_iters)
        z_g = jmg.make_mg_preconditioner(jcfg, solid, fluid, jnp.float64,
                                         a_diag=a)(b)
        return (lv[jnp.float32], lv[jnp.float64], jmg._restrict(fine),
                jmg._prolong(coarse, SHAPE), z_v, z_g)

    out = ops(*(jnp.asarray(v) for v in (fluid, solid, a, b, fine,
                                         coarse)))
    return (fluid, solid, a, b, fine, coarse), jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rediscretized_hierarchy_exact(jax_ops, dtype):
    """`build_hierarchy` (the plain version of P7's build) against the
    JAX one at 63 x 99, mg_min_size 8: the level plan
    (`rediscretized_shapes`), fluid, a_diag and inv_diag bit for bit."""
    (fluid, solid, *_), out = jax_ops
    want = out[0] if dtype == "f32" else out[1]
    f = getattr(torch, DTYPES[dtype])
    got = tmg.build_hierarchy(t(solid), t(fluid), f, min_size=8)
    assert [tuple(lv.fluid.shape) for lv in got] == \
        tmgk.rediscretized_shapes(*SHAPE, 8) == \
        [(63, 99), (32, 50), (16, 25), (8, 13)]
    assert len(got) == len(want)
    for lg, lw in zip(got, want):
        assert lg.inv_diag.dtype == f and lg.a_diag.dtype == torch.int32
        for name in ("fluid", "a_diag", "inv_diag"):
            np.testing.assert_array_equal(n(getattr(lg, name)),
                                          np.asarray(getattr(lw, name)),
                                          err_msg=name)
    assert n(got[-1].fluid).any()


@pytest.mark.parametrize("op", ["restrict", "prolong"])
def test_transfers_match_jax(jax_ops, op):
    """The bilinear restriction (odd input, zero-padded) and prolongation
    (cropped to 63 x 99) within 1e-12 of scale in f64."""
    (*_, fine, coarse), out = jax_ops
    if op == "restrict":
        got, want = tmg._restrict(t(fine)), out[2]
    else:
        got, want = tmg._prolong(t(coarse), SHAPE), out[3]
    assert tuple(got.shape) == want.shape and got.dtype == torch.float64
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(n(got), want, atol=1e-12 * scale, rtol=0)


@pytest.mark.parametrize("kind", list(SETTINGS))
def test_cycle_f64_matches_jax(jax_ops, kind):
    """One f64 cycle of `make_preconditioner` (the plain step of P7: a
    `v_cycle`; of P3 with RB-GS: `cycle_galerkin`) against the JAX one,
    within 1e-12 of scale."""
    (fluid, solid, a, b, *_), out = jax_ops
    want = out[4] if kind == "rediscretize" else out[5]
    got = make_preconditioner(_config(kind), t(a), t(fluid), t(solid))(t(b))
    assert got.dtype == torch.float64 and tuple(got.shape) == SHAPE
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(n(got), want, atol=1e-12 * scale, rtol=0)


def test_vcycle_linear_and_symmetric():
    """The port's `v_cycle` is a fixed symmetric linear operator (PCG needs
    it): <x, M y> = <M x, y> to 1e-10, M(x + 2y) = M x + 2 M y to 1e-9."""
    fluid, solid, _, _ = _system(*SHAPE, seed=4)
    levels = tmg.build_hierarchy(t(solid), t(fluid), torch.float64,
                                 min_size=8)
    f = functools.partial(tmg.v_cycle, levels)
    rng = np.random.default_rng(1)
    x = t(rng.standard_normal(SHAPE) * fluid)
    y = t(rng.standard_normal(SHAPE) * fluid)
    lhs, rhs = float((x * f(y)).sum()), float((f(x) * y).sum())
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)
    np.testing.assert_allclose(n(f(x + 2.0 * y)), n(f(x) + 2.0 * f(y)),
                               rtol=1e-9, atol=1e-12)


SOLVES = [f"{kind}_{dt}" for kind in SETTINGS for dt in DTYPES]
# (p's atol over its scale) of the plain solve against JAX's
SOLVE_ATOL = {"f32": 5e-4, "f64": 1e-8}


@pytest.fixture(scope="module")
def solves():
    """Compile 2: the JAX `solve_pressure` (use_pallas False: its
    `pcg_loop` with `make_mg_preconditioner`) of each setting in f32
    (tol_rel 1e-4) and f64 (tol 1e-10) at 63 x 99, mg_min_size 16, in one
    jit; and the port's solves beside them (its plain versions here)."""
    fluid, solid, a, b = _system(*SHAPE, seed=2)
    cfgs = {}
    for kind in SETTINGS:
        cfgs[f"{kind}_f32"] = _config(kind, min_size=16, dtype="float32")
        cfgs[f"{kind}_f64"] = _config(kind, min_size=16, tol=1e-10,
                                      tol_rel=1e-10)
    names = tuple(cfgs)
    jcfgs = tuple(jax_config(cfgs[k], interpret=False) for k in names)

    @functools.partial(jax.jit, static_argnums=0)
    def four(jcfgs, b, a, fluid, solid):
        return [jproject.solve_pressure(
            c, b.astype(getattr(jnp, c.solver.dtype)), a, fluid, solid)
            for c in jcfgs]

    jout = dict(zip(names, four(jcfgs, *(jnp.asarray(v) for v in (
        b, a, fluid, solid)))))
    port = {}
    for k, cfg in cfgs.items():
        kind = k.rsplit("_", 1)[0]
        assert solver_route(cfg) == SETTINGS[kind][1]
        before = dict(_build.PLAIN_CALLS)
        bt = t(b).to(getattr(torch, cfg.solver.dtype))
        port[k] = solve_pressure(cfg, bt, t(a), t(fluid), t(solid))
        name = SETTINGS[kind][1]
        assert _build.PLAIN_CALLS[name] == before.get(name, 0) + 1
    return port, jout


@pytest.mark.parametrize("case", SOLVES)
def test_plain_solve_matches_jax(solves, case):
    """The plain solve of P3 with RB-GS and of P7 against the JAX solve:
    iterations within 1, p within 5e-4 (f32) or 1e-8 (f64) of scale."""
    port, jout = solves
    p, it, _ = port[case]
    jp, jit, _ = jout[case]
    dt = case.rsplit("_", 1)[1]
    assert p.dtype == getattr(torch, DTYPES[dt])
    scale = float(np.abs(np.asarray(jp)).max())
    assert scale > 0
    np.testing.assert_allclose(n(p), np.asarray(jp),
                               atol=SOLVE_ATOL[dt] * scale, rtol=0)
    assert abs(int(it) - int(jit)) <= 1 and int(it) > 0


@pytest.mark.parametrize("kind", list(SETTINGS))
@pytest.mark.parametrize("size", ["64x64", "1024x1024", "1080x1920",
                                  "2048x2048"])
def test_route(kind, size):
    """The CLI's converged mode with each setting: no JAX Pallas gate
    opens (fused substep, K8, K3, K11, K12), so the JAX chain falls
    through to its jnp loop, and the port runs P3 / P7 after K7, never
    K2, K3 or K11, and `check_slice` passes."""
    cfg = cli.build_config(cli.parse_args(["preset:dam_break", "--size",
                                           size, "--converged"]))
    assert cfg.solver.preconditioner == "mg"
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, **SETTINGS[kind][0]))
    jcfg = jax_config(cfg)
    scn = type("Scn", (), {"num_sources": 0})()
    assert not j_use_fused_substep(jcfg, scn)
    assert not any(g(jcfg) for g in (jpcg.pallas_solver_fits,
                                     jmgk.mg_pallas_fits,
                                     jms.stream_mg_fits,
                                     jps.stream_solver_fits))
    assert solver_route(cfg) == SETTINGS[kind][1]
    assert sim.route(cfg, scn) == ("plain", SETTINGS[kind][1])
    assert not tmgk.galerkin_cheby(cfg)
    sim.check_slice(cfg, scn)


def test_workspace_keys_apart():
    """P3's workspace cache key holds the scheme, the smoother and its
    sweeps: a Chebyshev config and an RB-GS config of one grid (and a
    rediscretized one, and RB-GS with 2 pre-sweeps) get four workspaces,
    not one."""
    cheby = _config("rbgs", mg_smoother="cheby")
    cfgs = [cheby, _config("rbgs"), _config("rediscretize"),
            _config("rbgs", mg_pre_smooth=2)]
    keys = {tp3.workspace_key(c, "cuda:0") for c in cfgs}
    assert len(keys) == 4


FRAMES = 3


@pytest.fixture(scope="module", params=list(SETTINGS))
def frames(request):
    """Compiles 3 and 4: 3 frames of the 64² dam break (the main path's
    config with the setting: K1, K7 and P3 / P7 a substep) on the CPU and
    by the JAX package (jnp marker pass; its jnp `pcg_loop` with the MG
    preconditioner), from the same numpy state."""
    kind = request.param
    cfg = port_config(64)
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, **SETTINGS[kind][0]))
    scn, st = dam_break(cfg, device="cpu")
    jscn, jst = jax_state((convert.scenario_to_numpy(scn),
                           convert.state_to_numpy(st)))
    jcfg = dataclasses.replace(jax_config(cfg, interpret=False),
                               use_pallas_markers=False)
    step = jax.jit(jstep_frame, static_argnums=0)
    _build.PLAIN_CALLS.clear()
    out = []
    for _ in range(FRAMES):
        st, stats = sim.step_frame_stats(cfg, scn, st)
        jst = step(jcfg, jscn, jst)
        out.append((convert.state_to_numpy(st), jst, int(stats["pcg_iters"])))
    return kind, cfg, scn, out, dict(_build.PLAIN_CALLS)


@pytest.mark.parametrize("frame", range(FRAMES))
def test_frames_match_jax(frames, frame):
    """Counts, the alive plane and the drops exact; u, v within 5e-3 (the
    largest difference seen is printed)."""
    kind, cfg, scn, out, _ = frames
    got, jst, iters = out[frame]
    for k in ("marker_count", "dropped_markers", "alive_count", "alive"):
        np.testing.assert_array_equal(
            got[k], np.asarray(getattr(jst, k)).reshape(np.shape(got[k])),
            err_msg=k)
    diff = {k: float(np.abs(got[k] - np.asarray(getattr(jst, k))).max())
            for k in ("u", "v")}
    print(f"{kind} frame {frame}: max |du| {diff['u']:.3g}, |dv| "
          f"{diff['v']:.3g}")
    assert max(diff.values()) <= 5e-3, diff
    assert iters > 0 and np.abs(got["p"]).max() > 0


def test_frames_route(frames):
    """The frames ran K1, K7 and P3 / P7 (their plain versions here) once
    a substep, and no fused kernel, K3 or other solve."""
    kind, cfg, scn, out, calls = frames
    name = SETTINGS[kind][1]
    assert sim.route(cfg, scn) == ("plain", name)
    assert set(calls) == {"K1", "K7", name}
    assert calls[name] == calls["K7"] == cfg.max_substeps * FRAMES


def test_cli_load_rbgs_checkpoint(tmp_path):
    """`python -m euler_tpu_torch --load` of a 40 x 100 checkpoint whose
    config is RB-GS MG: the config travels in the checkpoint, the
    headless frame runs on the CPU's plain versions (P3 with RB-GS), and
    its state is bitwise the frame stepped here."""
    cfg = cli.build_config(cli.parse_args(["preset:dam_break", "--size",
                                           "40x100", "--converged"]))
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, **SETTINGS["rbgs"][0]))
    assert sim.route(cfg, type("Scn", (), {"num_sources": 0})())[1] == "P3"
    scn, st = dam_break(cfg, device="cpu")
    ck, out_ck = tmp_path / "rbgs.npz", tmp_path / "next.npz"
    checkpoint.save(str(ck), cfg, scn, st)
    loaded_cfg, _, _ = checkpoint.load(str(ck), device="cpu")
    assert loaded_cfg.solver == cfg.solver
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "euler_tpu_torch", "--load", str(ck),
         "--frames", "1", "--cpu", "--checkpoint", str(out_ck)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith(
        "1 frames (100x40)")
    _, _, resumed = checkpoint.load(str(out_ck), device="cpu")
    on = sim.step_frame(cfg, scn, st)
    for k, v in convert.state_to_numpy(on).items():
        assert convert.state_to_numpy(resumed)[k].tobytes() == v.tobytes(), k
