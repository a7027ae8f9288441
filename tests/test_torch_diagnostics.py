"""The diagnostics (`euler_tpu_torch/utils/diagnostics.py`) against the
JAX package's (`euler_tpu/utils/diagnostics.py`), on the CPU:

  * `dump_octave_matrix` writes the same text for seeded f32 and i32
    arrays, `dump_pressure_system` the same for a waterfall state carried
    across with `convert`;
  * the NaN trap (the CLI's --sherlock): a clean 2-frame run raises
    nothing in either package, a state with one NaN in u raises
    FloatingPointError in both (JAX: `jax_debug_nans` on the jitted
    frame's outputs; the port: the check at the frame's end); with the
    switch off the port's frame does not read the device;
  * `StepTimer`'s arithmetic, and `profiler_trace` writing a trace.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from euler_tpu.core.scenario import build_scenario as jbuild
from euler_tpu.core.state import FluidState, Scenario
from euler_tpu import sim as jsim
from euler_tpu.utils import diagnostics as jdiag
from euler_tpu_torch import cli, convert, sim
from euler_tpu_torch.config import SimConfig, SolverConfig
from euler_tpu_torch.core.scenario import build_scenario
from euler_tpu_torch.utils import diagnostics

from helpers import read_scenario
from torch_parity import jax_config

torch.set_num_threads(1)

CFG = SimConfig(solver=SolverConfig(max_iterations=100))
WATERFALL = read_scenario("waterfall.txt")


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_dump_octave_matrix_matches_jax(dtype):
    rng = np.random.default_rng(7)
    m = (rng.standard_normal((5, 7)) * 1e3).astype(dtype)
    want = jdiag.dump_octave_matrix("m", m)
    assert diagnostics.dump_octave_matrix("m", m) == want
    assert diagnostics.dump_octave_matrix("m", torch.from_numpy(m)) == want


@pytest.mark.parametrize("layout", ["global", "slots"])
def test_dump_pressure_system_matches_jax(layout):
    cfg = (CFG if layout == "global" else
           cli.build_config(cli.parse_args(["scenarios/waterfall.txt"])))
    jcfg = jax_config(cfg, interpret=False)
    scn, st = build_scenario(WATERFALL, cfg, device="cpu")
    st = sim.step_frame(cfg, scn, st)
    # the JAX function on the port's state, carried across
    jst = FluidState(**{k: jax.numpy.asarray(v) for k, v in
                        convert.state_to_numpy(st).items()})
    jscn = Scenario(**{k: jax.numpy.asarray(v) for k, v in
                       convert.scenario_to_numpy(scn).items()})
    dt = 0.0123
    want = jdiag.dump_pressure_system(jcfg, jscn, jst, dt)
    got = diagnostics.dump_pressure_system(cfg, scn, st, dt)
    assert got.count("# name:") == 3 and "nan" not in got
    assert got == want


@pytest.fixture
def traps():
    """Turns the NaN trap on in both packages when called, and off after
    the test even when it fails (xdist workers outlive a file)."""
    def on():
        jdiag.enable_fpmath_asserts()
        diagnostics.enable_fpmath_asserts()

    try:
        yield on
    finally:
        jax.config.update("jax_debug_nans", False)
        diagnostics._fpmath_asserts = False


def _with_nan(st):
    """`st` with a NaN in u at a fluid cell in the middle of the water,
    as a numpy dict (either package's state is made from it)."""
    arrays = convert.state_to_numpy(st)
    ys, xs = np.nonzero(arrays["marker_count"] > 0)
    arrays["u"] = arrays["u"].copy()
    arrays["u"][ys[len(ys) // 2], xs[len(xs) // 2]] = np.nan
    return arrays


def test_fpmath_asserts_match_jax(traps):
    cfg = CFG
    jcfg = jax_config(cfg, interpret=False)
    scn, st = build_scenario(WATERFALL, cfg, device="cpu")
    jscn, jst = jbuild(WATERFALL, jcfg)
    arrays = _with_nan(st)
    bad = convert.state_from_numpy(arrays, device="cpu", layout="global")
    jbad = FluidState(**{k: jax.numpy.asarray(v) for k, v in arrays.items()})
    traps()
    with pytest.raises(FloatingPointError, match="nan.*: u"):
        sim.step_frame(cfg, scn, bad)
    # the JAX frame jitted anew with the flag on, as the JAX CLI sets it
    # before its first frame: jax checks a jitted call's outputs on its
    # first call, not always on its cached fast path after that
    with pytest.raises(FloatingPointError):
        jax.jit(jsim.step_frame, static_argnums=0)(jcfg, jscn, jbad)
    jstep_frame = jax.jit(jsim.step_frame, static_argnums=0)
    for _ in range(2):  # a clean run raises nothing
        st = sim.step_frame(cfg, scn, st)
        jst = jstep_frame(jcfg, jscn, jst)
    assert int(st.frame_count) == int(jst.frame_count) == 2
    with pytest.raises(FloatingPointError):
        sim.step_frame_stats(cfg, scn, bad)
    with pytest.raises(FloatingPointError):
        sim.run_frames(cfg, scn, bad, 1)


def test_fpmath_asserts_off_reads_nothing():
    """With the switch off the frame's check touches nothing (not even
    its argument, so it reads no tensor on the host), and a frame of NaN
    passes through unchecked."""
    diagnostics.check_frame(None)
    cfg = CFG
    scn, st = build_scenario(WATERFALL, cfg, device="cpu")
    bad = convert.state_from_numpy(_with_nan(st), device="cpu",
                                   layout="global")
    out = sim.step_frame(cfg, scn, bad)
    assert torch.isnan(out.u).any()


def test_fpmath_asserts_names_each_field(traps):
    traps()
    _, st = build_scenario(WATERFALL, CFG, device="cpu")
    diagnostics.check_frame(st)
    st = st.replace(v=st.v.clone(), p=st.p.clone())
    st.v[3, 4] = float("nan")
    st.p[5, 6] = float("nan")
    with pytest.raises(FloatingPointError, match=r"v, p$"):
        diagnostics.check_frame(st)


def test_step_timer_arithmetic(monkeypatch):
    clock = [100.0]
    monkeypatch.setattr(diagnostics.time, "perf_counter", lambda: clock[0])
    cfg = SimConfig(nx=64, ny=32, max_substeps=4)
    t = diagnostics.StepTimer(cfg)
    assert t.frames_per_sec == 0.0
    clock[0] = 102.0
    t.tick()
    t.tick(3)
    assert t.frames == 4
    assert t.frames_per_sec == 2.0
    assert t.cell_steps_per_sec == 2.0 * 64 * 32 * 4
    assert t.summary() == "4 frames, 2.00 fps, 1.64e+04 cell-steps/s"
    assert t.summary() == jdiag.StepTimer.summary(t)


def test_profiler_trace_writes_a_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with diagnostics.profiler_trace(logdir=logdir) as d:
        assert d == logdir
        torch.ones(64).add_(1.0)
    path = os.path.join(logdir, "trace.json")
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("aten::add_" in e.get("name", "") for e in events)
