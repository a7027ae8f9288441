"""The port stands alone: it imports neither jax nor euler_tpu, builds no
kernel at import, and `chip_smoke.py` refuses to run without a GPU.  Its
entry points put their tensors on the card unless the caller asks for the
CPU, with no fallback."""

import inspect
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from euler_tpu_torch import convert
from euler_tpu_torch.core import presets, scenario, state
from euler_tpu_torch.io import checkpoint
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.parallel import comm, mesh, spatial

REPO = Path(__file__).resolve().parents[1]
MODULES = [
    "euler_tpu_torch.sim",
    "euler_tpu_torch.convert",
    "euler_tpu_torch.core.presets",
    "euler_tpu_torch.ops.cuda._build",
    "euler_tpu_torch.ops.cuda.marker_fused_kernel",
    "euler_tpu_torch.ops.cuda.marker_kernel",
    "euler_tpu_torch.ops.cuda.rebin_kernel",
    "euler_tpu_torch.ops.cuda.grid_kernel",
    "euler_tpu_torch.ops.cuda.substep_kernel",
    "euler_tpu_torch.ops.cuda.mg_kernel",
    "euler_tpu_torch.ops.cuda.mg_stream_kernel",
    "euler_tpu_torch.ops.cuda.pcg_kernel",
    "euler_tpu_torch.ops.cuda.pcg_stream_kernel",
    "euler_tpu_torch.ops.cuda.source_kernel",
    "euler_tpu_torch.ops.cuda.global_marker_kernel",
    "euler_tpu_torch.ops.cuda.pcg_general_kernel",
    "euler_tpu_torch.ops.cuda.pcg_shard_kernel",
    "euler_tpu_torch.ops.markers",
    "euler_tpu_torch.ops.ic0",
    "euler_tpu_torch.ops.color",
    "euler_tpu_torch.ops.project",
    "euler_tpu_torch.core.rng",
    "euler_tpu_torch.core.scenario",
    "euler_tpu_torch.models",
    "euler_tpu_torch.render.ansi",
    "euler_tpu_torch.render.downsample",
    "euler_tpu_torch.render.terminal",
    "euler_tpu_torch.native",
    "euler_tpu_torch.native.encoder",
    "euler_tpu_torch.io.checkpoint",
    "euler_tpu_torch.cli",
    "euler_tpu_torch.parallel.batch",
    "euler_tpu_torch.parallel.spatial",
    "euler_tpu_torch.parallel.mesh",
    "euler_tpu_torch.parallel.cuda_shard",
    "euler_tpu_torch.parallel.dryrun",
    "euler_tpu_torch.parallel.comm",
    "euler_tpu_torch.parallel.halo",
    "euler_tpu_torch.utils.diagnostics",
]
ENTRY_POINTS = [presets.dam_break, presets.block_obstacles, presets._finish,
                state.zeros_state, convert.state_from_numpy,
                convert.scenario_from_numpy, scenario.build_scenario,
                scenario.load_scenario, checkpoint.load, mesh.make_mesh,
                spatial.spatial_mesh, comm.LocalGroup]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        f"for m in {MODULES!r}:\n"
        "    __import__(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'euler_tpu' or "
        "m.startswith('euler_tpu.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "[]"


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env={**os.environ, "PYTHONPATH": ""},
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the test covers GPU-less hosts")
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "build" not in out.stdout  # failed before any kernel build
    for line in out.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_build_fails_loudly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


@pytest.mark.parametrize("case", ["cpu", "meta", "dtype", "shape",
                                  "strided"])
def test_wrappers_check_their_tensors(case):
    t = {
        "cpu": torch.zeros(4, 4),
        "meta": torch.zeros(4, 4, device="meta"),
        "dtype": torch.zeros(4, 4, dtype=torch.float64, device="meta"),
        "shape": torch.zeros(4, 5, device="meta"),
        "strided": torch.zeros(4, 8, device="meta")[:, ::2],
    }[case]
    match = {"cpu": "CUDA", "meta": "CUDA", "dtype": "dtype",
             "shape": "shape", "strided": "contiguous"}[case]
    with pytest.raises((TypeError, ValueError), match=match):
        _build.require(t, "x", torch.float32, (4, 4))


@pytest.mark.parametrize("fn", ENTRY_POINTS, ids=lambda f: f.__name__)
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_models_load_defaults_to_the_jax_config():
    """`models.load` with no config builds the JAX package's default
    `SimConfig()`: the global layout, a [2, 4 Y X] store."""
    from euler_tpu_torch import models
    from euler_tpu_torch.config import SimConfig

    scn, st = models.load("basic", device="cpu")
    cfg = SimConfig()
    assert cfg.marker_layout == "global"
    assert tuple(st.markers.shape) == (2, cfg.max_markers)
    assert tuple(st.alive.shape) == (cfg.max_markers,)


def test_default_device_without_a_card_raises():
    """No silent CPU fallback: torch's own error when there is no card."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the test covers GPU-less hosts")
    from euler_tpu_torch.config import SimConfig

    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        presets.dam_break(SimConfig(nx=32, ny=32, marker_layout="slots"))


@pytest.mark.parametrize("entry", ["scenario", "cli", "cli_no_pallas"])
def test_scenarios_and_cli_default_to_the_card(entry):
    """A text scenario, and the CLI without --cpu (--no-pallas too), go to
    the card: torch's own error when there is none, no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the test covers GPU-less hosts")
    if entry == "scenario":
        from euler_tpu_torch.config import SimConfig

        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            scenario.load_scenario(str(REPO / "scenarios/basic.txt"),
                                   SimConfig(marker_layout="slots"))
        return
    extra = ["--no-pallas"] if entry == "cli_no_pallas" else []
    out = subprocess.run(
        [sys.executable, "-m", "euler_tpu_torch", "scenarios/basic.txt",
         "--frames", "1", *extra], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA" in out.stderr and "frames/s" not in out.stdout
