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
from euler_tpu_torch.core import presets, state
from euler_tpu_torch.ops.cuda import _build

REPO = Path(__file__).resolve().parents[1]
MODULES = [
    "euler_tpu_torch.sim",
    "euler_tpu_torch.convert",
    "euler_tpu_torch.core.presets",
    "euler_tpu_torch.ops.cuda._build",
    "euler_tpu_torch.ops.cuda.marker_fused_kernel",
    "euler_tpu_torch.ops.cuda.grid_kernel",
    "euler_tpu_torch.ops.cuda.substep_kernel",
    "euler_tpu_torch.ops.cuda.mg_kernel",
    "euler_tpu_torch.ops.cuda.mg_stream_kernel",
    "euler_tpu_torch.ops.cuda.pcg_kernel",
    "euler_tpu_torch.ops.cuda.pcg_stream_kernel",
    "euler_tpu_torch.ops.color",
    "euler_tpu_torch.ops.project",
]
ENTRY_POINTS = [presets.dam_break, presets.block_obstacles, presets._finish,
                state.zeros_state, convert.state_from_numpy,
                convert.scenario_from_numpy]


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


def test_default_device_without_a_card_raises():
    """No silent CPU fallback: torch's own error when there is no card."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the test covers GPU-less hosts")
    from euler_tpu_torch.config import SimConfig

    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        presets.dam_break(SimConfig(nx=32, ny=32, marker_layout="slots"))
