"""`python -m euler_tpu_torch`, the port's CLI: the configuration it
builds equals the JAX CLI's `_build` with --pallas and with --no-pallas;
a headless run (with --no-pallas too), a checkpointed run and its resume
as subprocesses on the CPU; the interactive run through a
pseudo-terminal, keys p, f and q, as tests/test_cli.py drives the JAX
CLI; a headless run with --sherlock."""

import dataclasses
import os
import pty
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from euler_tpu import cli as jcli
from euler_tpu_torch import cli, convert
from euler_tpu_torch.io import checkpoint

REPO = Path(__file__).resolve().parents[1]
LINE = re.compile(r"^(\d+) frames \((\d+)x(\d+)\) in [0-9.]+s = [0-9.]+ "
                  r"frames/s, [0-9.e+]+ cell-steps/s")


class _Built(Exception):
    pass


@pytest.mark.parametrize("pallas", ["--pallas", "--no-pallas"])
@pytest.mark.parametrize("argv", [
    [], ["--size", "1024x1024"], ["--rainbow"],
    ["--size", "64x128", "--converged"], ["--size", "600x600",
                                          "--no-converged"],
    ["--size", "40x99", "--rainbow"]])
@pytest.mark.parametrize("scenario", ["scenarios/waterfall.txt",
                                      "preset:dam_break"])
def test_config_matches_jax_build(monkeypatch, scenario, argv, pallas):
    seen = {}

    def capture(*args, **kwargs):
        seen["cfg"] = args[1] if len(args) > 1 else args[0]
        raise _Built

    from euler_tpu.core import presets, scenario as jscenario

    monkeypatch.setattr(jscenario, "load_scenario", capture)
    monkeypatch.setattr(presets, "dam_break", capture)
    with pytest.raises(_Built):
        jcli._build(jcli.parse_args([scenario, pallas] + argv))
    cfg = cli.build_config(cli.parse_args([scenario, pallas] + argv))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(seen["cfg"])
    if pallas == "--pallas":  # the port's default
        assert cli.build_config(cli.parse_args([scenario] + argv)) == cfg
    else:
        assert cfg.marker_layout == "global"
        # --cpu keeps the configuration (the JAX CLI's --cpu would not)
        assert cli.build_config(cli.parse_args(
            [scenario, pallas, "--cpu"] + argv)) == cfg


def _env():
    # one intra-op thread: the test run shares the host's cores between
    # several worker processes
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")


def _run(*argv, timeout=300):
    env = _env()
    return subprocess.run([sys.executable, "-m", "euler_tpu_torch", *argv],
                          cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_headless_run():
    out = _run("scenarios/basic.txt", "--frames", "3", "--cpu")
    assert out.returncode == 0, out.stderr
    m = LINE.match(out.stdout.strip().splitlines()[-1])
    assert m and m.groups() == ("3", "100", "40")


def test_checkpoint_and_resume(tmp_path):
    """--checkpoint-every writes from the saver thread; --load resumes,
    and the resumed run's state equals the uninterrupted one's."""
    ck = tmp_path / "run.npz"
    out = _run("scenarios/waterfall.txt", "--frames", "2", "--cpu",
               "--checkpoint", str(ck), "--checkpoint-every", "1")
    assert out.returncode == 0, out.stderr
    cfg, scn, st = checkpoint.load(str(ck), device="cpu")
    # the warm-up frame is discarded: 2 frames from the scenario
    assert int(st.frame_count) == 2
    ck2 = tmp_path / "resumed.npz"
    out = _run("--load", str(ck), "--frames", "1", "--cpu",
               "--checkpoint", str(ck2))
    assert out.returncode == 0, out.stderr
    _, _, resumed = checkpoint.load(str(ck2), device="cpu")
    from euler_tpu_torch import sim

    on = sim.step_frame(cfg, scn, st)
    for k, v in convert.state_to_numpy(on).items():
        assert convert.state_to_numpy(resumed)[k].tobytes() == v.tobytes(), k
    assert int(resumed.frame_count) == 3


def test_no_pallas_headless_run():
    """--no-pallas: the global layout and the Jacobi budget, 3 frames of
    filter.txt on the CPU's plain versions."""
    out = _run("scenarios/filter.txt", "--no-pallas", "--frames", "3",
               "--cpu")
    assert out.returncode == 0, out.stderr
    m = LINE.match(out.stdout.strip().splitlines()[-1])
    assert m and m.groups() == ("3", "100", "40")


def test_sherlock_headless_run():
    """--sherlock (the NaN trap) on a clean run: exit 0, the usual line."""
    out = _run("scenarios/basic.txt", "--frames", "2", "--cpu", "--sherlock")
    assert out.returncode == 0, out.stderr
    m = LINE.match(out.stdout.strip().splitlines()[-1])
    assert m and m.groups() == ("2", "100", "40")


def _drain(fd, timeout=0.3, max_wall=2.0):
    import select

    out = b""
    end = time.time() + max_wall
    while time.time() < end:
        r, _, _ = select.select([fd], [], [], timeout)
        if not r:
            break
        try:
            chunk = os.read(fd, 65536)
        except OSError:
            break
        if not chunk:
            break
        out += chunk
    return out


@pytest.mark.parametrize("size", [None, "120x300"])
def test_interactive_renders_and_quits(size):
    """The TUI on a 30 x 110 pty: frames repaint (the full frame, or the
    pooled one for a grid larger than the window), blue water shows,
    p / f / q work and q exits 0."""
    import fcntl
    import struct
    import termios

    master, slave = pty.openpty()
    fcntl.ioctl(slave, termios.TIOCSWINSZ, struct.pack("HHHH", 30, 110, 0, 0))
    env = _env()
    argv = ["scenarios/basic.txt", "--cpu", "--fps", "30"]
    if size:
        argv = ["preset:dam_break", "--cpu", "--fps", "30", "--size", size]
    proc = subprocess.Popen([sys.executable, "-m", "euler_tpu_torch", *argv],
                            stdin=slave, stdout=slave,
                            stderr=subprocess.PIPE, env=env, cwd=REPO)
    os.close(slave)
    try:
        out = b""
        deadline = time.time() + 120
        while time.time() < deadline:
            out += _drain(master, timeout=1.0)
            if out.count(b"\x1b[?25l") >= 2:
                break
        assert out.count(b"\x1b[?25l") >= 2, "no frame repaint seen"
        assert b"\x1b[34m" in out, "no blue water run seen"
        assert b"o" in out or b"O" in out or b"0" in out, "no water glyphs"
        for key in (b"p", b"f", b"q"):
            os.write(master, key)
            _drain(master, max_wall=0.5)
        deadline = time.time() + 30
        while proc.poll() is None and time.time() < deadline:
            _drain(master, timeout=0.2, max_wall=0.5)
        assert proc.returncode == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
        os.close(master)
