"""Debug and observability utilities (`euler_tpu/utils/diagnostics.py`).

The reference's equivalents:
  * debug-inl.h:18-85: Octave-format dumps of the pressure matrix and
    grids;
  * the SHERLOCK build option, enable_fpmath_asserts (misc/debug.c:4-10):
    trap on NaN.  The JAX package maps it to `jax_debug_nans`, which
    raises when a jitted frame's outputs hold a NaN; here a switch that
    `sim.step_frame` reads makes the frame's end check its output state;
  * no profiling beyond frame pacing: here step timing and a
    torch.profiler trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import os
import tempfile
import time

import numpy as np
import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.ops.project import divergence_rhs, pressure_matrix_diag

_fpmath_asserts = False


def enable_fpmath_asserts() -> None:
    """SHERLOCK equivalent (misc/debug.c:4-10): from now on every frame
    (`sim.step_frame`, `step_frame_stats`, `run_frames`) checks the
    floating tensors of the state it returns and raises
    FloatingPointError naming each that holds a NaN.  As with the JAX
    package's `jax_debug_nans` only a frame's outputs are checked: the
    unfused projections make NaN on inactive substeps on purpose and the
    frame loop's select discards it.  The check reads the device once a
    frame; with the switch off a frame reads nothing on the host.  As in
    the JAX package there is no call that turns it off again; tests set
    `_fpmath_asserts` back to False."""
    global _fpmath_asserts
    _fpmath_asserts = True


def check_frame(state) -> None:
    """Raise FloatingPointError if the switch is on and a floating tensor
    of `state` holds a NaN (one device-to-host read); else nothing."""
    if not _fpmath_asserts:
        return
    names = [f.name for f in dataclasses.fields(state)
             if getattr(state, f.name).is_floating_point()]
    bad = torch.stack([torch.isnan(getattr(state, n)).any()
                       for n in names]).tolist()
    nans = [n for n, b in zip(names, bad) if b]
    if nans:
        raise FloatingPointError(
            f"invalid value (nan) in the frame's output: {', '.join(nans)}")


def dump_octave_matrix(name: str, m, out=None) -> str:
    """Octave text format, as debug-inl.h:18-30 intended: `repr(float(v))`
    of each value.  `m` is a 2-D numpy array or tensor."""
    if isinstance(m, torch.Tensor):
        m = m.detach().cpu().numpy()
    m = np.asarray(m)
    buf = out or io.StringIO()
    buf.write(f"# name: {name}\n# type: matrix\n")
    buf.write(f"# rows: {m.shape[0]}\n# columns: {m.shape[1]}\n")
    for row in m:
        buf.write(" " + " ".join(repr(float(v)) for v in row) + "\n")
    return buf.getvalue() if out is None else ""


def dump_pressure_system(cfg: SimConfig, scn, state, dt) -> str:
    """The Poisson system (A diagonal, fluid mask, RHS) as Octave text,
    the working replacement for debug-inl.h:33-70.  Computed on the
    state's device and copied to the host once: the three planes as one
    f64 tensor, which holds the i32 diagonal and mask and the f32 or f64
    RHS exactly, so each `float(v)` is the one of the plane's own
    dtype."""
    fluid = state.fluid
    a = pressure_matrix_diag(cfg, scn.solid, fluid)
    b = divergence_rhs(cfg, state.u, state.v, fluid, dt)
    host = torch.stack([a.to(torch.float64), fluid.to(torch.float64),
                        b.to(torch.float64)]).cpu().numpy()
    out = io.StringIO()
    for name, plane in zip(("a_diag", "fluid", "b"), host):
        dump_octave_matrix(name, plane, out)
    return out.getvalue()


class StepTimer:
    """Frames/s and cell-steps/s counter.  The rates are frames ticked
    over host seconds since the timer was made; where CUDA is in use in
    the process, reading a rate first waits for the card
    (`torch.cuda.synchronize`), since frames are queued, not finished,
    when `step_frame` returns: without the wait a rate would count queued
    frames."""

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self.frames = 0
        self.t0 = time.perf_counter()

    def tick(self, n: int = 1):
        self.frames += n

    @property
    def frames_per_sec(self) -> float:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - self.t0
        return self.frames / dt if dt > 0 else 0.0

    @property
    def cell_steps_per_sec(self) -> float:
        return (
            self.frames_per_sec
            * self.cfg.nx
            * self.cfg.ny
            * self.cfg.max_substeps
        )

    def summary(self) -> str:
        return (
            f"{self.frames} frames, {self.frames_per_sec:.2f} fps, "
            f"{self.cell_steps_per_sec:.3g} cell-steps/s"
        )


@contextlib.contextmanager
def profiler_trace(logdir: str | None = None):
    """torch.profiler over a block of steps, CPU and (where this torch
    has it) CUDA activity; on exit a Chrome trace is written to
    `logdir`/trace.json (`logdir` defaults to euler_tpu_torch_trace in
    the temporary directory).  Yields `logdir`."""
    from torch.profiler import ProfilerActivity, profile

    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "euler_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
            if a in torch.profiler.supported_activities()]
    with profile(activities=acts) as prof:
        yield logdir
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
