#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`euler_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile PREFIX]

Builds the port's CUDA kernels from `euler_tpu_torch/csrc/` (nvcc, sm_90a,
one process per source, all at once, into build/euler_tpu_torch/), then:
  1. checks the main path end to end at 64², and the same with each other
     marker route (`fuse_marker_pass=False`: K5 + K6;
     `marker_padded_store`: K4): the port on the GPU (kernels) against the
     port on the CPU (plain PyTorch versions), 2 frames;
  2. builds the 1024² dam break and advances it 4 warm-up frames;
  3. holds each kernel against its plain version on the card, on that
     state: K1 marker pass, K4 padded marker pass, K5 march, K6 re-bin, K2
     substep grid half, K3 MG-PCG solve (cold, warm, and capped at 3
     iterations, which it must take exactly; the Galerkin hierarchy and
     Chebyshev rows it builds bitwise equal to `mg_host_operands`; its
     coarse cycle in one launch a visit bitwise equal to one launch per
     level operation), K7 grid
     stage, K8 Jacobi-PCG solve, K9 Jacobi projection, K10 Jacobi substep;
  4. times 20 frames of the main path (dam break, slot markers K=8,
     Galerkin MG-PCG to tol_rel 1e-4 with warm start, fused projection);
  5. times 20 frames of the Jacobi speed mode (`bench.py --precon
     jacobi`: 100 iterations, tol 1e-6, tol_rel 1e-6, no warm start) after
     4 warm-up frames;
  6. runs the secondary routes, 2 warm-up and 4 timed frames each:
     Jacobi unfused (K8), Jacobi + rainbow (K9), MG + rainbow (K3), Jacobi
     unfused with `use_pallas_grid` (K7, K8), and the main path on the
     three marker routes from the same dam break, `marker_k1` (K1, K2,
     K3), `marker_unfused` (K5, K6, K2, K3) and `padded_store` (K4, K2,
     K3), the last two bitwise equal at their end to the first;
  7. times each kernel beside its plain version with CUDA events;
  8. runs `bench.py --size 2048` (the main path's config at 2048², where
     the JAX package's size gates take the plain grid stage and K11): 2
     warm-up + 4 timed frames, then K11 (F = 2) against its plain version
     on that state, timed;
  9. runs `bench.py --size 4096 --precon jacobi` (the plain grid stage and
     K12): 1 warm-up + 2 timed frames, then K12 and K11 (F = 4, with the
     MG config) against their plain versions on that state, K12 timed.
Each path runs with the launch counts set to 0 just before it and read
just after: its kernels must have launched and no plain version may have
run.  Prints one JSON line of per-kernel results, the card's name and
power limit, and as its last line {"ok": true, "device": {...}}.  Exits
non-zero, with no result, on any failure or when no CUDA device exists.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import subprocess
import sys
import time

SIZE = 1024        # bench.py's default grid (the main path)
WARMUP_FRAMES = 4  # bench.py's default warm-up (early dam-break window)
FRAMES = 20        # timed frames of the main path and the speed mode
ROUTE_WARMUP = 2   # warm-up frames of each secondary route
ROUTE_FRAMES = 4   # timed frames of each secondary route
REPS = 5           # timed calls per kernel and per plain version
LARGE = {          # size: (preconditioner, warm-up frames, timed frames,
    2048: ("mg", 2, 4, 3),          # timed calls per kernel)
    4096: ("jacobi", 1, 2, 2),
}

SLOTS = 8          # slots_per_cell of every path here

# The H100 SXM's published peaks (NVIDIA data sheet, 700 W): HBM bytes/s
# and f32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# What each kernel must do at least, per cell of the [Y, X] grid (n
# cells), from the sources: bytes with every input read once and every
# output written once, and f32 operations.  `iters` is the PCG iteration
# count the timed call needed; `live` the live markers of K1's store.
#   grid stage + RHS + tail (extrapolate, two bilinear samples per face
#   component, gravity, divergence, clamp, face update, maxsq): ~100 flops
#   a Jacobi-PCG iteration: 5-point apply 7, two dot products 4, two
#   axpys 4, preconditioner and direction update 3, max|r| 1: 20 flops
#   an MG-PCG iteration: the level-0 sweeps (~40) plus the coarse levels'
#   truncated-W visits (~20): 60 flops
#   a marker step: two bilinear samples and the position update: 28 flops
#   a re-bin test of a live marker (two scalings, floors, offsets): 6 flops
#   the grid stage alone (K7: extrapolate, four bilinear samples, gravity):
#   ~70 flops
# A Jacobi-PCG iteration's three sweeps move 14 [Y, X] f32 planes
# (csrc/jacobi_pcg.cu): the HBM time of that traffic is the sweep bound
# of K8-K10, an upper bound on their floor (the live planes fit the L2).
# K12's two sweeps move 13 planes an iteration (pcg_stream_kernel.py:19),
# K11's four fine sweeps 17 (mg_stream_kernel.py:25-26).  K3 and K2 (the
# MG-PCG main path): `mg_sweep_planes` counts an iteration of the cycle
# schedule at the main path's level shapes, and SWEEP_CALL_PLANES what a
# call moves once (head, hierarchy, warm start, tail).


def mg_sweep_planes(size: int = 1024, min_size: int = 32, w: int = 2,
                    w_depth: int = 2):
    """(per iteration, hierarchy build) traffic of the degree-1 MG-PCG
    (csrc/mg_levels.cuh, csrc/mg_pcg.cu) in [Y, X] f32 plane equivalents:
    each operation reads its input planes once and writes its outputs
    once, a level-l plane counting 4^-l.  The operator is 1 plane at
    level 0 (packed) and 3 above (c, e, n).  Per visit of level l:
    pre-smooth + restriction (b, A in; x, b_c out), a restriction per
    extra visit (b, x, A in; b_c out), a prolongation per visit (z_c, x in,
    x out, and the packed plane at level 0), the post-smooth (b, x, A in;
    z out); the coarsest solve (b, c, e, n in; x out); and at level 0 the
    PCG step (z, s, As, packed in, s, As out; p, r, s, As in, p, r out).
    At 1024² (six levels, W at levels 0 and 1): level 0 29 planes, level 1
    2 x 21 level-1 planes (10.5), level 2 4 x 13.5 (3.375), level 3
    (0.84), level 4 (0.21), level 5 4 x 5 (0.02): ~43.95 planes, 184 MB.
    The hierarchy: level 0's Gershgorin pass (1), then per coarse level
    the finer level's operator and active flags in and its own out."""
    sizes = [size]
    while sizes[-1] > min_size:
        sizes.append(sizes[-1] // 2)
    L = len(sizes)

    def cycle(l):
        s = 4.0 ** -l
        if l == L - 1:
            return 5 * s
        a = 1 if l == 0 else 3
        visits = w if (l < w_depth and l + 1 < L - 1) else 1
        own = ((2 + a + 0.25) + (visits - 1) * (2 + a + 0.25)
               + visits * (2.25 + (1 if l == 0 else 0)) + (3 + a))
        return own * s + visits * cycle(l + 1)

    hier = 1 + sum((1 if l == 0 else 3.25 * 4.0 ** -l)
                   + 3.25 * 4.0 ** -(l + 1) for l in range(L - 1))
    return cycle(0) + 12, hier


SWEEP_PLANES = {"K8": 14, "K9": 14, "K10": 14, "K11": 17, "K12": 13,
                "K3": mg_sweep_planes()[0], "K2": mg_sweep_planes()[0]}
# once a call, besides the hierarchy: K3's head (a_diag i32 and fluid u8
# in, packed out: 2.25; b and x0 copied in: 4), init (r in, s and As out:
# 3), warm start (mask 3, residual 4), p copied out (2); K2's grid passes
# (A 4.75, B 4.5), RHS (6.5), init 3, warm start 7, tail (clamp 2.25,
# face update 5.5)
SWEEP_CALL_PLANES = {"K3": 18.25 + mg_sweep_planes()[1],
                     "K2": 33.5 + mg_sweep_planes()[1]}
GRID_FLOPS = 100
GRID_STAGE_FLOPS = 70
JACOBI_FLOPS = 20
MG_FLOPS = 60
MARKER_FLOPS = 28
REBIN_FLOPS = 6
BOUNDS = {
    # u, v f32; fluid, solid, dead u8; count i32 in; live positions in
    # and out; count, drop i32 out (K4: the same on the padded store)
    "K1": lambda n, iters, live: (23 * n + 16 * live, MARKER_FLOPS * live),
    "K4": lambda n, iters, live: (23 * n + 16 * live, MARKER_FLOPS * live),
    # u, v f32; fluid, solid u8; count i32 in; the whole store in and out
    # (the dead slots are copied through)
    "K5": lambda n, iters, live: (14 * n + 16 * SLOTS * n,
                                  MARKER_FLOPS * live),
    # alive [K] and dead u8 in; live positions in and out; alive' [K] u8,
    # count, drop i32 out
    "K6": lambda n, iters, live: ((2 * SLOTS + 9) * n + 16 * live,
                                  REBIN_FLOPS * live),
    # u, v, p0 f32; fl, pfl, so u8 in; u2, v2, p f32 out
    "K2": lambda n, iters, live: (27 * n, (GRID_FLOPS + MG_FLOPS * iters) * n),
    # b, x0 f32; a_diag i32; fluid u8 in; p f32 out
    "K3": lambda n, iters, live: (17 * n, MG_FLOPS * iters * n),
    # b f32; a_diag i32; fluid u8 in; p f32 out
    "K8": lambda n, iters, live: (13 * n, JACOBI_FLOPS * iters * n),
    # ut, vt f32; fluid, solid u8 in; u2, v2 f32 out
    "K9": lambda n, iters, live: (
        18 * n, (GRID_FLOPS // 4 + JACOBI_FLOPS * iters) * n),
    # u, v f32; fl, pfl, so u8 in; u2, v2 f32 out
    "K10": lambda n, iters, live: (
        19 * n, (GRID_FLOPS + JACOBI_FLOPS * iters) * n),
    # u, v f32; fl, pfl, so u8 in; ut, vt f32 out
    "K7": lambda n, iters, live: (19 * n, GRID_STAGE_FLOPS * n),
    # b f32; a_diag i32; fluid u8 in; p f32 out
    "K11": lambda n, iters, live: (13 * n, MG_FLOPS * iters * n),
    "K12": lambda n, iters, live: (13 * n, JACOBI_FLOPS * iters * n),
}
KERNELS = {
    "K1": ("marker_pass", "euler_tpu_torch/csrc/marker_pass.cu",
           "euler_tpu/ops/pallas/marker_fused_kernel.py:941"),
    "K4": ("marker_pass_padded", "euler_tpu_torch/csrc/marker_pass.cu",
           "euler_tpu/ops/pallas/marker_fused_kernel.py:1030"),
    "K5": ("marker_march", "euler_tpu_torch/csrc/marker_pass.cu",
           "euler_tpu/ops/pallas/marker_kernel.py:332"),
    "K6": ("marker_rebin", "euler_tpu_torch/csrc/marker_pass.cu",
           "euler_tpu/ops/pallas/rebin_kernel.py:174"),
    "K2": ("substep_grid_stage", "euler_tpu_torch/csrc/grid_stage.cu",
           "euler_tpu/ops/pallas/substep_kernel.py:361"),
    "K3": ("mg_pcg", "euler_tpu_torch/csrc/mg_pcg.cu",
           "euler_tpu/ops/pallas/mg_kernel.py:727"),
    "K7": ("grid_stage", "euler_tpu_torch/csrc/grid_stage.cu",
           "euler_tpu/ops/pallas/grid_kernel.py:205"),
    "K8": ("jacobi_pcg_solve", "euler_tpu_torch/csrc/jacobi_pcg.cu",
           "euler_tpu/ops/pallas/pcg_kernel.py:178"),
    "K9": ("jacobi_project", "euler_tpu_torch/csrc/jacobi_pcg.cu",
           "euler_tpu/ops/pallas/pcg_kernel.py:417"),
    "K10": ("jacobi_substep", "euler_tpu_torch/csrc/jacobi_pcg.cu",
            "euler_tpu/ops/pallas/substep_kernel.py:441"),
    "K11": ("mg_stream_pcg", "euler_tpu_torch/csrc/mg_stream.cu",
            "euler_tpu/ops/pallas/mg_stream_kernel.py:464"),
    "K12": ("jacobi_stream_pcg", "euler_tpu_torch/csrc/jacobi_pcg.cu",
            "euler_tpu/ops/pallas/pcg_stream_kernel.py:266"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Phase:
    """Times one phase and prints its seconds."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"== {self.name}")
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"   {self.name}: {time.perf_counter() - self.t0:.1f} s")
        return False


def main_config(size: int):
    from euler_tpu_torch.config import SimConfig, SolverConfig

    # bench.py's default run: slots K=8, Galerkin MG-PCG, tol_rel 1e-4,
    # warm start, 100-iteration cap, fused projection, no sources, mono
    return SimConfig(
        nx=size, ny=size, marker_layout="slots",
        solver=SolverConfig(max_iterations=100, tol=1e-6, tol_rel=1e-4,
                            dtype="float32", preconditioner="mg",
                            warm_start=True, fuse_projection=True))


def speed_config(size: int, **over):
    """`bench.py --precon jacobi`: the reference's 100-iteration budget,
    tol 1e-6, tol_rel 1e-6, no warm start, fused projection."""
    cfg = main_config(size)
    return dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, preconditioner="jacobi", tol_rel=1e-6,
        warm_start=False), **over)


def marker_configs(cfg):
    """`cfg` on each marker route: {"K1": fused (as given), "K5+K6":
    fuse_marker_pass=False, "K4": marker_padded_store}."""
    return {"K1": cfg,
            "K5+K6": dataclasses.replace(cfg, fuse_marker_pass=False),
            "K4": dataclasses.replace(cfg, marker_padded_store=True)}


def div_inf(cfg, state):
    """max |div u| * h^2 rho on fluid cells after the last projection
    (bench.py's post_projection_div_inf)."""
    import torch

    from euler_tpu_torch.ops.project import divergence_rhs

    one = torch.ones((), dtype=state.u.dtype, device=state.u.device)
    return float(divergence_rhs(cfg, state.u, state.v, state.fluid,
                                one).abs().max())


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def reset_peak() -> int:
    """Reset the peak-memory count; returns the bytes already allocated
    (tensors that earlier phases of this script still hold)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def record_peak(summary: dict, held: int) -> None:
    """Put the peak allocated since `reset_peak` into `summary`, with the
    `held` bytes that were allocated before the path began."""
    import torch

    from euler_tpu_torch.ops.cuda import mg_kernel

    peak = torch.cuda.max_memory_allocated()
    cached = sum(ws.nbytes for ws in mg_kernel._WORKSPACES.values())
    summary["max_memory_allocated"] = peak
    summary["memory_held_before"] = held
    summary["mg_workspace_bytes"] = cached
    log(f"   torch.cuda.max_memory_allocated {peak / 2**30:.3f} GiB, of "
        f"which {held / 2**30:.3f} GiB was held before the path, "
        f"{cached / 2**30:.3f} GiB of it by {len(mg_kernel._WORKSPACES)} "
        f"cached MG workspaces")


def reset_counts() -> None:
    from euler_tpu_torch.ops.cuda import _build

    _build.LAUNCHES.clear()
    _build.PLAIN_CALLS.clear()


def run_path(cfg, scn, state, frames: int, kernels, label: str,
             bypassed=()):
    """Step `frames` frames with the launch counts set to 0 just before
    and read just after; checks that `kernels` launched, that the
    `bypassed` ones and every plain version did not, and that the state
    stayed finite.  Returns (state, summary)."""
    import torch

    from euler_tpu_torch import sim
    from euler_tpu_torch.ops.cuda import _build

    Y, X = cfg.ny, cfg.nx
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    n_active = torch.zeros((), dtype=torch.int32, device=state.u.device)
    pcg_iters = torch.zeros_like(n_active)
    for _ in range(frames):
        state, stats = sim.step_frame_stats(cfg, scn, state)
        n_active += stats["n_active"]
        pcg_iters += stats["pcg_iters"]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    plain = sum(_build.PLAIN_CALLS.values())
    summary = {
        "ms_per_frame": 1e3 * elapsed / frames,
        "cell_steps_per_s": Y * X * cfg.max_substeps * frames / elapsed,
        "active_substeps": int(n_active),
        "pcg_iters_per_active_substep": int(pcg_iters)
        / max(int(n_active), 1),
        "div_inf": div_inf(cfg, state),
        "dropped_markers": int(state.dropped_markers),
        "launches": launches,
    }
    log(f"   {label}: {summary['ms_per_frame']:.3f} ms/frame, "
        f"{summary['cell_steps_per_s']:.4g} cell-steps/s ({Y}x{X} x "
        f"{cfg.max_substeps} substeps x {frames} frames)")
    log(f"   active substeps {summary['active_substeps']} of "
        f"{cfg.max_substeps * frames}; PCG iterations per active substep "
        f"{summary['pcg_iters_per_active_substep']:.2f}; div_inf "
        f"{summary['div_inf']:.4g}; dropped_markers "
        f"{summary['dropped_markers']}; markers "
        f"{int(state.marker_count.sum())}")
    log(f"   launches {launches}; plain-version calls {plain}")
    for k in kernels:
        check(launches.get(k, 0) > 0, f"{label}: {k} did not launch")
    for k in bypassed:
        check(launches.get(k, 0) == 0, f"{label}: {k} launched")
    check(plain == 0, f"{label}: a plain version ran")
    names = ["u", "v", "p", "markers"] + (["r", "g", "b"] if cfg.rainbow
                                          else [])
    for name in names:
        check(bool(torch.isfinite(getattr(state, name)).all()),
              f"{label}: state.{name} not finite")
    check(tuple(state.u.shape) == (Y, X)
          and tuple(state.markers.shape) == (2, cfg.slots_per_cell, Y, X),
          f"{label}: state shapes changed")
    return state, summary


def build_all():
    """Every kernel library, one nvcc per source, started together."""
    from euler_tpu_torch.ops.cuda import _build
    from euler_tpu_torch.ops.cuda import grid_kernel as k7
    from euler_tpu_torch.ops.cuda import marker_fused_kernel as k1
    from euler_tpu_torch.ops.cuda import mg_kernel as k3
    from euler_tpu_torch.ops.cuda import mg_stream_kernel as k11
    from euler_tpu_torch.ops.cuda import pcg_kernel as k89

    loaders = [k1.marker_lib, k7.grid_lib, k3._lib, k11._lib, k89.jacobi_lib]
    with concurrent.futures.ThreadPoolExecutor(len(loaders)) as pool:
        for fut in [pool.submit(f) for f in loaders]:
            fut.result()
    for name, rec in _build.BUILD_LOG.items():
        log(f"   {name}: nvcc {rec['seconds']:.1f} s")
        for line in rec["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"     {line.strip()}")


def time_pair(results, name, kern, plain_fn, n_cells, n_live, reps):
    """Times the kernel and its plain version in turns with CUDA events
    (plain, kernel, kernel, plain) and fills results[name] with the best
    of each and the bound of the kernel's call."""
    out = kern()
    iters = 0 if name in ("K1", "K4", "K5", "K6", "K7") else int(
        out[1] if name in ("K3", "K8", "K11", "K12") else out[2])
    t_p1 = cuda_ms(plain_fn, reps)
    t_k1 = cuda_ms(kern, reps)
    t_k2 = cuda_ms(kern, reps)
    t_p2 = cuda_ms(plain_fn, reps)
    nbytes, flops = BOUNDS[name](n_cells, iters, n_live)
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / F32_FLOP_PER_S
    results.setdefault(name, {}).update(
        ms=min(t_k1, t_k2), plain_ms=min(t_p1, t_p2),
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None)
    log(f"   {name}: kernel {t_k1:.3f} / {t_k2:.3f} ms, plain "
        f"{t_p1:.3f} / {t_p2:.3f} ms; bound "
        f"{results[name]['bound_ms']:.4f} ms by "
        f"{results[name]['bound_by']} ({nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.3f} GFLOP, {iters} iterations, {n_cells} cells)")
    if name in SWEEP_PLANES:
        sweep = 4 * n_cells * (SWEEP_PLANES[name] * iters
                               + SWEEP_CALL_PLANES.get(name, 0))
        log(f"   {name}: sweep bound {1e3 * sweep / HBM_BYTES_PER_S:.3f}"
            f" ms ({sweep / 1e9:.2f} GB over {iters} iterations)")


def check_marker_variants(cfg, scn, state, dt, o_k1, c_k1, d_k1):
    """K5, K6 and K4 against their plain versions on the card, on `state`
    with the substep's `dt`: counts, drops and alive equal, live positions
    bitwise; dt = 0 an identity; K4's interior equal to K1's output
    (o_k1, c_k1, d_k1).  Returns each kernel's max error on the live
    positions (0.0: they are bitwise)."""
    import torch

    from euler_tpu_torch.ops.cuda import marker_fused_kernel as k1
    from euler_tpu_torch.ops.cuda import marker_kernel as k5
    from euler_tpu_torch.ops.cuda import rebin_kernel as k6
    from euler_tpu_torch.ops.markers_slots import live_slots

    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    check(K == SLOTS, f"slots_per_cell {K}: the bounds assume {SLOTS}")
    args = (cfg, state.u, state.v, state.fluid, scn.solid)
    px, py, count = state.markers[0], state.markers[1], state.marker_count
    dead = scn.sink | scn.solid
    zero = torch.zeros_like(dt)

    def live_err(name, got, want, cnt):
        live = live_slots(cnt, K)
        err = max((a - b).abs()[live].max().item()
                  for a, b in zip(got, want))
        whole = all(torch.equal(a, b) for a, b in zip(got, want))
        log(f"   {name}: live positions max err {err:.3g} (bitwise: "
            f"{err == 0.0}; whole store bitwise: {whole})")
        check(err == 0.0, f"{name}: live positions differ from plain")
        return err

    errs = {}
    m_k = k5.advect_markers(*args, px, py, dt, count)
    m_p = k5.advect_markers_plain(*args, px, py, dt, count)
    errs["K5"] = live_err("K5", m_k, m_p, count)
    check(all(torch.equal(a[~state.alive], b[~state.alive])
              for a, b in zip(m_k, (px, py))),
          "K5: dead slots were not copied through")
    m_0 = k5.advect_markers(*args, px, py, zero, count)
    check(torch.equal(m_0[0], px) and torch.equal(m_0[1], py),
          "K5 with dt = 0 is not an identity")
    log("   K5: dead slots copied through; dt = 0 is a bitwise identity")

    r_k = k6.rebin_markers(cfg, m_k[0], m_k[1], state.alive, dead)
    r_p = k6.rebin_markers_plain(cfg, m_k[0], m_k[1], state.alive, dead)
    for i, what in ((2, "alive"), (3, "counts"), (4, "drops")):
        check(torch.equal(r_k[i], r_p[i]), f"K6 {what} differ from plain")
    errs["K6"] = live_err("K6", r_k[:2], r_p[:2], r_p[3])
    check(torch.equal(r_k[3], c_k1) and torch.equal(r_k[4], d_k1)
          and torch.equal(torch.cat(r_k[:2]), o_k1),
          "K5 + K6 differ from K1")
    r_0 = k6.rebin_markers(cfg, px, py, state.alive, dead)
    check(torch.equal(torch.stack(r_0[:2]), state.markers)
          and torch.equal(r_0[2], state.alive) and torch.equal(r_0[3], count)
          and int(r_0[4].sum()) == 0, "K6 on an unmoved store is not an "
          "identity")
    log("   K6: alive, counts, drops equal; K5 + K6 give K1's output bit for "
        "bit; an unmoved store is a bitwise identity")

    store = torch.full((2 * K, Y + 16, X + 256), float("nan"),
                       device=px.device)
    inner = (slice(None), slice(8, 8 + Y), slice(128, 128 + X))
    store[inner] = state.markers.reshape(2 * K, Y, X)
    p_k = k1.march_rebin_padded(*args, store, dt, count, dead=dead)
    p_p = k1.march_rebin_padded_plain(*args, store, dt, count, dead=dead)
    check(torch.equal(p_k[1], p_p[1]), "K4 counts differ from plain")
    check(torch.equal(p_k[2], p_p[2]), "K4 drops differ from plain")
    o4 = p_k[0][inner]
    errs["K4"] = live_err("K4", (o4[:K], o4[K:]),
                          (p_p[0][inner][:K], p_p[0][inner][K:]), p_p[1])
    check(torch.equal(o4, o_k1) and torch.equal(p_k[1], c_k1)
          and torch.equal(p_k[2], d_k1), "K4's interior differs from K1")
    p_0 = k1.march_rebin_padded(*args, store, zero, count, dead=dead)
    check(torch.equal(p_0[0][inner], store[inner])
          and torch.equal(p_0[1], count) and int(p_0[2].sum()) == 0,
          "K4 with dt = 0 is not an identity")
    log("   K4: counts, drops equal (NaN pads); interior equal to K1's "
        "output bit for bit; dt = 0 is a bitwise identity")
    return errs


def run_marker_routes(cfg, summaries, launches, dev, profile_prefix=None):
    """The main path at full size on its three marker routes, K1 (the
    reference), K5+K6 and K4, ROUTE_WARMUP + ROUTE_FRAMES frames each from
    the same dam break: each route's kernels launch 8 times a frame, the
    other marker kernels and every plain version never, and the K5+K6 and
    K4 routes end with counts, drops, u, v, p, alive and live positions
    bitwise equal to the K1 route.  Profiled with a prefix."""
    import torch

    from euler_tpu_torch import sim
    from euler_tpu_torch.core.presets import dam_break
    from euler_tpu_torch.ops.markers_slots import live_slots

    configs = marker_configs(cfg)
    ref = live = None
    for label, route in (("marker_k1", "K1"), ("marker_unfused", "K5+K6"),
                         ("padded_store", "K4")):
        rcfg = configs[route]
        kernels = route.split("+") + ["K2", "K3"]
        others = [k for k in ("K1", "K4", "K5", "K6") if k not in kernels]
        with Phase(f"route {label} {cfg.ny}²: {ROUTE_WARMUP} warm-up + "
                   f"{ROUTE_FRAMES} timed frames"):
            held = reset_peak()
            rscn, rstate = dam_break(rcfg, device=dev)
            check(sim.marker_route(rcfg, rscn) == route,
                  f"{label}: marker route {sim.marker_route(rcfg, rscn)}")
            for _ in range(ROUTE_WARMUP):
                rstate = sim.step_frame(rcfg, rscn, rstate)
            rstate, summaries[label] = run_path(
                rcfg, rscn, rstate, ROUTE_FRAMES, kernels, label,
                bypassed=others)
            record_peak(summaries[label], held)
            got = summaries[label]["launches"]
            for k in kernels:
                check(got.get(k, 0) == 8 * ROUTE_FRAMES,
                      f"{label}: {k} launched {got.get(k, 0)} times, not 8 "
                      "a frame")
            check(summaries[label]["div_inf"] < 1.0,
                  f"{label}: div_inf too large")
            if route == "K1":
                ref = rstate
                live = torch.cat([live_slots(ref.marker_count,
                                             cfg.slots_per_cell)] * 2)
            else:
                for k in route.split("+"):
                    launches[k] = got.get(k, 0)
                for name in ("marker_count", "dropped_markers", "u", "v",
                             "p", "alive"):
                    check(torch.equal(getattr(rstate, name),
                                      getattr(ref, name)),
                          f"{label}: {name} differs from the K1 route")
                mine = rstate.markers.reshape(live.shape)
                theirs = ref.markers.reshape(live.shape)
                check(torch.equal(mine[live], theirs[live]),
                      f"{label}: live positions differ from the K1 route")
                log(f"   {label}: counts, drops, u, v, p, alive and live "
                    "positions bitwise equal to the K1 route (whole store: "
                    f"{torch.equal(mine, theirs)})")
        if profile_prefix:
            with Phase(f"{label}: profile"):
                profile(rcfg, rscn, rstate, f"{profile_prefix}.{label}.txt",
                        label)
        del rscn, rstate


def substep_system(cfg, scn, state):
    """A substep's own projection system on `state`: dt from its maxsq,
    the advected velocities (plain grid stage), their RHS and the
    diagonal."""
    import torch

    from euler_tpu_torch import sim
    from euler_tpu_torch.ops.cuda.grid_kernel import grid_stage_plain
    from euler_tpu_torch.ops.forces import max_speed_sq
    from euler_tpu_torch.ops.project import (
        divergence_rhs,
        pressure_matrix_diag,
    )

    frame_time = torch.tensor(cfg.frame_time, device=state.u.device)
    dt = sim._dt_from_msq(cfg, max_speed_sq(cfg, state.u, state.v),
                          frame_time)
    ut, vt = grid_stage_plain(cfg, dt, state.u, state.v, state.fluid,
                              state.prev_fluid, scn.solid)
    b = divergence_rhs(cfg, ut, vt, state.fluid, dt)
    a_diag = pressure_matrix_diag(cfg, scn.solid, state.fluid)
    return dt, ut, vt, b, a_diag


def check_solve(name, got, want, rel_tol, same_iters: bool):
    """Pressure within rel_tol of the plain version's scale; iterations
    equal or within 1."""
    (p_k, i_k, _), (p_p, i_p, _) = got, want
    scale = p_p.abs().max().item()
    err = (p_k - p_p).abs().max().item()
    log(f"   {name}: p max err {err:.3g} of scale {scale:.3g} (atol "
        f"{rel_tol:g}*scale); iters {int(i_k)} vs {int(i_p)}")
    check(int(i_p) > 0, f"{name}: the plain solve ran no iteration")
    check(err <= rel_tol * scale, f"{name} pressure differs > "
          f"{rel_tol:g}*scale")
    if same_iters:
        check(int(i_k) == int(i_p), f"{name} iterations differ")
    else:
        check(abs(int(i_k) - int(i_p)) <= 1, f"{name} iterations differ > 1")
    return err


def check_hierarchy(cfg, b, a_diag, fl) -> None:
    """The Galerkin hierarchy and Chebyshev rows K3 builds on the card for
    (a_diag, fl) bitwise equal to `mg_host_operands` (the packed plane,
    every coarse level's c, e, n planes, the rows); then one preconditioner
    application on b through the coarse cycle and through one launch per
    level operation, bitwise equal."""
    import torch

    from euler_tpu_torch.ops.cuda import mg_kernel as k3

    ws = k3.workspace(cfg, b.device)
    ws.load(a_diag, fl, b)
    ws.solve(warm=False)
    _, packed0, planes, rows = k3.mg_host_operands(cfg, a_diag, fl)
    check(torch.equal(ws.packed0, packed0), "K3: packed plane differs")
    for l, (want, got) in enumerate(zip(planes, ws.levels), start=1):
        for name, a, c in zip("cen", want, got):
            check(torch.equal(a, c), f"K3: hierarchy level {l} {name} "
                  "differs from mg_host_operands")
    check(torch.equal(ws.rows, rows), "K3: Chebyshev rows differ from "
          "mg_host_operands")
    log(f"   K3: hierarchy ({len(planes)} coarse levels) and Chebyshev rows "
        f"{tuple(rows.shape)} bitwise equal to mg_host_operands")
    ws.load(a_diag, fl, b)
    fused, per_op = ws.cycle(per_op=False), ws.cycle(per_op=True)
    check(bool(fused.abs().max() > 0), "K3: the cycle returned zero")
    check(torch.equal(fused, per_op), "K3: the coarse cycle in one launch "
          "differs from one launch per level operation")
    log("   K3: coarse cycle in one launch a visit bitwise equal to one "
        "launch per level operation")


def run_large(size, results, summaries, launches, profile_prefix=None):
    """The paths beyond the fused kernels' gates: `bench.py --size 2048`
    (MG: the plain grid stage and K11) and `--size 4096 --precon jacobi`
    (K12), each from the seeded dam break (profiled with a prefix), then
    their solver against its plain version on the state they reached."""
    import torch

    from euler_tpu_torch import sim
    from euler_tpu_torch.core.presets import dam_break
    from euler_tpu_torch.ops.cuda import mg_stream_kernel as k11
    from euler_tpu_torch.ops.cuda import pcg_stream_kernel as k12

    precon, warmup, frames, reps = LARGE[size]
    mg = precon == "mg"
    cfg = main_config(size) if mg else speed_config(size)
    kernel = "K11" if mg else "K12"
    label = f"{precon}_{size}"
    held = reset_peak()
    with Phase(f"{label}: {warmup} warm-up + {frames} timed frames"):
        scn, state = dam_break(cfg, device=torch.device("cuda", 0))
        check(sim.route(cfg, scn) == ("plain", kernel),
              f"{label}: route {sim.route(cfg, scn)}")
        for _ in range(warmup):
            state = sim.step_frame(cfg, scn, state)
        bypassed = ["K2", "K3"] if mg else ["K8", "K9", "K10"]
        state, summaries[label] = run_path(cfg, scn, state, frames,
                                           ["K1", kernel], label, bypassed)
        if mg:
            check(summaries[label]["div_inf"] < 1.0,
                  f"{label}: div_inf too large")
        launches[kernel] = summaries[label]["launches"].get(kernel, 0)
        record_peak(summaries[label], held)
    if profile_prefix:
        with Phase(f"{label}: profile"):
            profile(cfg, scn, state, f"{profile_prefix}.{label}.txt", label)

    with Phase(f"{label}: solvers vs plain versions on the card"):
        dt, ut, vt, b, a_diag = substep_system(cfg, scn, state)
        fl = state.fluid
        mcfg = main_config(size)
        check(k11._root(mcfg)[2] == (2 if mg else 4), "K11: unexpected F")
        err = check_solve(f"K11 (F = {k11._root(mcfg)[2]})",
                          k11.solve_pressure_mg_stream(mcfg, b, a_diag, fl),
                          k11.solve_pressure_mg_stream_plain(mcfg, b, a_diag,
                                                             fl),
                          5e-4, same_iters=False)
        if mg:
            results["K11"] = {"max_abs_err": err}
            time_pair(results, "K11",
                      lambda: k11.solve_pressure_mg_stream(cfg, b, a_diag,
                                                           fl),
                      lambda: k11.solve_pressure_mg_stream_plain(
                          cfg, b, a_diag, fl),
                      size * size, 0, reps)
        else:
            results["K12"] = {"max_abs_err": check_solve(
                "K12", k12.solve_pressure_stream(cfg, b, a_diag, fl),
                k12.solve_pressure_stream_plain(cfg, b, a_diag, fl),
                1e-4, same_iters=True)}
            time_pair(results, "K12",
                      lambda: k12.solve_pressure_stream(cfg, b, a_diag, fl),
                      lambda: k12.solve_pressure_stream_plain(cfg, b,
                                                              a_diag, fl),
                      size * size, 0, reps)
        zero = torch.zeros_like(b)
        solve = (k11.solve_pressure_mg_stream if mg
                 else k12.solve_pressure_stream)
        _, it0, res0 = solve(cfg, zero, a_diag, fl)
        check(int(it0) == 0 and float(res0) == 0.0,
              f"{kernel}: a zero RHS is not free")
        log(f"   {kernel}: a zero RHS exits with 0 iterations")


def run(args) -> dict:
    import torch

    from euler_tpu_torch import sim
    from euler_tpu_torch.core.presets import dam_break
    from euler_tpu_torch.ops.cuda import grid_kernel as k7
    from euler_tpu_torch.ops.cuda import marker_fused_kernel as k1
    from euler_tpu_torch.ops.cuda import marker_kernel as k5
    from euler_tpu_torch.ops.cuda import mg_kernel as k3
    from euler_tpu_torch.ops.cuda import pcg_kernel as k89
    from euler_tpu_torch.ops.cuda import rebin_kernel as k6
    from euler_tpu_torch.ops.cuda import substep_kernel as k2
    from euler_tpu_torch.ops.forces import max_speed_sq
    from euler_tpu_torch.ops.markers_slots import live_slots
    from euler_tpu_torch.ops.project import (
        divergence_rhs,
        pressure_matrix_diag,
    )

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()})")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(f"nvidia-smi: {smi_line()}")

    with Phase("build kernels"):
        build_all()

    with Phase("main path at 64² on the three marker routes: GPU kernels "
               "vs CPU plain, 2 frames"):
        for route, cfg_s in marker_configs(main_config(64)).items():
            scn_g, st_g = dam_break(cfg_s, device=dev)
            scn_c, st_c = dam_break(cfg_s, device="cpu")
            check(sim.marker_route(cfg_s, scn_g) == route,
                  f"64²: marker route {sim.marker_route(cfg_s, scn_g)}")
            for _ in range(2):
                st_g = sim.step_frame(cfg_s, scn_g, st_g)
                st_c = sim.step_frame(cfg_s, scn_c, st_c)
            check(torch.equal(st_g.marker_count.cpu(), st_c.marker_count),
                  f"64² {route}: marker_count differs between GPU kernels "
                  "and CPU plain")
            du = (st_g.u.cpu() - st_c.u).abs().max().item()
            dv = (st_g.v.cpu() - st_c.v).abs().max().item()
            log(f"   {route}: counts equal; max |du| {du:.3g}, |dv| "
                f"{dv:.3g} (atol 5e-3); dropped "
                f"{int(st_g.dropped_markers)} vs {int(st_c.dropped_markers)}")
            check(du <= 5e-3 and dv <= 5e-3,
                  f"64² {route}: velocities differ > 5e-3")
            check(int(st_g.dropped_markers) == int(st_c.dropped_markers),
                  f"64² {route}: dropped_markers differ")

    cfg = main_config(SIZE)
    scfg = speed_config(SIZE)
    Y, X, K = cfg.ny, cfg.nx, cfg.slots_per_cell
    with Phase(f"dam break {SIZE}², {WARMUP_FRAMES} warm-up frames"):
        scn, state = dam_break(cfg, device=dev)
        for _ in range(WARMUP_FRAMES):
            state = sim.step_frame(cfg, scn, state)
        torch.cuda.synchronize()

    results = {}
    inf = torch.tensor(float("inf"), device=dev)
    zero = torch.zeros((), device=dev)
    with Phase("kernels vs plain versions on the card"):
        frame_time = torch.tensor(cfg.frame_time, device=dev)
        dt = sim._dt_from_msq(cfg, max_speed_sq(cfg, state.u, state.v),
                              frame_time)
        log(f"   dt {dt.item():.6g}")
        dead = scn.sink | scn.solid
        slots = state.markers.reshape(2 * K, Y, X)
        k1_args = (cfg, state.u, state.v, state.fluid, scn.solid, slots, dt,
                   state.marker_count)
        o_k, c_k, d_k = k1.march_rebin(*k1_args, dead=dead)
        o_p, c_p, d_p = k1.march_rebin_plain(*k1_args, dead=dead)
        check(torch.equal(c_k, c_p), "K1 counts differ from plain")
        check(torch.equal(d_k, d_p), "K1 drops differ from plain")
        live = torch.cat([live_slots(c_p, K)] * 2)
        err1 = (o_k - o_p).abs()[live].max().item()
        log(f"   K1: counts, drops equal; live positions max err {err1:.3g}"
            f" (bitwise: {torch.equal(o_k, o_p)})")
        check(err1 <= 1e-5, "K1 positions differ > 1e-5")
        o_0, c_0, d_0 = k1.march_rebin(cfg, state.u, state.v, state.fluid,
                                       scn.solid, slots, zero,
                                       state.marker_count, dead=dead)
        check(torch.equal(o_0, slots) and torch.equal(c_0, state.marker_count)
              and int(d_0.sum()) == 0, "K1 with dt = 0 is not an identity")
        log("   K1: dt = 0 is a bitwise identity")
        results["K1"] = {"max_abs_err": err1}

        for name, err in check_marker_variants(cfg, scn, state, dt, o_k, c_k,
                                               d_k).items():
            results[name] = {"max_abs_err": err}

        fl, pfl = c_k > 0, state.marker_count > 0
        k2_args = (cfg, dt, dt, state.u, state.v, fl, pfl, scn.solid,
                   state.p)
        u_k, v_k, it_k, _, msq_k, p_k = k2.project_substep_mg(*k2_args)
        u_p, v_p, it_p, _, msq_p, p_p = k2.project_substep_mg_plain(
            *k2_args)
        err2 = max((u_k - u_p).abs().max().item(),
                   (v_k - v_p).abs().max().item())
        rel_msq = abs(msq_k.item() - msq_p.item()) / max(msq_p.item(), 1e-30)
        log(f"   K2: u/v max err {err2:.3g} (atol 2e-3); iters "
            f"{int(it_k)} vs {int(it_p)}; msq rel err {rel_msq:.3g}")
        check(err2 <= 2e-3, "K2 velocities differ > 2e-3")
        check(abs(int(it_k) - int(it_p)) <= 1, "K2 iterations differ > 1")
        check(rel_msq <= 1e-3, "K2 msq differs > 1e-3 relative")
        u_i, v_i, it_i, res_i, msq_i, _ = k2.project_substep_mg(
            cfg, zero, inf, state.u, state.v, fl, pfl, scn.solid, state.p)
        check(int(it_i) == 0 and float(res_i) == 0.0
              and bool(torch.isfinite(u_i).all())
              and bool(torch.isfinite(v_i).all()),
              "K2 inactive substep is not free and finite")
        log("   K2: inactive substep exits with 0 iterations, finite")
        results["K2"] = {"max_abs_err": err2}

        # the substep's own system: the RHS of the advected velocities
        ut, vt = k7.grid_stage_plain(cfg, dt, state.u, state.v, fl, pfl,
                                     scn.solid)
        u7, v7 = k7.grid_stage(cfg, state.u, state.v, fl, pfl, scn.solid, dt)
        err7 = max((u7 - ut).abs().max().item(),
                   (v7 - vt).abs().max().item())
        log(f"   K7: ut/vt max err {err7:.3g} (atol 2e-4; bitwise: "
            f"{torch.equal(u7, ut) and torch.equal(v7, vt)})")
        check(err7 <= 2e-4, "K7 velocities differ > 2e-4")
        results["K7"] = {"max_abs_err": err7}
        b = divergence_rhs(cfg, ut, vt, fl, dt)
        a_diag = pressure_matrix_diag(cfg, scn.solid, fl)
        err3 = 0.0
        for x0 in (None, state.p):
            p3k, i3k, _ = k3.solve_pressure_mg(cfg, b, a_diag, fl, x0=x0)
            p3p, i3p, _ = k3.solve_pressure_mg_plain(cfg, b, a_diag, fl, x0)
            scale = p3p.abs().max().item()
            e = (p3k - p3p).abs().max().item()
            err3 = max(err3, e)
            log(f"   K3 ({'warm' if x0 is not None else 'cold'}): p max err "
                f"{e:.3g} of scale {scale:.3g} (atol 5e-4*scale); iters "
                f"{int(i3k)} vs {int(i3p)}")
            check(e <= 5e-4 * scale, "K3 pressure differs > 5e-4*scale")
            check(abs(int(i3k) - int(i3p)) <= 1, "K3 iterations differ > 1")
        capped = dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, max_iterations=3))
        p3k, i3k, _ = k3.solve_pressure_mg(capped, b, a_diag, fl, x0=state.p)
        p3p, i3p, _ = k3.solve_pressure_mg_plain(capped, b, a_diag, fl,
                                                 state.p)
        e = (p3k - p3p).abs().max().item()
        scale = p3p.abs().max().item()
        log(f"   K3 (max_iterations 3): iters {int(i3k)} vs {int(i3p)}; p max "
            f"err {e:.3g} of scale {scale:.3g}")
        check(int(i3k) == int(i3p) == 3, "K3 capped at 3 iterations did not "
              "take exactly 3")
        check(e <= 5e-4 * scale, "K3 (capped) pressure differs > 5e-4*scale")
        err3 = max(err3, e)
        check_hierarchy(cfg, b, a_diag, fl)
        results["K3"] = {"max_abs_err": err3}

        # the Jacobi kernels on the same system, at the speed-mode budget
        p8k, i8k, _ = k89.solve_pressure_jacobi(scfg, b, a_diag, fl)
        p8p, i8p, _ = k89.solve_pressure_jacobi_plain(scfg, b, a_diag, fl)
        scale = p8p.abs().max().item()
        err8 = (p8k - p8p).abs().max().item()
        log(f"   K8: p max err {err8:.3g} of scale {scale:.3g} (atol "
            f"1e-3*scale); iters {int(i8k)} vs {int(i8p)}")
        check(int(i8k) == int(i8p), "K8 iterations differ")
        check(err8 <= 1e-3 * scale, "K8 pressure differs > 1e-3*scale")
        results["K8"] = {"max_abs_err": err8}

        jacobi_pairs = {
            "K9": (lambda: k89.project_jacobi(scfg, dt, ut, vt, fl,
                                              scn.solid),
                   lambda: k89.project_jacobi_plain(scfg, dt, ut, vt, fl,
                                                    scn.solid)),
            "K10": (lambda: k2.project_substep_jacobi(
                        scfg, dt, dt, state.u, state.v, fl, pfl, scn.solid),
                    lambda: k2.project_substep_jacobi_plain(
                        scfg, dt, dt, state.u, state.v, fl, pfl, scn.solid)),
        }
        for name, (kern, plain_fn) in jacobi_pairs.items():
            u_k, v_k, it_k, _, msq_k = kern()
            u_p, v_p, it_p, _, msq_p = plain_fn()
            err = max((u_k - u_p).abs().max().item(),
                      (v_k - v_p).abs().max().item())
            rel_msq = (abs(msq_k.item() - msq_p.item())
                       / max(msq_p.item(), 1e-30))
            log(f"   {name}: u/v max err {err:.3g} (atol 2e-3); iters "
                f"{int(it_k)} vs {int(it_p)}; msq rel err {rel_msq:.3g}")
            check(err <= 2e-3, f"{name} velocities differ > 2e-3")
            check(abs(int(it_k) - int(it_p)) <= 1,
                  f"{name} iterations differ > 1")
            check(rel_msq <= 1e-3, f"{name} msq differs > 1e-3 relative")
            results[name] = {"max_abs_err": err}
        u_i, v_i, it_i, res_i, msq_i = k2.project_substep_jacobi(
            scfg, zero, inf, state.u, state.v, fl, pfl, scn.solid)
        check(int(it_i) == 0 and float(res_i) == 0.0
              and all(bool(torch.isfinite(t).all())
                      for t in (u_i, v_i, msq_i)),
              "K10 inactive substep is not free and finite")
        log("   K10: inactive substep exits with 0 iterations, finite")
        torch.cuda.synchronize()

    summaries = {}
    launches = {}
    with Phase(f"main path: {FRAMES} timed frames"):
        state, summaries["mg"] = run_path(cfg, scn, state, FRAMES,
                                          ["K1", "K2", "K3"], "MG main path")
        check(summaries["mg"]["div_inf"] < 1.0,
              "div_inf too large: the projection did not converge")
        for k in ("K1", "K2", "K3"):
            launches[k] = summaries["mg"]["launches"].get(k, 0)

    with Phase(f"speed mode {SIZE}²: {WARMUP_FRAMES} warm-up + {FRAMES} "
               "timed frames"):
        sscn, sstate = dam_break(scfg, device=dev)
        for _ in range(WARMUP_FRAMES):
            sstate = sim.step_frame(scfg, sscn, sstate)
        # no div_inf limit: the speed mode gives up at 100 iterations
        sstate, summaries["speed"] = run_path(scfg, sscn, sstate, FRAMES,
                                              ["K1", "K10"], "speed mode")
        launches["K10"] = summaries["speed"]["launches"].get("K10", 0)

    unfused = dataclasses.replace(scfg, solver=dataclasses.replace(
        scfg.solver, fuse_projection=False))
    # route: (config, its kernels, the kernels whose launch count it gives)
    routes = {
        "jacobi_unfused": (unfused, ["K1", "K8"], ["K8"]),
        "jacobi_rainbow": (speed_config(SIZE, rainbow=True), ["K1", "K9"],
                           ["K9"]),
        "mg_rainbow": (dataclasses.replace(cfg, rainbow=True), ["K1", "K3"],
                       []),
        "jacobi_pallas_grid": (dataclasses.replace(
            unfused, use_pallas_grid=True), ["K1", "K7", "K8"], ["K7"]),
    }
    for route, (rcfg, kernels, counted) in routes.items():
        with Phase(f"route {route} {SIZE}²: {ROUTE_WARMUP} warm-up + "
                   f"{ROUTE_FRAMES} timed frames"):
            held = reset_peak()
            rscn, rstate = dam_break(rcfg, device=dev)
            for _ in range(ROUTE_WARMUP):
                rstate = sim.step_frame(rcfg, rscn, rstate)
            rstate, summaries[route] = run_path(rcfg, rscn, rstate,
                                                ROUTE_FRAMES, kernels, route)
            if route == "mg_rainbow":
                check(summaries[route]["div_inf"] < 1.0,
                      "mg_rainbow: div_inf too large")
            for k in counted:
                launches[k] = summaries[route]["launches"].get(k, 0)
            if "K7" in kernels:
                record_peak(summaries[route], held)
            del rscn, rstate

    run_marker_routes(cfg, summaries, launches, dev, args.profile)

    with Phase("kernel vs plain times (CUDA events)"):
        fl, pfl = state.fluid, state.prev_fluid
        slots = state.markers.reshape(2 * K, Y, X)
        dt = sim._dt_from_msq(cfg, max_speed_sq(cfg, state.u, state.v),
                              frame_time)
        k1_args = (cfg, state.u, state.v, fl, scn.solid, slots, dt,
                   state.marker_count)
        k2_args = (cfg, dt, dt, state.u, state.v, fl, pfl, scn.solid,
                   state.p)
        k10_args = (scfg, dt, dt, state.u, state.v, fl, pfl, scn.solid)
        a_diag = pressure_matrix_diag(cfg, scn.solid, fl)
        ut, vt = k7.grid_stage_plain(cfg, dt, state.u, state.v, fl, pfl,
                                     scn.solid)
        b = divergence_rhs(cfg, ut, vt, fl, dt)
        grid_args = (state.u, state.v, fl, pfl, scn.solid)
        px, py = state.markers[0], state.markers[1]
        k5_args = (cfg, state.u, state.v, fl, scn.solid, px, py, dt,
                   state.marker_count)
        mpx, mpy = k5.advect_markers(*k5_args)
        padded = k1.pad_slot_store(cfg, state.markers)
        k4_args = (cfg, state.u, state.v, fl, scn.solid, padded, dt,
                   state.marker_count)
        pairs = {
            "K1": (lambda: k1.march_rebin(*k1_args, dead=dead),
                   lambda: k1.march_rebin_plain(*k1_args, dead=dead)),
            "K4": (lambda: k1.march_rebin_padded(*k4_args, dead=dead),
                   lambda: k1.march_rebin_padded_plain(*k4_args,
                                                       dead=dead)),
            "K5": (lambda: k5.advect_markers(*k5_args),
                   lambda: k5.advect_markers_plain(*k5_args)),
            "K6": (lambda: k6.rebin_markers(cfg, mpx, mpy, state.alive,
                                            dead),
                   lambda: k6.rebin_markers_plain(cfg, mpx, mpy,
                                                  state.alive, dead)),
            "K2": (lambda: k2.project_substep_mg(*k2_args),
                   lambda: k2.project_substep_mg_plain(*k2_args)),
            "K3": (lambda: k3.solve_pressure_mg(cfg, b, a_diag, fl,
                                                x0=state.p),
                   lambda: k3.solve_pressure_mg_plain(cfg, b, a_diag, fl,
                                                      state.p)),
            "K7": (lambda: k7.grid_stage(cfg, *grid_args, dt),
                   lambda: k7.grid_stage_plain(cfg, dt, *grid_args)),
            "K8": (lambda: k89.solve_pressure_jacobi(scfg, b, a_diag, fl),
                   lambda: k89.solve_pressure_jacobi_plain(scfg, b, a_diag,
                                                           fl)),
            "K9": (lambda: k89.project_jacobi(scfg, dt, ut, vt, fl,
                                              scn.solid),
                   lambda: k89.project_jacobi_plain(scfg, dt, ut, vt, fl,
                                                    scn.solid)),
            "K10": (lambda: k2.project_substep_jacobi(*k10_args),
                    lambda: k2.project_substep_jacobi_plain(*k10_args)),
        }
        n_live = int(state.marker_count.sum())
        for name, (kern, plain_fn) in pairs.items():
            time_pair(results, name, kern, plain_fn, Y * X, n_live, REPS)

    for size in LARGE:
        run_large(size, results, summaries, launches, args.profile)

    if args.profile:
        with Phase("profile"):
            profile(cfg, scn, state, f"{args.profile}.mg.txt", "mg")
            profile(scfg, sscn, sstate, f"{args.profile}.speed.txt",
                    "speed")

    kernels = []
    for key, (name, src, replaces) in KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[key],
                        **results[key]})
    log(json.dumps({"summary": summaries}))
    log(json.dumps({"kernels": kernels}))
    log(smi_line())
    return {"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}


def profile(cfg, scn, state, path: str, label: str) -> None:
    """torch.profiler over 2 frames from `state`: device kernel time by
    name, written to `path`, with launches and stream syncs per frame and
    the device's idle share of the same 2 frames' unprofiled wall time
    (they are deterministic, so they are stepped twice: timed, then
    profiled)."""
    import torch
    from torch.profiler import ProfilerActivity

    from euler_tpu_torch import sim

    frames = 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = state
    for _ in range(frames):
        st, stats = sim.step_frame_stats(cfg, scn, st)
    torch.cuda.synchronize()
    ms_frame = 1e3 * (time.perf_counter() - t0) / frames
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        st = state
        for _ in range(frames):
            st = sim.step_frame(cfg, scn, st)
        torch.cuda.synchronize()
    events = prof.key_averages()
    table = events.table(sort_by="cuda_time_total", row_limit=40)
    with open(path, "w") as fh:
        fh.write(table)
    dev_us = 0.0
    n_kernels = 0
    n_sync = 0
    for e in events:
        d = getattr(e, "device_time_total", None)
        if d is None:
            d = getattr(e, "cuda_time_total", 0.0)
        if e.key.startswith("cuda") or e.key.startswith("aten::"):
            if "Synchronize" in e.key:
                n_sync += e.count
            continue
        if d > 0:
            dev_us += d
            n_kernels += e.count
    dev_ms = dev_us / 1e3 / frames
    log(f"   {label}: device kernel time {dev_ms:.3f} "
        f"ms/frame, {n_kernels / frames:.0f} kernel launches/frame, "
        f"{n_sync / frames:.0f} stream syncs/frame; the same frames "
        f"unprofiled {ms_frame:.3f} ms/frame ({int(stats['n_active'])} "
        f"active substeps in the last), idle share "
        f"{1 - dev_ms / ms_frame:.3f}; table in {path}")
    for line in table.splitlines()[:20]:
        log(f"   {line}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=None, metavar="PREFIX",
                    help="write torch.profiler tables of 2 frames of the "
                         "MG main path, the speed mode, the three marker "
                         "routes and the 2048² and 4096² paths to "
                         "PREFIX.mg.txt, PREFIX.speed.txt, "
                         "PREFIX.marker_k1.txt, PREFIX.marker_unfused.txt, "
                         "PREFIX.padded_store.txt, PREFIX.mg_2048.txt and "
                         "PREFIX.jacobi_4096.txt")
    args = ap.parse_args(argv)

    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; the port's "
              "kernels run only on an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        import euler_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the repository root (the "
              "euler_tpu_torch package was not found)", file=sys.stderr)
        return 2
    result = run(args)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
