"""Time the port's Jacobi-PCG solve (K8) and the Jacobi speed mode (K10)
on an NVIDIA GPU where a solve stops early or late, to compare how a
tree's solver drives its iterations (a host loop that reads the stop
flag, a replayed budget, or a loop on the device).

Runs the `euler_tpu_torch` package of the tree given by `--root` (default:
the repository this script is in), so that one call can time two commits
in turn:

    python3 tools/jacobi_loop_lab.py --root path/to/tree --label parent

K8 runs on the 1024² dam break's system after 4 frames of the speed
mode under each case of `SOLVES`; the speed mode steps 2 warm-up and 8
timed frames from the dam break under each case of `FRAMES`.  Prints one JSON line: per case the
iterations, the ms of a call (CUDA events around each of 10 calls, after
2 untimed) or of a frame, and, from torch.profiler over one more call,
its device kernel launches and host stream syncs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
from pathlib import Path

SIZE = 1024
# K8 cases: (max_iterations, tol_rel); a tol of 1e-6 as `bench.py`
SOLVES = {
    "speed_cap100": (100, 1e-6),  # the speed mode: stops at the cap
    "tol_rel_0.3_cap100": (100, 0.3),
    "tol_rel_0.3_cap1000": (1000, 0.3),
    "tol_rel_0.1_cap100": (100, 0.1),
    "tol_rel_0.1_cap1000": (1000, 0.1),
    "tol_rel_1e-2_cap1000": (1000, 1e-2),
    "tol_rel_1e-3_cap1000": (1000, 1e-3),
    "zero_rhs_cap100": (100, 1e-6),  # b = 0: no iteration
    "zero_rhs_cap1000": (1000, 1e-6),
}
# speed-mode frames: `bench.py --precon jacobi` with --pcg-iters and
# --tol-rel as given
FRAMES = {
    "speed": (100, 1e-6),
    "speed_tol_rel_0.1": (100, 0.1),
    "speed_cap1000_tol_rel_0.1": (1000, 0.1),
    "speed_cap1000_tol_rel_1e-2": (1000, 1e-2),
}


def configs(size):
    from euler_tpu_torch.config import SimConfig, SolverConfig

    main = SimConfig(
        nx=size, ny=size, marker_layout="slots",
        solver=SolverConfig(max_iterations=100, tol=1e-6, tol_rel=1e-4,
                            dtype="float32", preconditioner="mg",
                            warm_start=True, fuse_projection=True))

    def speed(cap, tol_rel):
        return dataclasses.replace(main, solver=dataclasses.replace(
            main.solver, preconditioner="jacobi", max_iterations=cap,
            tol_rel=tol_rel, warm_start=False))

    return main, speed


def profiled(fn):
    """(device kernel launches, cudaStreamSynchronize calls) of fn()."""
    import torch
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches = syncs = 0
    for e in prof.key_averages():
        if e.key == "cudaStreamSynchronize":
            syncs += e.count
        elif not e.key.startswith(("cuda", "aten::")):
            d = getattr(e, "device_time_total", None)
            if d is None:
                d = getattr(e, "cuda_time_total", 0.0)
            if d > 0:
                launches += e.count
    return launches, syncs


def time_calls(fn, reps=10):
    """ms of each of `reps` calls of fn (CUDA events), after 2 untimed."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return times


def run() -> dict:
    import torch

    from euler_tpu_torch import sim
    from euler_tpu_torch.core.presets import dam_break
    from euler_tpu_torch.ops.cuda import pcg_kernel as k89
    from euler_tpu_torch.ops.cuda import substep_kernel as k2
    from euler_tpu_torch.ops.forces import max_speed_sq
    from euler_tpu_torch.ops.project import (
        divergence_rhs,
        pressure_matrix_diag,
    )

    dev = torch.device("cuda", 0)
    main, speed = configs(SIZE)
    scn, st = dam_break(main, device=dev)
    for _ in range(4):
        st = sim.step_frame(speed(*FRAMES["speed"]), scn, st)
    dt = sim._dt_from_msq(main, max_speed_sq(main, st.u, st.v),
                          torch.tensor(main.frame_time, device=dev))
    ut, vt = k2.grid_stage_plain(main, dt, st.u, st.v, st.fluid,
                                 st.prev_fluid, scn.solid)
    b = divergence_rhs(main, ut, vt, st.fluid, dt)
    a = pressure_matrix_diag(main, scn.solid, st.fluid)
    out = {"solves": {}, "frames": {}}
    for name, (cap, tol_rel) in SOLVES.items():
        cfg = speed(cap, tol_rel)
        rhs = torch.zeros_like(b) if name.startswith("zero") else b

        def solve():
            return k89.solve_pressure_jacobi(cfg, rhs, a, st.fluid)

        times = time_calls(solve)
        _, it, _ = solve()
        launches, syncs = profiled(solve)
        out["solves"][name] = {
            "iterations": int(it), "ms_median": statistics.median(times),
            "ms_min": min(times), "launches": launches, "syncs": syncs}
    for name, (cap, tol_rel) in FRAMES.items():
        cfg = speed(cap, tol_rel)
        fscn, fst = dam_break(cfg, device=dev)
        for _ in range(2):
            fst = sim.step_frame(cfg, fscn, fst)
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        iters = torch.zeros((), dtype=torch.int64, device=dev)
        active = torch.zeros_like(iters)
        t0.record()
        for _ in range(8):
            fst, stats = sim.step_frame_stats(cfg, fscn, fst)
            iters += stats["pcg_iters"]
            active += stats["n_active"]
        t1.record()
        t1.synchronize()
        out["frames"][name] = {
            "ms_per_frame": t0.elapsed_time(t1) / 8,
            "active_substeps": int(active),
            "iterations_per_active_substep": int(iters)
            / max(int(active), 1)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the tree whose euler_tpu_torch is timed")
    ap.add_argument("--label", default="tree")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("jacobi_loop_lab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    result = run()
    print(json.dumps({"label": args.label, "root": args.root,
                      "device": torch.cuda.get_device_name(0), **result}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
