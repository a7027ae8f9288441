"""Time the port's grid stage K7 on an NVIDIA GPU under several tile
plans, to choose the plan of `grid_kernel.grid_tile_plan`, and compare
two trees.

Runs the `euler_tpu_torch` package of the tree given by `--root` (default:
the repository this script is in), so that one call can time two commits
in turn:

    python3 tools/grid_tile_lab.py --root path/to/tree --label parent

K7 runs on the states of the paths that take it: the 1024² dam break
after 4 frames of the main path, the 2048² one after 2 frames of
`bench.py --size 2048` and the 4096² one after 1 frame of `--size 4096
--precon jacobi`.  A tree whose wrapper has `grid_tile_plan` is timed
under each plan of `PLANS` (tile height, tile width, threads a CTA; or
those given by `--plan`), each
checked bitwise against the plain version, and in the rainbow form
(`extrapolated=True`) under its own plan; another tree under its own
launch only.  Prints one JSON line: per case the ms of a call (CUDA
events around 20 calls after 2 untimed, best of 3 rounds: the wrapper's
host time where that is longer), its device ms (20 calls enqueued behind
a sleep kernel, so the host is out of the way) and the host's µs to
enqueue a call, beside the byte bound of the call and the card's name.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

# size: (preconditioner, frames stepped before timing)
SIZES = {1024: ("mg", 4), 2048: ("mg", 2), 4096: ("jacobi", 1)}
PLANS = [(8, 32, 128), (8, 32, 256), (16, 32, 128), (16, 32, 256),
         (16, 32, 512), (32, 32, 128), (32, 32, 256), (32, 32, 512),
         (8, 64, 256), (8, 64, 512), (16, 64, 128), (16, 64, 256),
         (16, 64, 512), (32, 64, 256), (32, 64, 512), (4, 128, 256),
         (4, 128, 512), (8, 128, 128), (8, 128, 256), (8, 128, 512),
         (16, 128, 256)]
# K7's bytes a cell: u, v f32 and three u8 masks in, ut, vt f32 out; the
# rainbow form also writes uu, vv
BYTES_PER_CELL = {False: 19, True: 27}
HBM_BYTES_PER_S = 3.35e12


def cuda_ms(fn, reps: int = 20, rounds: int = 3) -> float:
    import torch

    best = float("inf")
    for _ in range(rounds):
        fn()
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def device_ms(fn, reps: int = 20) -> float:
    """The card's time a call of fn() with the host out of the way: `reps`
    calls enqueued behind a sleep kernel that outlasts their enqueueing
    (~10 ms), timed by CUDA events.  Raises if the sleep ended first."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    if start.query():
        raise RuntimeError("the host enqueued slower than the sleep lasted")
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int = 50) -> float:
    """The host's time a call of fn() takes to enqueue its work (host
    clock around `reps` calls, no synchronisation inside)."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / reps


def developed(size: int):
    """The dam break at `size` after the frames of SIZES, on the route
    `bench.py` takes there: (cfg, grid-stage args, dt)."""
    import torch

    from euler_tpu_torch import sim
    from euler_tpu_torch.config import SimConfig, SolverConfig
    from euler_tpu_torch.core.presets import dam_break
    from euler_tpu_torch.ops.forces import max_speed_sq

    precon, frames = SIZES[size]
    mg = precon == "mg"
    cfg = SimConfig(
        nx=size, ny=size, marker_layout="slots",
        solver=SolverConfig(max_iterations=100, tol=1e-6,
                            tol_rel=1e-4 if mg else 1e-6, dtype="float32",
                            preconditioner=precon, warm_start=mg,
                            fuse_projection=True))
    scn, st = dam_break(cfg, device="cuda")
    for _ in range(frames):
        st = sim.step_frame(cfg, scn, st)
    dt = sim._dt_from_msq(cfg, max_speed_sq(cfg, st.u, st.v),
                          torch.tensor(cfg.frame_time, device="cuda"))
    return cfg, (st.u, st.v, st.fluid, st.prev_fluid, scn.solid), dt


def time_case(fn, want, extrapolated: bool, n: int) -> dict:
    import torch

    got = fn()
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, want))
    return {"bitwise": same, "ms": cuda_ms(fn), "device_ms": device_ms(fn),
            "host_us": host_us(fn),
            "bound_ms": 1e3 * BYTES_PER_CELL[extrapolated] * n
            / HBM_BYTES_PER_S}


def run(label: str, plans) -> dict:
    import torch

    from euler_tpu_torch.ops.cuda import grid_kernel as k7

    out = {"label": label, "device": torch.cuda.get_device_name(0),
           "cases": {}}
    planned = hasattr(k7, "grid_tile_plan")
    default_plan = k7.grid_tile_plan if planned else None
    for size in SIZES:
        cfg, args, dt = developed(size)
        want = k7.grid_stage_plain(cfg, dt, *args)
        n = size * size
        for plan in [None] + (plans if planned else []):
            if plan is not None:
                k7.grid_tile_plan = (lambda Y, X, plan=plan:
                                     default_plan(Y, X, *plan))
            name = ("default" if plan is None
                    else f"{plan[0]}x{plan[1]}_t{plan[2]}")
            try:
                case = time_case(lambda: k7.grid_stage(cfg, *args, dt),
                                 want, False, n)
            except RuntimeError as e:  # a plan the card refuses
                case = {"error": str(e)}
            finally:
                if planned:
                    k7.grid_tile_plan = default_plan
            out["cases"][f"{size}_{name}"] = case
            print(f"{size}² {name}: {case}", file=sys.stderr, flush=True)
        if planned:
            rwant = want + k7.extrapolate_zero(cfg, *args)
            case = time_case(lambda: k7.grid_stage(cfg, *args, dt,
                                                   extrapolated=True),
                             rwant, True, n)
            out["cases"][f"{size}_extrapolated"] = case
            print(f"{size}² extrapolated: {case}", file=sys.stderr,
                  flush=True)
        del args, want
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the tree whose euler_tpu_torch is timed")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--plan", action="append", metavar="TY,TX,THREADS",
                    help="time only these plans (default: PLANS)")
    args = ap.parse_args(argv)
    plans = ([tuple(int(v) for v in p.split(",")) for p in args.plan]
             if args.plan else PLANS)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("grid_tile_lab: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(run(args.label, plans)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
