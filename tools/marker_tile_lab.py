"""Time the port's marker kernels on an NVIDIA GPU: the fused pass (K1,
and K4 on the padded store) under several tile plans, to choose the plan
of `marker_fused_kernel.tile_plan`, and the unfused pair (K5 march, K6
re-bin), to compare two trees.

Runs the `euler_tpu_torch` package of the tree given by `--root` (default:
the repository this script is in), so that one call can time two commits
in turn:

    python3 tools/marker_tile_lab.py --root path/to/tree --label parent

K1 and K4 run on the 1024² dam break after 4 frames of the main path
(slots K = 8), and K1 on the same with K = 16.  A tree whose wrapper has
`tile_plan` is timed under each plan of `PLANS` (tile height, threads a
CTA; tiles 32 cells wide), each checked bitwise against the plain version
(the whole store, counts and drops); another tree under its own launch
only.  Then K1 at K = 8 on the `VARIANTS` of that state.  K5 and K6 run
on the same states at K = 8 and 16 in the tree's own wrapper form (px,
py planes or the [2, K, Y, X] store), each checked bitwise against its
plain version: under the tree's own launch and, where the wrappers take
a tile plan, under each plan of `UNFUSED_PLANS`; then with no live
marker.  Prints one JSON line: per case the ms of a call (CUDA events
around 20 calls after 2 untimed, best of 3 rounds: the wrapper's host
time where that is longer), its device ms (20 calls enqueued behind a
sleep kernel, so the host is out of the way) and the host's µs to
enqueue a call, the tiles that hold a live marker, and the card's name.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import sys
from pathlib import Path

SIZE = 1024
WARMUP_FRAMES = 4
PLANS = [(32, 512), (32, 256), (16, 512), (16, 256), (8, 256)]
# the plans K5 and K6 are timed under (tile height, threads a CTA)
UNFUSED_PLANS = [(32, 512), (16, 512), (16, 256), (8, 256), (8, 128),
                 (4, 128), (4, 64), (2, 64)]
# K1 at K = 8 on variants of the state, to attribute its time: no live
# marker (the zero store alone), dt = 0 (no DDA step), and
# marker_march_iters = 0 (the velocity samples without the DDA loop)
VARIANTS = ["empty", "dt0", "iters0"]


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


def developed(K: int):
    """The main path's 1024² dam break after WARMUP_FRAMES frames, with K
    slots a cell: (cfg, scn, state, dt)."""
    import torch

    from euler_tpu_torch import sim
    from euler_tpu_torch.config import SimConfig, SolverConfig
    from euler_tpu_torch.core.presets import dam_break
    from euler_tpu_torch.ops.forces import max_speed_sq

    cfg = SimConfig(
        nx=SIZE, ny=SIZE, marker_layout="slots", slots_per_cell=K,
        solver=SolverConfig(max_iterations=100, tol=1e-6, tol_rel=1e-4,
                            dtype="float32", preconditioner="mg",
                            warm_start=True, fuse_projection=True))
    scn, st = dam_break(cfg, device="cuda")
    for _ in range(WARMUP_FRAMES):
        st = sim.step_frame(cfg, scn, st)
    dt = sim._dt_from_msq(cfg, max_speed_sq(cfg, st.u, st.v),
                          torch.tensor(cfg.frame_time, device="cuda"))
    return cfg, scn, st, dt


def unfused_calls(cfg, scn, st, dt, empty: bool = False):
    """{"K5": (kernel call, bitwise equal to the plain version), "K6": ...}
    on the developed state (with `empty`, no live marker: K5 on zero
    counts, K6 on an all-false alive plane), in the tree's wrapper form:
    the [2, K, Y, X] store in and out, or (before it) the px and py
    planes."""
    import torch

    from euler_tpu_torch.ops.cuda import marker_kernel as k5
    from euler_tpu_torch.ops.cuda import rebin_kernel as k6

    args = (cfg, st.u, st.v, st.fluid, scn.solid)
    dead = scn.sink | scn.solid
    count = torch.zeros_like(st.marker_count) if empty else st.marker_count
    alive = torch.zeros_like(st.alive) if empty else st.alive
    if "markers" in inspect.signature(k5.advect_markers).parameters:
        store = (st.markers,)
        marched = (k5.advect_markers(*args, st.markers, dt, count),)
    else:
        store = (st.markers[0], st.markers[1])
        marched = k5.advect_markers(*args, *store, dt, count)

    def k5_fn():
        return k5.advect_markers(*args, *store, dt, count)

    def k6_fn():
        return k6.rebin_markers(cfg, *marched, alive, dead)

    def same(got, want):
        return all(torch.equal(a, b) for a, b in zip(got, want))

    return {
        "K5": (k5_fn, same(k5_fn(), k5.advect_markers_plain(
            *args, *store, dt, count))),
        "K6": (k6_fn, same(k6_fn(), k6.rebin_markers_plain(
            cfg, *marched, alive, dead)))}


def time_unfused(out, K, cfg, scn, st, dt) -> None:
    """K5 and K6 under the tree's own launch, on the state and with no
    live marker; on a tree whose K5 / K6 wrappers take a tile plan, also
    under each plan of UNFUSED_PLANS."""
    from euler_tpu_torch.ops.cuda import marker_fused_kernel as k1
    from euler_tpu_torch.ops.cuda import marker_kernel as k5
    from euler_tpu_torch.ops.cuda import rebin_kernel as k6

    planned = hasattr(k5, "tile_plan")
    plans = [None] + (UNFUSED_PLANS if planned else [])
    for plan in plans + ["empty"]:
        if isinstance(plan, tuple):
            ty, threads = plan

            def fixed(Y, X, K, kernel, ty=ty, threads=threads):
                return k1.TilePlan(ty, k1.TILE_X, -(-Y // ty),
                                   -(-X // k1.TILE_X), threads,
                                   k1.tile_smem_bytes(ty, k1.TILE_X, K,
                                                      kernel))

            k5.tile_plan = k6.tile_plan = fixed
        name = (plan if plan == "empty" else "default" if plan is None
                else f"{plan[0]}x32_t{plan[1]}")
        case = {}
        try:
            for kname, (fn, same) in unfused_calls(
                    cfg, scn, st, dt, plan == "empty").items():
                case[f"{kname}_bitwise"] = same
                case[f"{kname}_ms"] = cuda_ms(fn)
                case[f"{kname}_device_ms"] = device_ms(fn)
                case[f"{kname}_host_us"] = host_us(fn)
        except RuntimeError as e:  # a plan the card refuses
            case["error"] = str(e)
        finally:
            if planned:
                k5.tile_plan = k6.tile_plan = k1.tile_plan
        out["cases"][f"K{K}_unfused_{name}"] = case
        print(f"K={K} unfused {name}: {case}", file=sys.stderr, flush=True)


def run(label: str) -> dict:
    import torch

    from euler_tpu_torch.ops.cuda import marker_fused_kernel as k1

    out = {"label": label, "device": torch.cuda.get_device_name(0),
           "cases": {}}
    planned = hasattr(k1, "tile_plan")
    default_plan = k1.tile_plan if planned else None
    for K in (8, 16):
        cfg, scn, st, dt = developed(K)
        Y, X = cfg.ny, cfg.nx
        dead = scn.sink | scn.solid
        args = (cfg, st.u, st.v, st.fluid, scn.solid)
        slots = st.markers.reshape(2 * K, Y, X)
        padded = k1.pad_slot_store(cfg, st.markers)
        want = k1.march_rebin_plain(*args, slots, dt, st.marker_count,
                                    dead=dead)
        live = int(st.marker_count.sum())
        plans = [None] + (PLANS if planned else [])
        for plan in plans:
            if plan is not None:
                ty, threads = plan
                k1.tile_plan = (lambda Y, X, K, ty=ty, threads=threads:
                                k1.TilePlan(ty, k1.TILE_X, -(-Y // ty),
                                            -(-X // k1.TILE_X), threads,
                                            k1.tile_smem_bytes(
                                                ty, k1.TILE_X, K)))
            name = "default" if plan is None else f"{plan[0]}x32_t{plan[1]}"
            try:
                got = k1.march_rebin(*args, slots, dt, st.marker_count,
                                     dead=dead)
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                fns = {"K1": lambda: k1.march_rebin(
                    *args, slots, dt, st.marker_count, dead=dead)}
                if K == 8:
                    fns["K4"] = lambda: k1.march_rebin_padded(
                        *args, padded, dt, st.marker_count, dead=dead)
                case = {"bitwise": same, "live": live}
                for kname, fn in fns.items():
                    case[f"{kname}_ms"] = cuda_ms(fn)
                    case[f"{kname}_device_ms"] = device_ms(fn)
                    case[f"{kname}_host_us"] = host_us(fn)
            except RuntimeError as e:  # a plan the card refuses
                case = {"error": str(e)}
            finally:
                if planned:
                    k1.tile_plan = default_plan
            out["cases"][f"K{K}_{name}"] = case
            print(f"K={K} {name}: {case}", file=sys.stderr, flush=True)
        time_unfused(out, K, cfg, scn, st, dt)
        if K == 8:
            ty = k1.tile_plan(Y, X, K).tile_y if planned else 32
            tiles = st.marker_count.reshape(-1, ty, X // 32, 32)
            out["live_tiles_K8"] = int((tiles.sum((1, 3)) > 0).sum())
            for var in VARIANTS:
                vcfg, vdt, vcount = cfg, dt, st.marker_count
                if var == "empty":
                    vcount = torch.zeros_like(vcount)
                elif var == "dt0":
                    vdt = torch.zeros_like(dt)
                else:
                    vcfg = dataclasses.replace(cfg, marker_march_iters=0)
                vargs = (vcfg,) + args[1:]
                fn = (lambda: k1.march_rebin(*vargs, slots, vdt, vcount,
                                             dead=dead))
                out["cases"][f"K8_{var}"] = {"K1_ms": cuda_ms(fn),
                                             "K1_device_ms": device_ms(fn)}
                print(f"K=8 {var}: {out['cases'][f'K8_{var}']}",
                      file=sys.stderr, flush=True)
        del st, scn, padded, want
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the tree whose euler_tpu_torch is timed")
    ap.add_argument("--label", default="tree")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("marker_tile_lab: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(run(args.label)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
