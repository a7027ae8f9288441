"""The MG main path's frame time and its solvers' times on an NVIDIA GPU,
for one tree of the repo; run it on two trees in turns, in one session
on one card, to compare them.

    python3 tools/solver_ab_lab.py [--tree DIR] [--label NAME]

Imports `euler_tpu_torch` and `chip_smoke` from DIR (the tree this file
lies in by default) and builds DIR's kernels of the path.  On the 1024²
dam break of the main path (`chip_smoke.main_config`: K1, K2, K3; 4
warm-up frames) it prints:
  * the main path's ms/frame over 20 frames (`chip_smoke.run_path`);
  * K3 (`mg_kernel.solve_pressure_mg`, warm from the state's pressure),
    K2 (`substep_kernel.project_substep_mg`) and P3
    (`pcg_general_kernel.solve_pressure_general`, warm) on that state:
    ms a call by CUDA events around 5 back-to-back calls, best of 3
    rounds, then the summed spans of the port's kernels over one
    profiled call (`chip_smoke.kernel_spans_ms`; profiles last, as a
    profiler session slows the host's later launches);
  * the card's name and power limit, and one JSON line of it all.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import sys
from pathlib import Path

ROUNDS = 3
REPS = 5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve()
                                          .parents[1]))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from euler_tpu_torch import sim
    from euler_tpu_torch.core.presets import dam_break
    from euler_tpu_torch.ops.cuda import grid_kernel as k7
    from euler_tpu_torch.ops.cuda import marker_fused_kernel as k1
    from euler_tpu_torch.ops.cuda import mg_kernel as k3
    from euler_tpu_torch.ops.cuda import pcg_general_kernel as p3
    from euler_tpu_torch.ops.cuda import substep_kernel as k2

    loaders = (k1.marker_lib, k7.grid_lib, k3._lib, p3.mg_lib)
    with concurrent.futures.ThreadPoolExecutor(len(loaders)) as pool:
        for fut in [pool.submit(f) for f in loaders]:
            fut.result()
    cfg = cs.main_config(cs.SIZE)
    scn, st = dam_break(cfg, device="cuda")
    for _ in range(cs.WARMUP_FRAMES):
        st = sim.step_frame(cfg, scn, st)
    st, path = cs.run_path(cfg, scn, st, cs.FRAMES, ["K1", "K2", "K3"],
                           f"{args.label} MG main path")
    out = {"label": args.label, "ms_per_frame": path["ms_per_frame"],
           "pcg_iters_per_active_substep":
               path["pcg_iters_per_active_substep"],
           "div_inf": path["div_inf"]}
    fl, pfl = st.fluid, st.prev_fluid
    dt, _, _, b, a_diag = cs.substep_system(cfg, scn, st)
    x0 = torch.where(fl, st.p, 0.0)
    calls = {
        "K3": lambda: k3.solve_pressure_mg(cfg, b, a_diag, fl, x0=st.p),
        "K2": lambda: k2.project_substep_mg(cfg, dt, dt, st.u, st.v, fl,
                                            pfl, scn.solid, st.p),
        "P3": lambda: p3.solve_pressure_general(cfg, b, a_diag, fl, x0=x0),
    }
    for name, fn in calls.items():
        ms = [cs.cuda_ms(fn, REPS) for _ in range(ROUNDS)]
        out[f"{name}_ms"] = min(ms)
        print(f"   {args.label} {name}: {' / '.join(f'{t:.3f}' for t in ms)}"
              f" ms a call (CUDA events, {REPS} calls a round)", flush=True)
    for name, fn in calls.items():
        spans = cs.kernel_spans_ms(fn)
        out[f"{name}_device_ms"] = spans and spans[0]
        print(f"   {args.label} {name}: kernel spans "
              f"{'not recorded' if spans is None else f'{spans[0]:.4f}'} "
              "ms over one profiled call", flush=True)
    out["card"] = cs.smi_line()
    print(f"   nvidia-smi: {out['card']}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
