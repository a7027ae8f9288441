"""Compare one run of the reference-binary corpus three ways: the JAX
package compiled (its test's `step_frame_jit`), the JAX package op by op
(`step_frame` under `jax.disable_jit()`, so XLA fuses nothing across
operations) and the PyTorch port on the CPU, frame by frame against the
corpus (tests/goldens/ref_binary/).

    JAX_PLATFORMS=cpu python3 tools/ref_binary_opbyop.py filter --rainbow \
        --frames 16

The configuration is the ref-binary tests' (the default SimConfig, f64
Jacobi with max_iterations 400, a 60 x 130 window).  Prints a line a
frame: whether the op-by-op JAX bytes equal the port's, the corpus's and
the compiled JAX bytes, and whether the compiled JAX bytes and the
port's equal the corpus.  Where the op-by-op bytes equal the port's and
not the corpus, the port computes the JAX package's operations and the
compiled frame parts from them by XLA's compilation (its FMA
contraction).  Op by op is slow: ~10 s a frame of filter.txt.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenario", help="a scenario of scenarios/, no .txt")
    ap.add_argument("--rainbow", action="store_true")
    ap.add_argument("--frames", type=int, default=16)
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import torch

    from euler_tpu.config import SimConfig, SolverConfig
    from euler_tpu.core.scenario import build_scenario
    from euler_tpu.render.ansi import draw_frame
    from euler_tpu.sim import step_frame, step_frame_jit
    from euler_tpu_torch import sim as psim
    from euler_tpu_torch.core.scenario import load_scenario
    from euler_tpu_torch.render.ansi import draw_frame as pdraw
    from global_states import golden_config
    from helpers import read_scenario
    from test_torch_ref_binary import WINDOW, blobs

    torch.set_num_threads(1)
    want = blobs(args.scenario, args.rainbow)
    cfg = SimConfig(rainbow=args.rainbow, solver=SolverConfig(
        dtype="float64", max_iterations=400))
    scn, st0 = build_scenario(read_scenario(f"{args.scenario}.txt"), cfg)
    pcfg = golden_config(rainbow=args.rainbow)
    pscn, pst = load_scenario(str(ROOT / "scenarios" / f"{args.scenario}.txt"),
                              pcfg, device="cpu")

    def frames(step, cfg, scn, st, draw):
        out = [draw(cfg, scn, st, *WINDOW)[3:-6]]
        for _ in range(args.frames):
            st = step(cfg, scn, st)
            out.append(draw(cfg, scn, st, *WINDOW)[3:-6])
        return out

    port = frames(psim.step_frame, pcfg, pscn, pst, pdraw)
    compiled = frames(step_frame_jit, cfg, scn, st0, draw_frame)
    t0 = time.time()
    with jax.disable_jit():
        op = frames(step_frame, cfg, scn, st0, draw_frame)
    print(f"op by op: {time.time() - t0:.0f} s")
    for f in range(1, args.frames + 1):
        print(f"frame {f}: op==port {op[f] == port[f]} op==corpus "
              f"{op[f] == want[f]} op==compiled {op[f] == compiled[f]} "
              f"compiled==corpus {compiled[f] == want[f]} port==corpus "
              f"{port[f] == want[f]}", flush=True)


if __name__ == "__main__":
    main()
