"""How far the frame on blocks strays from the frame on one block, frame
by frame, on an NVIDIA GPU.

    python3 tools/block_drift_lab.py [--size 1024] [--frames 5]

Runs the dam break in the Jacobi speed mode (`chip_smoke.speed_config`:
100 iterations, far from convergence) through `spatial.make_spatial_step`
on in-process blocks (`comm.LocalGroup`) of one card: 1 block, 4 x 1 row
blocks, 2 x 2 and 1 x 2 blocks, with the solve in f32 (the mode's own)
and in f64.  The blocks' code computes the 1-block frame but for the
order in which P4 folds its sums over the blocks; the f64 solve shows how
much of the distance that order makes.  Prints a line a layout and
frame: the cells whose marker count differs from 1 block's, the largest
velocity difference, and the first cells that differ; then the card's
name and power limit.  Builds the kernels first (`chip_smoke.build_all`).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LAYOUTS = ((4, 1), (2, 2), (1, 2))


def frames(cfg, scn, st, y: int, x: int, n: int, dev):
    """n frames of `make_spatial_step` on y x x blocks; each frame's whole
    state."""
    from euler_tpu_torch.parallel import spatial
    from euler_tpu_torch.parallel.comm import LocalGroup

    def rank(comm):
        step = spatial.make_spatial_step(cfg, comm)
        bscn, b = spatial.shard_spatial(cfg, comm, scn, st)
        out = []
        for _ in range(n):
            b = step(bscn, b)
            out.append(spatial.gather_spatial(cfg, comm, b))
        return out

    with LocalGroup(y, x, device=dev) as g:
        return g.run(rank)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--frames", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from euler_tpu_torch.core.presets import dam_break

    if not torch.cuda.is_available():
        print("block_drift_lab: no CUDA device", file=sys.stderr)
        return 2
    with cs.Phase("build kernels"):
        cs.build_all()
    dev = torch.device("cuda", 0)
    for dtype in ("float32", "float64"):
        cfg = cs.speed_config(args.size)
        cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, dtype=dtype))
        scn, st = dam_break(cfg, device=dev)
        t0 = time.perf_counter()
        one = frames(cfg, scn, st, 1, 1, args.frames, dev)
        for y, x in LAYOUTS:
            got = frames(cfg, scn, st, y, x, args.frames, dev)
            for f, (a, b) in enumerate(zip(got, one)):
                d = cs.frame_diff(a, b)
                cells = (a.marker_count != b.marker_count).nonzero()
                cs.log(f"{args.size}² dam break, {dtype} solve, {y} x {x} "
                       f"blocks, frame {f + 1}: {d['count_cells']} cells' "
                       f"counts apart, max |dv| {d['max_dv']:.3g}; first "
                       f"cells {cells[:8].tolist()}")
        cs.log(f"{dtype}: {time.perf_counter() - t0:.1f} s")
    cs.log(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
