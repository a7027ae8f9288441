#!/usr/bin/env python3
"""Where P7 (the rediscretized MG PCG) stops, against its plain version
and against the plain loop with its sums in another order.

    python3 tools/p7_count_diag.py

Needs an NVIDIA GPU.  On the systems of tests/test_torch_cuda_mg_rbgs.py
(a dam break developed 2 frames on the card, at 999², 1080 x 1920 and
1024²), in f32 and f64, prints one line a system and dtype with the
largest difference between one V-cycle of P7 and the plain `v_cycle`,
and, cold and warm, the iterations of: P7; the plain solve; the plain
loop (`ops/project.pcg_loop`) with P7's own V-cycle as its
preconditioner; and the plain loop with its dot products summed in f64,
by `torch.dot` and on the host.  Where these counts differ while the
V-cycles agree bit for bit, where a solve stops rides on the loop's
rounding, not on the kernel.
"""

from __future__ import annotations

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import test_torch_cuda_mg_rbgs as T  # noqa: E402

from euler_tpu_torch.ops import multigrid  # noqa: E402
from euler_tpu_torch.ops.cuda import pcg_general_kernel as p3  # noqa: E402
from euler_tpu_torch.ops.project import (  # noqa: E402
    apply_a,
    make_preconditioner,
    pcg_loop,
)

# the plain loop's dot products in other orders
DOTS = {
    "plain+f64dot": lambda u, v: (u.double() * v.double()).sum().to(u.dtype),
    "plain+torch.dot": lambda u, v: torch.dot(u.reshape(-1), v.reshape(-1)),
    "plain+cpu-sum": lambda u, v: (u * v).cpu().sum().to(u.device),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    for size in ("999x999", "1080x1920", "1024x1024"):
        b, a, fl, so, p0 = T._system(size)
        for dt in ("f32", "f64"):
            cfg = T._config(size, "rediscretize", dt)
            f = getattr(torch, cfg.solver.dtype)
            bb = b.to(f)
            p3.solve_pressure_general(cfg, bb, a, fl, solid=so)
            ws = p3.workspace(cfg, bb.device)
            zk = ws.cycle(bb)
            zp = multigrid.make_mg_preconditioner(cfg, so, fl, f)(bb)
            print(f"DIAG {size} {dt} vcycle max diff "
                  f"{(zk - zp).abs().max().item():.3g} equal "
                  f"{torch.equal(zk, zp)}", flush=True)
            A = lambda s_: apply_a(a, fl, s_)  # noqa: E731
            pre = make_preconditioner(cfg, a, fl, so)
            for warm in (False, True):
                x0 = torch.where(fl, p0, 0.0).to(f) if warm else None
                k = p3.solve_pressure_general(cfg, bb, a, fl, x0=x0,
                                              solid=so)
                pl = p3.solve_pressure_general_plain(cfg, bb, a, fl, x0, so)
                kc = pcg_loop(cfg, bb, A, lambda r: ws.cycle(r.contiguous()),
                              x0=x0)
                counts = " ".join(
                    f"{name} {int(pcg_loop(cfg, bb, A, pre, x0=x0, dot=dot)[1])}"
                    for name, dot in DOTS.items())
                print(f"DIAG {size} {dt} {'warm' if warm else 'cold'}: "
                      f"kernel {int(k[1])} plain {int(pl[1])} "
                      f"plain-loop+kernel-cycle {int(kc[1])} {counts}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
