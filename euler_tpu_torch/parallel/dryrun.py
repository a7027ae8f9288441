"""Ranks on one host, and the port's multi-rank dry run
(`__graft_entry__.py:26` `dryrun_multichip`, on `torch.distributed`).

    python -m euler_tpu_torch.parallel.dryrun 4 --backend gloo   # CPU
    python -m euler_tpu_torch.parallel.dryrun 1 --backend nccl   # a card

`launch(n, backend, fn, *args)` starts n processes (spawned, so each
imports torch and the port afresh), joins them into one default group
through a `file://` store in a directory of its own, and runs `fn(*args)`
on every rank: gloo ranks on the CPU, or NCCL ranks on cards n of them
(rank r on card r).  The caller names the backend; nothing falls back.
`fn` must be importable by name (a module-level function); it returns a
dict of arrays, which `launch` hands back one dict a rank.  A rank that
fails, or a run that outlasts LAUNCH_TIMEOUT_S, ends every rank and
raises.

`dryrun_multichip` runs the JAX dry run's paths (`__graft_entry__.py:
26`) and asserts what it asserts, and more:
  1. the batch on `make_mesh`'s own layout (data = 2, y = 2 at 4 ranks;
     data = 2, y = 2, x = 2 at 8) in the global marker layout, as the JAX
     run keeps it: `make_sharded_step` steps each data rank's instances
     on its block, every block holding each instance's whole [2, M]
     store;
  2. `spatial.make_spatial_step`, the whole frame on blocks (y = n, or
     y = n / 2 and x = 2);
  3. `cuda_shard.make_spatial_step_pallas` at nx = 128;
  4. K1 per row shard (`make_sharded_marker_pass`), bitwise the
     unsharded K1;
  5. the data-parallel K2 on a data-only mesh, bitwise
     `project_substep_mg`.
Paths 1-3 are held to the unsharded frames (counts, alive and drops
equal, u and v within FRAME_ATOL: the solve on blocks, P4, folds its
sums in another order than K8).  Where the JAX run differs: a block
holds at least the marker pass's 8 halo rows and columns, so the grids
have 8 rows a block.  Paths 1 and 2 split columns as the JAX run does
(`__graft_entry__.py:64-66`): x = 2 where the rank count is even and at
least 8, else x = 1.
"""

from __future__ import annotations

import argparse
import multiprocessing
import multiprocessing.connection
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import numpy as np

BACKEND_DEVICE = {"gloo": "cpu", "nccl": "cuda"}
# how long a launch may run; the group's own collectives time out sooner
LAUNCH_TIMEOUT_S = 600.0


def _rank_main(rank: int, n: int, backend: str, store: str, out: str, fn,
               args) -> None:
    import torch
    import torch.distributed as dist

    # ranks share the host's cores
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=n, rank=rank,
                            timeout=timedelta(seconds=120))
    try:
        result = fn(*args) or {}
        np.savez(Path(out) / f"rank{rank}.npz",
                 **{k: np.asarray(v) for k, v in result.items()})
    finally:
        dist.destroy_process_group()


def launch(n: int, backend: str, fn, *args):
    """Run fn(*args) on n ranks of a new default group (see the top of
    this module); returns each rank's dict of numpy arrays, rank order."""
    if backend not in BACKEND_DEVICE:
        raise ValueError(f"backend {backend!r}: gloo (CPU) or nccl (cards)")
    if backend == "nccl":
        import torch

        if torch.cuda.device_count() < n:
            raise RuntimeError(f"{n} NCCL ranks need {n} cards; this host "
                               f"has {torch.cuda.device_count()}")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="euler_ranks_") as tmp:
        store = str(Path(tmp) / "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n, backend, store, tmp, fn, args))
                 for r in range(n)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + LAUNCH_TIMEOUT_S
            running = list(procs)
            while running:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{n} {backend} ranks ran past "
                                       f"{LAUNCH_TIMEOUT_S} s")
                multiprocessing.connection.wait(
                    [p.sentinel for p in running], left)
                for p in [p for p in running if not p.is_alive()]:
                    p.join()
                    running.remove(p)
                    if p.exitcode != 0:
                        raise RuntimeError(
                            f"rank {procs.index(p)} of {n} ({backend}) "
                            f"exited with {p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        results = []
        for r in range(n):
            with np.load(Path(tmp) / f"rank{r}.npz") as f:
                results.append({k: f[k] for k in f.files})
        return results


def _texts(count: int, nx: int):
    """The JAX dry run's distinct tiny scenarios (sources, solids)."""
    texts = []
    for i in range(count):
        interior = nx - 2
        rows = ["?" * 2 + " " * (interior - 2), "0" * (3 + i % 3),
                " " * (interior // 2) + "X" * 2]
        texts.append(("\n".join(rows) + "\n").encode())
    return texts


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# how far the frames on row blocks may stray from the unsharded frames in
# u and v (the counts, alive plane and drops must be equal)
FRAME_ATOL = 1e-4


def _close_frames(got, want, what: str) -> None:
    import torch

    for name in ("marker_count", "alive", "alive_count", "dropped_markers",
                 "frame_count"):
        _check(torch.equal(getattr(got, name), getattr(want, name)),
               f"{what}: {name} differs from the unsharded frames")
    for name in ("u", "v"):
        d = float((getattr(got, name) - getattr(want, name)).abs().max())
        _check(d <= FRAME_ATOL, f"{what}: {name} off by {d:.3g}")


def column_split(n: int) -> int:
    """The JAX dry run's "x" for n devices (`__graft_entry__.py:64-66`)."""
    return 2 if n % 2 == 0 and n >= 8 else 1


def _dryrun_rank(n: int, backend: str) -> dict:
    """The dry run's five paths on this rank; returns its figures."""
    import torch

    from euler_tpu_torch import sim
    from euler_tpu_torch.config import SimConfig, SolverConfig
    from euler_tpu_torch.core.presets import dam_break
    from euler_tpu_torch.core.scenario import build_scenario
    from euler_tpu_torch.ops.cuda.substep_kernel import project_substep_mg
    from euler_tpu_torch.ops.forces import max_speed_sq
    from euler_tpu_torch.ops.markers_slots import marker_pass_slots
    from euler_tpu_torch.parallel.batch import build_batch, step_frame_batched
    from euler_tpu_torch.parallel.cuda_shard import (
        make_dp_substep_mg,
        make_sharded_marker_pass,
        make_spatial_step_pallas,
    )
    from euler_tpu_torch.parallel.mesh import (
        all_gather_cat,
        gather_batch,
        make_mesh,
        make_sharded_step,
        mesh_device,
        shard_batch,
    )
    from euler_tpu_torch.parallel.spatial import (
        gather_spatial,
        make_spatial_step,
        shard_spatial,
        spatial_mesh,
        to_spatial,
    )

    device = BACKEND_DEVICE[backend]
    x = column_split(n)
    # 1. the batch on make_mesh's own layout (data x y x x), in the global
    # marker layout (SimConfig's default): distinct scenarios (sources,
    # solids), each data rank stepping its instances on its block
    mesh = make_mesh(n, x=x, device=device)
    data, ys = mesh.mesh.shape[0], mesh.mesh.shape[1]
    dev = mesh_device(mesh)
    cfg = SimConfig(nx=16, ny=8 * ys, max_substeps=2,
                    solver=SolverConfig(max_iterations=8))
    texts = _texts(max(2, data), cfg.nx)
    scn, st = build_batch(texts, cfg, device=dev)
    out = gather_batch(mesh, make_sharded_step(cfg, mesh)(
        *shard_batch(mesh, scn, st)))
    ref = step_frame_batched(cfg, scn, st)
    _check(int(out.frame_count.sum()) == len(texts), "batch: frames")
    _close_frames(out, ref, f"batch on data={data} x y={ys} x x={x}")

    # 2. the whole frame on blocks (the JAX run's smesh)
    smesh = spatial_mesh(n, x=x, device=device)
    cfg_s = SimConfig(nx=16 * x, ny=8 * (n // x), marker_layout="slots",
                      max_substeps=2, solver=SolverConfig(max_iterations=8))
    scn_s, st_s = build_scenario(texts[0], cfg_s, device=dev)
    out_s = gather_spatial(cfg_s, smesh, make_spatial_step(cfg_s, smesh)(
        *shard_spatial(cfg_s, smesh, scn_s, st_s)))
    _check(int(out_s.frame_count) == 1 and int(out_s.alive_count) > 0,
           "spatial step: no frame or no marker alive")
    _close_frames(out_s, sim.step_frame(cfg_s, scn_s, to_spatial(cfg_s,
                                                                 st_s)),
                  "spatial step")

    # 3. the frame on row blocks with the row-sharded K1, nx = 128 as the
    # JAX run's
    pmesh = spatial_mesh(n, x=1, device=device)
    cfg_p = SimConfig(nx=128, ny=max(8 * n, 16), marker_layout="slots",
                      max_substeps=2, solver=SolverConfig(max_iterations=8))
    scn2, st2 = build_scenario(texts[0], cfg_p, device=dev)
    out_p = gather_spatial(cfg_p, pmesh, make_spatial_step_pallas(
        cfg_p, pmesh)(*shard_spatial(cfg_p, pmesh, scn2, st2)))
    _check(int(out_p.frame_count) == 1 and int(out_p.alive_count) > 0,
           "pallas step: no frame or no marker alive")
    _close_frames(out_p, sim.step_frame(cfg_p, scn2, st2), "pallas step")

    # 4. K1 per row shard on the "y"-only mesh
    st2 = sim.step_frame(cfg_p, scn2, st2)
    dt = sim._dt_from_msq(cfg_p, max_speed_sq(cfg_p, st2.u, st2.v),
                          torch.full((), cfg_p.frame_time, device=dev))
    blocks = shard_spatial(cfg_p, pmesh, scn2, st2)
    got = gather_spatial(cfg_p, pmesh, make_sharded_marker_pass(
        cfg_p, pmesh)(cfg_p, *blocks, dt))
    want = marker_pass_slots(cfg_p, scn2, st2, dt)
    for name in ("markers", "alive", "marker_count", "alive_count",
                 "dropped_markers"):
        _check(torch.equal(getattr(got, name), getattr(want, name)),
               f"marker pass: {name} differs from the unsharded K1")
    _check(int(got.alive_count) > 0, "marker pass: no marker alive")

    # 5. K2 on one instance a rank of a data-only mesh (replicated: every
    # rank the same)
    dmesh = make_mesh(n, data=n, device=device)
    cfg_f = SimConfig(nx=64, ny=64, marker_layout="slots",
                      solver=SolverConfig(max_iterations=16,
                                          preconditioner="mg", tol_rel=1e-3,
                                          warm_start=True))
    scn4, st4 = dam_break(cfg_f, device=dev)
    one = (st4.u, st4.v, st4.fluid, st4.prev_fluid, scn4.solid, st4.p)
    dt4 = torch.full((), 0.03, device=dev)
    u2, v2, iters, resid, msq, p = make_dp_substep_mg(cfg_f, dmesh)(
        dt4, dt4, *(a[None] for a in one))
    _check(tuple(u2.shape) == (1, cfg_f.ny, cfg_f.nx), "dp substep: shape")
    every = all_gather_cat(u2, dmesh.get_group("data"), 0)
    _check(all(torch.equal(every[0], every[i]) for i in range(n)),
           "dp substep: the ranks' substeps differ")
    ref4 = project_substep_mg(cfg_f, dt4, dt4, *one)
    _check(torch.equal(u2[0], ref4[0]) and torch.equal(p[0], ref4[5]),
           "dp substep: differs from project_substep_mg")
    _check(int(iters[0]) > 0 and float(msq[0]) > 0.0, "dp substep: idle")
    return {"batch": len(texts), "frames": int(out.frame_count.sum()),
            "layout": torch.tensor(mesh.mesh.shape),
            "spatial_alive": int(out_s.alive_count),
            "pallas_alive": int(out_p.alive_count),
            "alive_count": int(got.alive_count),
            "dropped": int(got.dropped_markers), "iters": int(iters[0]),
            "msq": float(msq[0])}


def dryrun_multichip(n: int, backend: str = "gloo") -> list[dict]:
    """The five paths on n ranks; prints one line a path and returns
    each rank's figures."""
    results = launch(n, backend, _dryrun_rank, n, backend)
    r0 = results[0]
    data, ys, x = (int(v) for v in r0["layout"])
    print(f"batch: {int(r0['batch'])} instances over data={data} x "
          f"y={ys} x x={x}, global marker layout, {int(r0['frames'])} "
          "frames, the unsharded batch's counts")
    print(f"spatial step: {16 * x} x {8 * (n // x)} on {n // x} x {x} "
          f"blocks, alive_count {int(r0['spatial_alive'])}, the unsharded "
          "frame's counts")
    print(f"pallas step: 128 x {max(8 * n, 16)} on {n} row blocks, "
          f"alive_count {int(r0['pallas_alive'])}, the unsharded frame's "
          "counts")
    print(f"marker pass: K1 on {n} row shards of 128 x {max(8 * n, 16)}, "
          f"alive_count {int(r0['alive_count'])}, dropped "
          f"{int(r0['dropped'])}, bitwise the unsharded K1")
    print(f"dp substep: K2 on {n} ranks, {int(r0['iters'])} iterations, "
          f"msq {float(r0['msq']):.6g}, every rank the same")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ranks", type=int, nargs="?", default=4)
    ap.add_argument("--backend", choices=sorted(BACKEND_DEVICE),
                    required=True)
    args = ap.parse_args(argv)
    dryrun_multichip(args.ranks, args.backend)
    print(f"dryrun_multichip({args.ranks}, {args.backend!r}) OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
