"""What the gloo ranks of tests/test_torch_shard.py and
tests/test_torch_mesh.py compute: module-level functions that
`parallel.dryrun.launch` runs on every rank.  This module imports torch
and the port only (the ranks are spawned processes that never import
JAX or a test module); the tests hold the arrays the ranks return
against the JAX package's single-device functions.

Every rank builds the same developed state from a seed on the CPU, so
the tests can rebuild any of it in the parent process.
"""

from __future__ import annotations

import dataclasses

import torch

from euler_tpu_torch import convert, sim
from euler_tpu_torch.config import SimConfig, SolverConfig
from euler_tpu_torch.core.presets import dam_break
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda.marker_fused_kernel import march_rebin
from euler_tpu_torch.ops.forces import max_speed_sq
from euler_tpu_torch.parallel.batch import build_batch, step_frame_batched
from euler_tpu_torch.parallel.cuda_shard import (
    H,
    exchange_rows,
    make_dp_substep_mg,
    make_sharded_march_rebin,
    make_sharded_marker_pass,
)
from euler_tpu_torch.parallel.mesh import (
    gather_batch,
    make_mesh,
    make_sharded_step,
    shard_batch,
)
from euler_tpu_torch.parallel.spatial import (
    gather_spatial,
    shard_spatial,
    spatial_mesh,
)

SHARD_NX = 128  # the JAX dry run's width for the marker kernel
DEVELOP_FRAMES = 3
# the data axis: tests/test_parallel.py:55-60's configuration and batch
DATA_CFG = SimConfig(nx=32, ny=16, max_substeps=2,
                     solver=SolverConfig(max_iterations=30))
DATA_TEXTS = [b"00000\n00000\n", b"  000\nX 000\n"]
HOOK_FRAMES = 2
# the data-parallel K2: tests/test_substep_shard.py:18-23's configuration
DP_CFG = SimConfig(nx=64, ny=64, marker_layout="slots",
                   solver=SolverConfig(max_iterations=32, preconditioner="mg",
                                       tol_rel=1e-3, warm_start=True))
DP_DT = 0.02


def main_config(nx: int, ny: int) -> SimConfig:
    """bench.py's main path (slots K=8, MG-PCG to tol_rel 1e-4, warm
    start, fused projection) at nx x ny."""
    return SimConfig(nx=nx, ny=ny, marker_layout="slots",
                     solver=SolverConfig(max_iterations=100, tol_rel=1e-4,
                                         preconditioner="mg",
                                         warm_start=True,
                                         fuse_projection=True))


def developed(cfg: SimConfig, frames: int, seed: int = 0):
    """The dam break advanced `frames` frames on the CPU."""
    scn, st = dam_break(cfg, seed=seed, device="cpu")
    for _ in range(frames):
        st = sim.step_frame(cfg, scn, st)
    return scn, st


def cfl_dt(cfg: SimConfig, st):
    return sim._dt_from_msq(cfg, max_speed_sq(cfg, st.u, st.v),
                            torch.full((), cfg.frame_time))


def layouts(n: int) -> dict:
    """The shapes of the meshes the JAX package's rules give n devices."""
    out = {"mesh": make_mesh(n, device="cpu").mesh.shape,
           "spatial": spatial_mesh(n, device="cpu").mesh.shape}
    if n % 2 == 0:
        out["mesh_x2"] = make_mesh(n, x=2, device="cpu").mesh.shape
    return {k: torch.tensor(v) for k, v in out.items()}


def k1_rank(ny: int, n: int) -> dict:
    """K1 per row shard on a "y" mesh of n ranks, on the developed dam
    break at SHARD_NX x ny: the shard's exchanged [.., Yl + 2H, X]
    inputs and K1's outputs on them (`pad_*`, `out_*`); the cropped
    outputs of `make_sharded_march_rebin` (`shard_*`); the block of the
    state that `make_sharded_marker_pass` gives (`pass_*`); the mesh
    layouts; and, on rank 0, the whole developed state (`full_*`)."""
    cfg = main_config(SHARD_NX, ny)
    K, X = cfg.slots_per_cell, cfg.nx
    mesh = spatial_mesh(n, x=1, device="cpu")
    r, Yl = mesh.get_local_rank("y"), ny // n
    scn, st = developed(cfg, DEVELOP_FRAMES)
    dt = cfl_dt(cfg, st)
    bscn, bst = shard_spatial(cfg, mesh, scn, st)
    planes = {"u": bst.u, "v": bst.v, "fluid": bst.fluid,
              "solid": bscn.solid,
              "slots": bst.markers.reshape(2 * K, Yl, X),
              "count": bst.marker_count, "dead": bscn.sink | bscn.solid}
    out = {}
    for name, a in planes.items():
        below, above = exchange_rows(a, mesh, H)
        out[f"pad_{name}"] = torch.cat([below, a, above], -2)
    p = [out[f"pad_{k}"] for k in planes]
    _build.PLAIN_CALLS.clear()
    o, c, d = march_rebin(dataclasses.replace(cfg, ny=Yl + 2 * H), *p[:5],
                          dt, p[5], dead=p[6], clamp_ny=ny,
                          row_offset=r * Yl - H)
    out.update(out_slots=o, out_count=c, out_drop=d)
    so, sc, sd = make_sharded_march_rebin(cfg, mesh)(
        *(planes[k] for k in ("u", "v", "fluid", "solid", "slots")), dt,
        planes["count"], planes["dead"])
    out.update(shard_slots=so, shard_count=sc, shard_drop=sd)
    got = make_sharded_marker_pass(cfg, mesh)(cfg, bscn, bst, dt)
    for name in ("markers", "alive", "marker_count", "alive_count",
                 "dropped_markers"):
        out[f"pass_{name}"] = getattr(got, name)
    whole = gather_spatial(cfg, mesh, got)
    out["gathered_markers"] = whole.markers
    out["k1_plain_calls"] = torch.tensor(_build.PLAIN_CALLS["K1"])
    out.update(dt=dt, row_offset=torch.tensor(r * Yl - H))
    out.update({f"layout_{k}": v for k, v in layouts(n).items()})
    if r == 0:
        out.update({f"full_{k}": torch.as_tensor(v) for k, v in
                    convert.state_to_numpy(st).items()})
        out.update({f"full_{k}": torch.as_tensor(v) for k, v in
                    convert.scenario_to_numpy(scn).items()})
    return out


def _raises(fn) -> str:
    """The message of the NotImplementedError or ValueError fn() raises
    ("" when it raises none)."""
    try:
        fn()
    except (NotImplementedError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def mesh_rank() -> dict:
    """On a data-only mesh of 2 ranks: the data axis on tests/
    test_parallel.py's batch (gathered); each rank's dam break stepped
    with the row-sharded marker pass in `step_frame` on its "y" of one
    rank, and without; K2 on each rank's instance with its inputs; and
    the refusals, as their messages."""
    n = 2
    dmesh = make_mesh(n, data=n, device="cpu")
    rank = dmesh.get_local_rank("data")
    out = {}

    scn, st = build_batch(DATA_TEXTS, DATA_CFG, device="cpu")
    got = gather_batch(dmesh, make_sharded_step(DATA_CFG, dmesh)(
        *shard_batch(dmesh, scn, st)))
    want = step_frame_batched(DATA_CFG, scn, st)
    out.update({f"data_{k}": v for k, v in
                convert.state_to_numpy(got).items()})
    out["data_bitwise"] = torch.tensor(all(
        torch.equal(getattr(got, f.name), getattr(want, f.name))
        for f in dataclasses.fields(got) if f.name != "rng")
        and torch.equal(got.rng.to(torch.int64), want.rng.to(torch.int64)))

    cfg = main_config(32, 32)
    scn, st0 = dam_break(cfg, seed=rank, device="cpu")
    marker_pass = make_sharded_marker_pass(cfg, dmesh)
    hooked, plain = st0, st0
    _build.PLAIN_CALLS.clear()
    for _ in range(HOOK_FRAMES):
        hooked = sim.step_frame(cfg, scn, hooked, marker_pass=marker_pass)
    out["hook_k1_calls"] = torch.tensor(_build.PLAIN_CALLS["K1"])
    for _ in range(HOOK_FRAMES):
        plain = sim.step_frame(cfg, scn, plain)
    a, b = convert.state_to_numpy(hooked), convert.state_to_numpy(plain)
    out["hook_bitwise"] = torch.tensor(all(
        (a[k] == b[k]).all() for k in a))

    dscn, dst = developed(DP_CFG, 2, seed=rank)
    inputs = {"u": dst.u, "v": dst.v, "fluid": dst.fluid,
              "prev_fluid": dst.prev_fluid, "solid": dscn.solid, "p": dst.p}
    dt = torch.full((), DP_DT)
    res = make_dp_substep_mg(DP_CFG, dmesh)(
        dt, dt, *(a[None] for a in inputs.values()))
    out.update({f"dp_in_{k}": v for k, v in inputs.items()})
    out.update({f"dp_out_{k}": v for k, v in zip(
        ("u", "v", "iters", "resid", "msq", "p"), res)})

    ymesh = make_mesh(n, data=1, device="cpu")
    out["refuse_step"] = _raises(lambda: make_sharded_step(DATA_CFG, ymesh))
    out["refuse_cuda"] = _raises(lambda: make_mesh(n, device="cuda"))
    out["refuse_world"] = _raises(lambda: make_mesh(n + 1, device="cpu"))
    out.update({f"layout_{k}": v for k, v in layouts(n).items()})
    return out
