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
    rank, and without; K2 on each rank's instance with its inputs; the
    same batch, in the global layout, on a "y" of 2 ranks (`yblock_*`);
    and the refusals, as their messages."""
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
    scn, st = build_batch(DATA_TEXTS, DATA_CFG, device="cpu")
    got = gather_batch(ymesh, make_sharded_step(DATA_CFG, ymesh)(
        *shard_batch(ymesh, scn, st)))
    out.update({f"yblock_{k}": v for k, v in
                convert.state_to_numpy(got).items()})
    out["refuse_cuda"] = _raises(lambda: make_mesh(n, device="cuda"))
    out["refuse_world"] = _raises(lambda: make_mesh(n + 1, device="cpu"))
    out.update({f"layout_{k}": v for k, v in layouts(n).items()})
    return out


# ---- the sharded solve and the frame on row blocks (M12 part c) -------

HALO_N = 64


def halo_system(which: str):
    """(b, fluid, solid) as numpy arrays: tests/test_halo.py:18-49's 64²
    system ("rows": seed 0, one solid bar) or tests/test_halo2d.py:25-58's
    ("blocks": seed 1, two solids)."""
    import numpy as np

    N = HALO_N
    rng = np.random.default_rng(0 if which == "rows" else 1)
    fluid = np.zeros((N, N), bool)
    fluid[1:-1, 1:-1] = True
    solid = np.zeros((N, N), bool)
    solid[20:24, 5:50] = True
    if which == "blocks":
        solid[40:44, 30:34] = True
    fluid &= ~solid
    b = rng.standard_normal((N, N)) * fluid
    return b, fluid, solid


def halo_config(precon: str, dtype: str = "float64", tol: float = 1e-10,
                **over) -> SimConfig:
    return SimConfig(nx=HALO_N, ny=HALO_N, solver=SolverConfig(
        max_iterations=600, tol=tol, dtype=dtype, preconditioner=precon,
        mg_min_size=8, **over))


def halo_block(comm, which: str, cfg: SimConfig, axes=("y",)):
    """This block's (b, a_diag, fluid) of `halo_system(which)` on the CPU,
    the grid split over the blocks of `comm` along `axes`."""
    from euler_tpu_torch.ops.project import pressure_matrix_diag

    b, fluid, solid = halo_system(which)
    fl = torch.as_tensor(fluid)
    a = pressure_matrix_diag(cfg, torch.as_tensor(solid), fl)
    bt = torch.as_tensor(b, dtype=getattr(torch, cfg.solver.dtype))
    ny, nx = comm.size("y"), comm.size("x") if "x" in axes else 1
    Yl, Xl = HALO_N // ny, HALO_N // nx
    ry, rx = comm.rank("y"), comm.rank("x") if "x" in axes else 0
    cut = (slice(ry * Yl, (ry + 1) * Yl), slice(rx * Xl, (rx + 1) * Xl))
    return bt[cut].contiguous(), a[cut].contiguous(), fl[cut].contiguous()


def seeded_plane(seed: int = 7):
    """A [64, 64] f64 plane from a seed, for the exchanges."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((HALO_N, HALO_N), generator=g, dtype=torch.float64)


def exchanged(comm, axes=("y", "x")) -> dict:
    """This block's cut of `seeded_plane` and what the exchanges give it:
    `halo.halo_exchange_rows` and, with "x", `halo_exchange_cols`."""
    from euler_tpu_torch.parallel import halo

    ny, nx = comm.size("y"), comm.size("x")
    Yl, Xl = HALO_N // ny, HALO_N // nx
    ry, rx = comm.rank("y"), comm.rank("x")
    x = seeded_plane()[ry * Yl:(ry + 1) * Yl, rx * Xl:(rx + 1) * Xl]
    below, above = halo.halo_exchange_rows(x.contiguous(), comm)
    out = {"below": below, "above": above, "ry": torch.tensor(ry),
           "rx": torch.tensor(rx)}
    if "x" in axes:
        out["left"], out["right"] = halo.halo_exchange_cols(
            x.contiguous(), comm)
    return out


def halo_rank() -> dict:
    """On 4 gloo ranks: the exchanges and the Jacobi solve (f64) on a
    ("y", "x") = 2 x 2 mesh of test_halo2d.py's system, and the block-MG
    solve (f32) on 4 row blocks of test_halo.py's."""
    from euler_tpu_torch.parallel.comm import MeshComm
    from euler_tpu_torch.parallel.halo import make_sharded_pressure_solver

    out = {}
    mesh2 = spatial_mesh(4, x=2, device="cpu")
    comm2 = MeshComm(mesh2)
    out.update({f"ex_{k}": v for k, v in exchanged(comm2).items()})
    cfg = halo_config("jacobi")
    solve = make_sharded_pressure_solver(cfg, mesh2, ("y", "x"), stats=True)
    p, it, res = solve(*halo_block(comm2, "blocks", cfg, ("y", "x")))
    out.update(jac2d_p=p, jac2d_iters=it, jac2d_resid=res)
    mesh4 = spatial_mesh(4, x=1, device="cpu")
    cfg = halo_config("mg", "float32", 1e-4)
    solve = make_sharded_pressure_solver(cfg, mesh4, stats=True)
    p, it, res = solve(*halo_block(MeshComm(mesh4), "rows", cfg))
    out.update(mg_p=p, mg_iters=it, mg_resid=res)
    return out


# tests/test_pallas_shard.py:30-33's configuration (the JAX package's
# frame solves on its jnp pcg_loop there, as P4 does on blocks)
FRAME_CFG = SimConfig(nx=64, ny=64, marker_layout="slots", max_substeps=2,
                      solver=SolverConfig(max_iterations=40,
                                          dtype="float32"))
FRAME_DEVELOP, FRAME_STEPS = 3, 2
# tests/test_spatial.py:29-37's: a source and solids
TEXT_CFG = SimConfig(nx=32, ny=16, marker_layout="slots", max_substeps=2,
                     solver=SolverConfig(max_iterations=30))
TEXT = b"?  00\n   00\nX  00\nXX 00\n"
TEXT_STEPS = 3
# the text with bench.py's converged MG solve (f32 Galerkin + Chebyshev,
# tol_rel 1e-4, warm start; mg_min_size 8: levels 16 x 32 and 8 x 16)
TEXT_MG_CFG = dataclasses.replace(TEXT_CFG, solver=SolverConfig(
    max_iterations=100, dtype="float32", tol_rel=1e-4, preconditioner="mg",
    warm_start=True, mg_min_size=8))
# the text with the golden configuration's solve and IC(0) (f64, cap 400)
TEXT_IC0_CFG = dataclasses.replace(TEXT_CFG, solver=SolverConfig(
    max_iterations=400, dtype="float64", preconditioner="ic0"))
# the text in the reference's own configuration: the global marker layout
# (the JAX package's default) in rainbow
TEXT_GLOBAL_CFG = dataclasses.replace(TEXT_CFG, marker_layout="global",
                                      rainbow=True)


def _frames(mesh, step_of) -> dict:
    """FRAME_STEPS frames of the dam break developed FRAME_DEVELOP frames
    by the unsharded port, stepped by `step_of(FRAME_CFG, mesh)` on this
    rank's block and gathered (`frame_*`), with the plain versions' calls
    (`frame_calls`: K1, S1, K7, P4)."""
    scn, st = developed(FRAME_CFG, FRAME_DEVELOP)
    step = step_of(FRAME_CFG, mesh)
    bscn, b = shard_spatial(FRAME_CFG, mesh, scn, st)
    _build.PLAIN_CALLS.clear()
    for _ in range(FRAME_STEPS):
        b = step(bscn, b)
    out = {"frame_calls": torch.tensor([_build.PLAIN_CALLS[k] for k in
                                        ("K1", "S1", "K7", "P4")])}
    out.update({f"frame_{k}": torch.as_tensor(v) for k, v in
                convert.state_to_numpy(gather_spatial(FRAME_CFG, mesh,
                                                      b)).items()})
    return out


def _batch(dmesh, cfg: SimConfig = TEXT_CFG, name: str = "batch",
           calls=()) -> dict:
    """`mesh.make_sharded_step` on `dmesh` stepping a batch of the text
    scenario and its mirror TEXT_STEPS frames under `cfg` (gathered:
    `{name}_*`), with the plain calls of the kernels `calls` in those
    frames (`{name}_calls`)."""
    from euler_tpu_torch.core.scenario import build_scenario
    from euler_tpu_torch.parallel.batch import stack
    from euler_tpu_torch.parallel.spatial import to_spatial

    out = {f"{name}_layout": torch.tensor(dmesh.mesh.shape)}
    pairs = [build_scenario(t, cfg, device="cpu")
             for t in (TEXT, b"\n".join(r[::-1] for r in TEXT.split(b"\n")))]
    scn2 = stack([p[0] for p in pairs])
    st2 = stack([to_spatial(cfg, p[1]) if cfg.marker_layout == "slots"
                 else p[1] for p in pairs])
    sscn, sst = shard_batch(dmesh, scn2, st2)
    step2 = make_sharded_step(cfg, dmesh)
    _build.PLAIN_CALLS.clear()
    for _ in range(TEXT_STEPS):
        sst = step2(sscn, sst)
    if calls:
        out[f"{name}_calls"] = torch.tensor([_build.PLAIN_CALLS[k]
                                             for k in calls])
    whole = gather_batch(dmesh, sst)
    out.update({f"{name}_{k}": torch.as_tensor(v) for k, v in
                convert.state_to_numpy(whole).items()})
    return out


def frame_rank() -> dict:
    """On 4 gloo ranks: `cuda_shard.make_spatial_step_pallas` on a "y"
    mesh of 4 (`_frames`); and `mesh.make_sharded_step` on `make_mesh(4)`
    (data 2 x y 2, `_batch`)."""
    from euler_tpu_torch.parallel.cuda_shard import make_spatial_step_pallas

    out = _frames(spatial_mesh(4, x=1, device="cpu"),
                  make_spatial_step_pallas)
    out.update(_batch(make_mesh(4, device="cpu")))
    return out


def col_frame_rank() -> dict:
    """On 4 gloo ranks, column blocks: `spatial.make_spatial_step` on
    `spatial_mesh(4, x=2)` (2 x 2 blocks of 32 x 32, `_frames`); and
    `mesh.make_sharded_step` on `make_mesh(4, data=1, x=2)` (y 2 x x 2:
    blocks of 8 x 16, `_batch`), with the Jacobi solve (`batch_*`), with
    the global MG solve (TEXT_MG_CFG, `mg_batch_*`), with the global
    IC(0) solve (TEXT_IC0_CFG, `ic0_batch_*`) and in the global marker
    layout in rainbow (TEXT_GLOBAL_CFG, `global_batch_*`, with the plain
    calls of G1, G2, S1 and K7)."""
    from euler_tpu_torch.parallel.spatial import make_spatial_step

    out = _frames(spatial_mesh(4, x=2, device="cpu"), make_spatial_step)
    dmesh = make_mesh(4, data=1, x=2, device="cpu")
    out.update(_batch(dmesh))
    out.update(_batch(dmesh, TEXT_MG_CFG, "mg_batch", ("P5", "P4")))
    out.update(_batch(dmesh, TEXT_IC0_CFG, "ic0_batch", ("P6", "P4")))
    out.update(_batch(dmesh, TEXT_GLOBAL_CFG, "global_batch",
                      ("G1", "G2", "S1", "K7")))
    return out
