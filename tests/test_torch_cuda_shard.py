"""K1 on row shards (`euler_tpu_torch/parallel/cuda_shard.py`), the frame
on row blocks' kernels (K7 and S1 per row block, P4) on the card, and the
port's dry run on one NCCL rank.

A card holds every shard of a plane here: shard r of n is its rows with
8 rows of each neighbour (`cuda_shard.block_with_halo`, which is what
`exchange_rows` delivers to a rank), and K1 runs on it with clamp_ny = Y
and row_offset = r Yl - 8.  Cases: the developed 256² dam break, and
seeded marker states (tests/marker_states.py) on heights whose shards
do not fill whole tiles, full stores that drop, at K = 8 and 16.
  * each shard's launch equals its plain version with the same two
    arguments, bit for bit, the whole padded output;
  * the shards' interiors put together equal the unsharded launch, bit
    for bit;
  * clamp_ny = Y, row_offset = 0 is the unsharded launch.
The frame on row blocks (`parallel/spatial.py`):
  * K7 on each padded block with clamp_ny / row_offset bitwise its plain
    version and, cropped, the unsharded K7 (256² dam break, 2 and 4
    blocks);
  * S1 on 4 row blocks (the all-reduced counts given) bitwise its plain
    version and, put together, the unsharded S1 (the waterfall, and a
    scenario with sources in every block);
  * P4 on in-process blocks (`comm.LocalGroup`) of a 64² system against
    its plain version on the CPU: the same iterations (within 1 in f32),
    p within 1e-9 (f64) or 1e-4 of its scale (f32), cold and warm; its
    block MG in f32 and f64;
  * the 40 x 100 waterfall on 4 blocks, card against CPU: counts, alive,
    RNG bitwise, u and v within 1e-4, every kernel launched and no plain
    version run.
The frame on 2 x 2 column blocks (K1, K7 and S1 given clamp_nx /
col_offset, P4 over ("y", "x")):
  * K1 (the cases above) and K7 (the 256² dam break) on each block
    padded with 8 rows and columns bitwise their plain versions and,
    cropped, the unsharded launch; clamp_nx = X, col_offset = 0 is the
    unsharded K1;
  * S1 on 40 x 100 with a source in each 20 x 50 block, bitwise its
    plain version and the unsharded S1;
  * the 40 x 100 waterfall on 2 x 2 blocks, card against CPU, as above.
The frame's global MG solve on blocks (P5, `parallel/spatial_mg.py`):
  * its hierarchy and one cycle on 2 x 2 and 4 x 1 blocks of the 256²
    system bit for bit P3's, f32 and f64;
  * on 1 x 1 blocks P3 bit for bit (p, iterations, residual), cold and
    warm, f32 and f64; on 2 x 2 blocks iterations within 1, p within
    5e-4 of scale (f64: the same iterations, p within 1e-10 of scale);
  * the plans each f32 and f64 create makes at 1024²: P5's gather level
    and its gathered coarse cycle's level and shared memory are P3's,
    a level lower in f64; P4's block MG the same a block;
  * the 64² dam break on 2 x 2 blocks, card against CPU, 3 frames (P5
    launched once a block a substep, no plain version; at most 4 cells'
    counts apart, u and v within 2e-3).
The frame's global IC(0) solve on blocks (P6, `parallel/spatial_ic0.py`):
  * E_inv and one application on 2 x 2 and 4 x 1 blocks of the 256²
    system bit for bit P2's, f64 and f32;
  * on 1 x 1 blocks P1 + P2 bit for bit, cold and warm; on 2 x 2 blocks
    iterations within 1, p within 1e-9 of scale; at 40 x 100 on 2 x 2
    blocks the plain version on the same card tensors;
  * the 64² IC(0) dam break on 2 x 2 blocks, card against CPU, 2 frames
    (P6 launched once a block a substep, no plain version).
The multi-rank exchange runs on gloo ranks (tests/test_torch_shard.py);
the card's host has one card, so its NCCL run has one rank.

Marked `cuda`: each test skips on a host without an NVIDIA GPU.  Imports
nothing of JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda_shard.py
"""

import dataclasses

import pytest
import torch

from euler_tpu_torch import sim
from euler_tpu_torch.config import SimConfig, SolverConfig
from euler_tpu_torch.core.presets import dam_break
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda import marker_fused_kernel as k1
from euler_tpu_torch.ops.forces import max_speed_sq
from euler_tpu_torch.parallel.cuda_shard import H, block_with_halo
from euler_tpu_torch.parallel.dryrun import dryrun_multichip

from marker_states import marker_state

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _dam_break(size):
    _card()
    cfg = SimConfig(nx=size, ny=size, marker_layout="slots",
                    solver=SolverConfig(max_iterations=100, tol_rel=1e-4,
                                        preconditioner="mg",
                                        warm_start=True,
                                        fuse_projection=True))
    scn, st = dam_break(cfg, device="cuda")
    for _ in range(3):
        st = sim.step_frame(cfg, scn, st)
    dt = sim._dt_from_msq(cfg, max_speed_sq(cfg, st.u, st.v),
                          torch.full((), cfg.frame_time, device="cuda"))
    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    return (cfg, st.u, st.v, st.fluid, scn.solid,
            st.markers.reshape(2 * K, Y, X), dt, st.marker_count,
            scn.sink | scn.solid)


def _seeded(Y, X, K):
    _card()
    return marker_state(Y, X, K, fill="full", seed=3, device="cuda")


CASES = {
    "dam_break_256": lambda: _dam_break(256),
    "full_200x136_k8": lambda: _seeded(200, 136, 8),
    "full_120x72_k16": lambda: _seeded(120, 72, 16),
}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_k1_shards_bitwise(case, n):
    cfg, u, v, fluid, solid, slots, dt, count, dead = CASES[case]()
    Y = cfg.ny
    Yl = Y // n
    assert Y % n == 0 and Yl >= H
    whole = k1.march_rebin(cfg, u, v, fluid, solid, slots, dt, count,
                           dead=dead)
    cfg_l = dataclasses.replace(cfg, ny=Yl + 2 * H)
    for r in range(n):
        p = [block_with_halo(a, n, r)
             for a in (u, v, fluid, solid, slots, count, dead)]
        args = (cfg_l, *p[:5], dt, p[5])
        kw = dict(dead=p[6], clamp_ny=Y, row_offset=r * Yl - H)
        _build.LAUNCHES.clear()
        got = k1.march_rebin(*args, **kw)
        assert _build.LAUNCHES["K1"] == 1
        want = k1.march_rebin_plain(*args, **kw)
        for a, b, name in zip(got, want, ("slots", "count", "drop")):
            assert torch.equal(a, b), f"shard {r}: {name} differs from plain"
        for a, b, name in zip(got, whole, ("slots", "count", "drop")):
            assert torch.equal(a[..., H:H + Yl, :],
                               b[..., r * Yl:(r + 1) * Yl, :]), (
                f"shard {r}: {name} differs from the unsharded K1")
    assert int(whole[2].sum()) > 0 or case == "dam_break_256"


def test_k1_identity_arguments():
    cfg, *args, dead = _dam_break(256)
    a = k1.march_rebin(cfg, *args, dead=dead)
    b = k1.march_rebin(cfg, *args, dead=dead, clamp_ny=cfg.ny, row_offset=0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_dryrun_on_one_nccl_rank():
    _card()
    results = dryrun_multichip(1, "nccl")
    assert int(results[0]["frames"]) == 2 and int(results[0]["iters"]) > 0


# ---- the frame on row blocks: K7 and S1 per row block, P4 -------------


def _developed(cfg, frames, scenario=None):
    _card()
    from euler_tpu_torch.core.scenario import load_scenario

    if scenario is None:
        scn, st = dam_break(cfg, device="cuda")
    else:
        scn, st = load_scenario(scenario, cfg, device="cuda")
    for _ in range(frames):
        st = sim.step_frame(cfg, scn, st)
    return scn, st


@pytest.mark.parametrize("n", [2, 4])
def test_k7_row_blocks_bitwise(n):
    """K7 on each padded block with clamp_ny = Y, row_offset = r Yl - 8
    equals its plain version there, bit for bit, the whole padded output,
    and its interior the unsharded K7; clamp_ny = Y, row_offset = 0 is
    the unsharded launch."""
    from euler_tpu_torch.ops.cuda import grid_kernel as k7

    cfg = SimConfig(nx=256, ny=256, marker_layout="slots",
                    solver=SolverConfig(preconditioner="jacobi"))
    scn, st = _developed(cfg, 3)
    dt = sim._dt_from_msq(cfg, max_speed_sq(cfg, st.u, st.v),
                          torch.full((), cfg.frame_time, device="cuda"))
    args = (st.u, st.v, st.fluid, st.prev_fluid, scn.solid)
    whole = k7.grid_stage(cfg, *args, dt)
    same = k7.grid_stage(cfg, *args, dt, clamp_ny=cfg.ny, row_offset=0)
    assert all(torch.equal(a, b) for a, b in zip(whole, same))
    Y, Yl = cfg.ny, cfg.ny // n
    cfg_l = dataclasses.replace(cfg, ny=Yl + 2 * H)
    for r in range(n):
        p = [block_with_halo(a, n, r) for a in args]
        kw = dict(clamp_ny=Y, row_offset=r * Yl - H)
        _build.LAUNCHES.clear()
        got = k7.grid_stage(cfg_l, *p, dt, **kw)
        assert _build.LAUNCHES["K7"] == 1
        want = k7.grid_stage(cfg_l, *(a.cpu() for a in p), dt.cpu(), **kw)
        for a, b, w, name in zip(got, want, whole, ("ut", "vt")):
            assert torch.equal(a.cpu(), b), f"block {r}: {name} vs plain"
            assert torch.equal(a[H:H + Yl], w[r * Yl:(r + 1) * Yl]), (
                f"block {r}: {name} differs from the unsharded K7")


def _s1_blocks(cfg, scn, st, n, device):
    """S1 on each of n row blocks of (scn, st) on `device`; returns the
    blocks' planes put together and block 0's scalars."""
    from euler_tpu_torch.ops.cuda.source_kernel import emit_sources

    Yl = cfg.ny // n
    ys, xs = scn.source_yx[:, 0].long(), scn.source_yx[:, 1].long()
    counts = torch.where(scn.source_valid, st.marker_count[ys, xs],
                         0).to(torch.int32).to(device)
    planes = ("markers", "alive", "marker_count", "r", "g", "b")
    out = {k: [] for k in planes}
    for r in range(n):
        rows = slice(r * Yl, (r + 1) * Yl)
        b = st.replace(**{k: getattr(st, k)[..., rows, :].to(device)
                          .clone(memory_format=torch.contiguous_format)
                          for k in planes},
                       **{k: getattr(st, k).to(device).clone() for k in
                          ("rng", "alive_count", "source_exhausted",
                           "frame_count")})
        bs = dataclasses.replace(
            scn, **{k: getattr(scn, k)[rows].to(device).contiguous()
                    for k in ("solid", "source", "sink")},
            source_yx=scn.source_yx.to(device),
            source_valid=scn.source_valid.to(device))
        emit_sources(cfg, bs, b, None, row_offset=r * Yl, counts=counts)
        for k in planes:
            out[k].append(getattr(b, k).cpu())
        if r == 0:
            scalars = [getattr(b, k).cpu().to(torch.int64) for k in
                       ("rng", "alive_count", "source_exhausted")]
    return {k: torch.cat(v, -2) for k, v in out.items()}, scalars


@pytest.mark.parametrize("scenario,n", [("waterfall", 4),
                                        ("sources_rows", 4)])
def test_s1_row_blocks_bitwise(scenario, n):
    """S1 on row blocks (the source cells' counts given, every block
    walking every source) equals its plain version block by block and,
    put together, the unsharded S1, bit for bit; `sources_rows` has
    sources in every block."""
    from euler_tpu_torch.core.scenario import build_scenario
    from euler_tpu_torch.ops.cuda.source_kernel import emit_sources

    _card()
    cfg = SimConfig(nx=100, ny=40, marker_layout="slots", max_substeps=2,
                    solver=SolverConfig(max_iterations=30))
    if scenario == "waterfall":
        scn, st = _developed(cfg, 2, "scenarios/waterfall.txt")
    else:
        text = "\n".join("?" * (k % 3 + 1) + " " * 40 + "00"
                         for k in range(36)) + "\n"
        scn, st = build_scenario(text.encode(), cfg, device="cuda")
        for _ in range(2):
            st = sim.step_frame(cfg, scn, st)
        rows = set(scn.source_yx[:, 0].tolist())
        assert len({y // (cfg.ny // n) for y in rows}) == n
    cpu = lambda t: t.cpu()  # noqa: E731
    scn_c = dataclasses.replace(scn, **{f.name: cpu(getattr(scn, f.name))
                                        for f in dataclasses.fields(scn)})
    st_c = st.replace(**{f.name: cpu(getattr(st, f.name))
                         for f in dataclasses.fields(st)})
    whole = st.replace(**{k: getattr(st, k).clone() for k in
                          ("markers", "alive", "marker_count", "r", "g", "b",
                           "rng", "alive_count", "source_exhausted")})
    emit_sources(cfg, scn, whole)
    _build.LAUNCHES.clear()
    got, got_s = _s1_blocks(cfg, scn, st, n, "cuda")
    assert _build.LAUNCHES["S1"] == n
    want, want_s = _s1_blocks(cfg, scn_c, st_c, n, "cpu")
    for k in got:
        assert torch.equal(got[k], want[k]), f"{k} vs plain"
        assert torch.equal(got[k], getattr(whole, k).cpu()), (
            f"{k} vs the unsharded S1")
    for a, b in zip(got_s, want_s):
        assert torch.equal(a, b)
    assert int(got_s[1]) == int(whole.alive_count)


def _system(N, dtype, seed=0):
    """test_halo.py's 64² system: a box of fluid with a solid bar."""
    import numpy as np

    from euler_tpu_torch.ops.project import pressure_matrix_diag

    rng = np.random.default_rng(seed)
    fluid = np.zeros((N, N), bool)
    fluid[1:-1, 1:-1] = True
    solid = np.zeros((N, N), bool)
    solid[N // 3:N // 3 + 4, 5:N * 3 // 4] = True
    fluid &= ~solid
    fl = torch.tensor(fluid)
    a = pressure_matrix_diag(SimConfig(nx=N, ny=N), torch.tensor(solid), fl)
    b = torch.tensor(rng.standard_normal((N, N)) * fluid, dtype=dtype)
    return b, a, fl


def _blocks_solve(cfg, b, a, fl, n, device, x0=None):
    """P4 itself (`solve_pressure_sharded`: its "none" is z = r, as the
    frame on blocks runs it) on n row blocks on `device`."""
    from euler_tpu_torch.ops.cuda.pcg_shard_kernel import (
        solve_pressure_sharded,
    )
    from euler_tpu_torch.parallel.comm import LocalGroup

    Yl = b.shape[0] // n

    def rank(comm):
        rows = slice(comm.rank("y") * Yl, (comm.rank("y") + 1) * Yl)
        cut = lambda t: None if t is None else (  # noqa: E731
            t[rows].to(device).contiguous())
        p, it, res = solve_pressure_sharded(cfg, comm, ("y",), cut(b),
                                            cut(a), cut(fl), cut(x0))
        return p.cpu(), int(it), float(res)

    with LocalGroup(n, device=device) as g:
        out = g.run(rank)
    assert len({o[1] for o in out}) == 1 and len({o[2] for o in out}) == 1
    return torch.cat([o[0] for o in out]), out[0][1], out[0][2]


@pytest.mark.parametrize("precon,dtype,n", [
    ("jacobi", torch.float64, 1), ("jacobi", torch.float64, 4),
    ("none", torch.float64, 2), ("jacobi", torch.float32, 4),
    ("mg", torch.float32, 4), ("mg", torch.float64, 4)])
def test_p4_matches_plain(precon, dtype, n):
    """P4 on n in-process blocks of a 64² system against its plain
    version on the same blocks: the same iterations, p within 1e-9 (f64;
    its block MG's hierarchy and cycle in double) or 1e-4 of p's scale
    (f32: the reductions' order differs); a warm start too."""
    _card()
    b, a, fl = _system(64, dtype)
    tol = 1e-10 if dtype == torch.float64 else 1e-5
    cfg = SimConfig(nx=64, ny=64, solver=SolverConfig(
        max_iterations=600, tol=tol, dtype=str(dtype)[6:],
        preconditioner=precon, mg_min_size=8))
    _build.LAUNCHES.clear()
    got = _blocks_solve(cfg, b, a, fl, n, "cuda")
    assert _build.LAUNCHES["P4"] == n
    want = _blocks_solve(cfg, b, a, fl, n, "cpu")
    scale = float(want[0].abs().max())
    close = 1e-9 if dtype == torch.float64 else 1e-4 * scale
    assert abs(got[1] - want[1]) <= (0 if dtype == torch.float64 else 1)
    assert float((got[0] - want[0]).abs().max()) <= close
    x0 = torch.where(fl, want[0] * 0.5, 0.0)
    warm = _blocks_solve(cfg, b, a, fl, n, "cuda", x0)
    warm_plain = _blocks_solve(cfg, b, a, fl, n, "cpu", x0)
    assert abs(warm[1] - warm_plain[1]) <= (
        0 if dtype == torch.float64 else 1)
    assert float((warm[0] - warm_plain[0]).abs().max()) <= close


def test_row_frame_card_vs_cpu():
    """The waterfall at 40 x 100 on 4 in-process row blocks (K1, S1, K7,
    P4 per block) on the card against the same blocks' plain versions on
    the CPU: counts, alive, RNG bitwise, u and v within 1e-4."""
    from euler_tpu_torch.core.scenario import load_scenario
    from euler_tpu_torch.parallel.comm import LocalGroup
    from euler_tpu_torch.parallel.spatial import (
        gather_spatial,
        make_spatial_step,
        shard_spatial,
    )

    _card()
    cfg = SimConfig(nx=100, ny=40, marker_layout="slots",
                    solver=SolverConfig(max_iterations=100, tol_rel=1e-4))

    scn, st = load_scenario("scenarios/waterfall.txt", cfg, device="cpu")

    def run(device):
        def rank(comm):
            step = make_spatial_step(cfg, comm)
            bs, b = shard_spatial(cfg, comm, scn, st)
            for _ in range(4):
                b = step(bs, b)
            out = gather_spatial(cfg, comm, b)
            return out.replace(**{f.name: getattr(out, f.name).cpu()
                                  for f in dataclasses.fields(out)})

        with LocalGroup(4, device=device) as g:
            return g.run(rank)[0]

    _build.LAUNCHES.clear()
    _build.PLAIN_CALLS.clear()
    got = run("cuda")
    assert all(_build.LAUNCHES[k] > 0 for k in ("K1", "S1", "K7", "P4"))
    assert not any(_build.PLAIN_CALLS.values())
    want = run("cpu")
    for name in ("marker_count", "alive", "alive_count", "dropped_markers"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.equal(got.rng.to(torch.int64), want.rng.to(torch.int64))
    for name in ("u", "v"):
        assert float((getattr(got, name) - getattr(want, name)).abs()
                     .max()) <= 1e-4, name


# ---- the frame on column blocks: K1, K7 and S1 per (y, x) block -------


def _col_blocks(arrays, Y, X):
    """The 2 x 2 blocks of [.., Y, X] `arrays` with 8 rows and columns of
    each neighbour, and each block's place in the grid."""
    Yl, Xl = Y // 2, X // 2
    for r in range(2):
        for c in range(2):
            yield ((slice(r * Yl, (r + 1) * Yl), slice(c * Xl, (c + 1) * Xl)),
                   [block_with_halo(a, 2, r, H, 2, c) for a in arrays],
                   dict(clamp_ny=Y, row_offset=r * Yl - H, clamp_nx=X,
                        col_offset=c * Xl - H))


@pytest.mark.parametrize("case", sorted(CASES))
def test_k1_col_blocks_bitwise(case):
    """K1 on each of 2 x 2 blocks padded with 8 rows and columns, with
    clamp_ny / row_offset / clamp_nx / col_offset, equals its plain
    version, the whole padded output, and cropped the unsharded K1;
    clamp_nx = X, col_offset = 0 is the unsharded launch."""
    cfg, u, v, fluid, solid, slots, dt, count, dead = CASES[case]()
    Y, X = cfg.ny, cfg.nx
    whole = k1.march_rebin(cfg, u, v, fluid, solid, slots, dt, count,
                           dead=dead)
    same = k1.march_rebin(cfg, u, v, fluid, solid, slots, dt, count,
                          dead=dead, clamp_nx=X, col_offset=0)
    assert all(torch.equal(a, b) for a, b in zip(whole, same))
    cfg_b = dataclasses.replace(cfg, ny=Y // 2 + 2 * H, nx=X // 2 + 2 * H)
    for cut, p, kw in _col_blocks((u, v, fluid, solid, slots, count, dead),
                                  Y, X):
        args = (cfg_b, *p[:5], dt, p[5])
        _build.LAUNCHES.clear()
        got = k1.march_rebin(*args, dead=p[6], **kw)
        assert _build.LAUNCHES["K1"] == 1
        want = k1.march_rebin_plain(*args, dead=p[6], **kw)
        for a, b, w, name in zip(got, want, whole, ("slots", "count",
                                                    "drop")):
            assert torch.equal(a, b), f"{kw}: {name} differs from plain"
            assert torch.equal(a[..., H:-H, H:-H], w[(..., *cut)]), (
                f"{kw}: {name} differs from the unsharded K1")


def test_k7_col_blocks_bitwise():
    """K7 on 2 x 2 padded blocks of the developed 256² dam break equals
    its plain version and, cropped, the unsharded K7."""
    from euler_tpu_torch.ops.cuda import grid_kernel as k7

    cfg = SimConfig(nx=256, ny=256, marker_layout="slots",
                    solver=SolverConfig(preconditioner="jacobi"))
    scn, st = _developed(cfg, 3)
    dt = sim._dt_from_msq(cfg, max_speed_sq(cfg, st.u, st.v),
                          torch.full((), cfg.frame_time, device="cuda"))
    args = (st.u, st.v, st.fluid, st.prev_fluid, scn.solid)
    whole = k7.grid_stage(cfg, *args, dt)
    cfg_b = dataclasses.replace(cfg, ny=128 + 2 * H, nx=128 + 2 * H)
    for cut, p, kw in _col_blocks(args, cfg.ny, cfg.nx):
        got = k7.grid_stage(cfg_b, *p, dt, **kw)
        want = k7.grid_stage(cfg_b, *(a.cpu() for a in p), dt.cpu(), **kw)
        for a, b, w, name in zip(got, want, whole, ("ut", "vt")):
            assert torch.equal(a.cpu(), b), f"{kw}: {name} vs plain"
            assert torch.equal(a[H:-H, H:-H], w[cut]), (
                f"{kw}: {name} differs from the unsharded K7")


def _col_sources(device):
    """40 x 100 with a source in each 20 x 50 block, 2 frames on."""
    from euler_tpu_torch.core.scenario import build_scenario

    cfg = SimConfig(nx=100, ny=40, marker_layout="slots", max_substeps=2,
                    solver=SolverConfig(max_iterations=30))
    text = "\n".join(("?" if k % 6 == 0 else " ") + "00" + " " * 60
                     + ("?" if k % 6 == 0 else " ") for k in range(36))
    scn, st = build_scenario((text + "\n").encode(), cfg, device=device)
    assert {(y // 20, x // 50) for y, x in scn.source_yx.tolist()} == {
        (0, 0), (0, 1), (1, 0), (1, 1)}
    for _ in range(2):
        st = sim.step_frame(cfg, scn, st)
    return cfg, scn, st


def test_s1_col_blocks_bitwise():
    """S1 on 2 x 2 blocks (the all-reduced counts given, every block
    walking every source, each writing the sources of its own cells)
    equals its plain version block by block and, put together, the
    unsharded S1, bit for bit."""
    from euler_tpu_torch.ops.cuda.source_kernel import emit_sources

    _card()
    cfg, scn, st = _col_sources("cuda")
    ys, xs = scn.source_yx[:, 0].long(), scn.source_yx[:, 1].long()
    counts = torch.where(scn.source_valid, st.marker_count[ys, xs],
                         0).to(torch.int32)
    fields = ("markers", "alive", "marker_count", "r", "g", "b", "rng",
              "alive_count", "source_exhausted")
    whole = st.replace(**{k: getattr(st, k).clone() for k in fields})
    emit_sources(cfg, scn, whole)
    planes = fields[:6]
    for cut, _, kw in _col_blocks((), cfg.ny, cfg.nx):
        out = []
        for device in ("cuda", "cpu"):
            b = st.replace(**{k: getattr(st, k)[(..., *cut)].to(device)
                              .clone(memory_format=torch.contiguous_format)
                              for k in planes},
                           **{k: getattr(st, k).to(device).clone() for k in
                              fields[6:] + ("frame_count",)})
            bs = dataclasses.replace(
                scn, **{k: getattr(scn, k)[cut].to(device).contiguous()
                        for k in ("solid", "source", "sink")},
                source_yx=scn.source_yx.to(device),
                source_valid=scn.source_valid.to(device))
            _build.LAUNCHES.clear()
            emit_sources(cfg, bs, b, None, row_offset=cut[0].start,
                         counts=counts.to(device), col_offset=cut[1].start)
            assert _build.LAUNCHES["S1"] == (device == "cuda")
            out.append(b)
        got, want = out
        for k in fields:
            a = getattr(got, k).cpu().to(torch.int64)
            assert torch.equal(a, getattr(want, k).to(torch.int64)), (
                f"{kw}: {k} vs plain")
            w = getattr(whole, k)
            if k in planes:
                w = w[(..., *cut)]
            assert torch.equal(a, w.cpu().to(torch.int64)), (
                f"{kw}: {k} vs the unsharded S1")


def test_col_frame_card_vs_cpu():
    """The waterfall at 40 x 100 on 2 x 2 in-process blocks of 20 x 50
    (K1, S1, K7, P4 per block, P4 over ("y", "x")) on the card against
    the same blocks' plain versions on the CPU: counts, alive, RNG
    bitwise, u and v within 1e-4."""
    from euler_tpu_torch.core.scenario import load_scenario
    from euler_tpu_torch.parallel.comm import LocalGroup
    from euler_tpu_torch.parallel.spatial import (
        gather_spatial,
        make_spatial_step,
        shard_spatial,
    )

    _card()
    cfg = SimConfig(nx=100, ny=40, marker_layout="slots",
                    solver=SolverConfig(max_iterations=100, tol_rel=1e-4))
    scn, st = load_scenario("scenarios/waterfall.txt", cfg, device="cpu")

    def run(device):
        def rank(comm):
            step = make_spatial_step(cfg, comm)
            bs, b = shard_spatial(cfg, comm, scn, st)
            for _ in range(4):
                b = step(bs, b)
            out = gather_spatial(cfg, comm, b)
            return out.replace(**{f.name: getattr(out, f.name).cpu()
                                  for f in dataclasses.fields(out)})

        with LocalGroup(2, 2, device=device) as g:
            return g.run(rank)[0]

    _build.LAUNCHES.clear()
    _build.PLAIN_CALLS.clear()
    got = run("cuda")
    assert all(_build.LAUNCHES[k] > 0 for k in ("K1", "S1", "K7", "P4"))
    assert not any(_build.PLAIN_CALLS.values())
    want = run("cpu")
    for name in ("marker_count", "alive", "alive_count", "dropped_markers"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.equal(got.rng.to(torch.int64), want.rng.to(torch.int64))
    for name in ("u", "v"):
        assert float((getattr(got, name) - getattr(want, name)).abs()
                     .max()) <= 1e-4, name


def _mg_system(size):
    """(cfg, b, a_diag, fluid, p0) on the card: a substep's own system of
    the dam break at size², 3 frames on, under bench.py's MG config (the
    RHS of the advected velocities; the state's pressure, masked)."""
    from euler_tpu_torch.ops.cuda.grid_kernel import grid_stage_plain
    from euler_tpu_torch.ops.project import (
        divergence_rhs,
        pressure_matrix_diag,
    )

    _card()
    cfg = SimConfig(nx=size, ny=size, marker_layout="slots",
                    solver=SolverConfig(max_iterations=100, tol_rel=1e-4,
                                        dtype="float32", preconditioner="mg",
                                        warm_start=True))
    scn, st = dam_break(cfg, device="cuda")
    for _ in range(3):
        st = sim.step_frame(cfg, scn, st)
    dt = sim._dt_from_msq(cfg, max_speed_sq(cfg, st.u, st.v),
                          torch.full((), cfg.frame_time, device="cuda"))
    ut, vt = grid_stage_plain(cfg, dt, st.u, st.v, st.fluid, st.prev_fluid,
                              scn.solid)
    b = divergence_rhs(cfg, ut, vt, st.fluid, dt)
    a_diag = pressure_matrix_diag(cfg, scn.solid, st.fluid)
    return cfg, b, a_diag, st.fluid, torch.where(st.fluid, st.p, 0.0)


def _p5_blocks(cfg, y, x, fn):
    """fn(comm, cut, axes) on y x x in-process blocks on the card, every
    block's result in rank order."""
    from euler_tpu_torch.parallel.comm import LocalGroup

    Yl, Xl = cfg.ny // y, cfg.nx // x

    def rank(comm):
        ry, rx = comm.rank("y"), comm.rank("x")
        cut = (slice(ry * Yl, (ry + 1) * Yl), slice(rx * Xl, (rx + 1) * Xl))
        return fn(comm, cut, ("y", "x") if x > 1 else ("y",))

    with LocalGroup(y, x, device="cuda") as g:
        return g.run(rank)


def _p5_solve(cfg, b, a_diag, fl, y, x, x0=None):
    """P5 on y x x blocks: (p put together, iterations, residual), the
    same on every block."""
    from euler_tpu_torch.parallel import spatial_mg
    from euler_tpu_torch.parallel.cuda_shard import padded

    def fn(comm, cut, axes):
        p, it, res = spatial_mg.solve_pressure_blocks(
            cfg, comm, axes, *(t[cut].contiguous() for t in (b, a_diag, fl)),
            padded(fl[cut].contiguous(), comm, 1),
            None if x0 is None else x0[cut].contiguous())
        return spatial_mg.gather_plane(p, comm, axes), int(it), float(res)

    out = _p5_blocks(cfg, y, x, fn)
    assert len({o[1:] for o in out}) == 1
    return out[0]


def _in_f64(system):
    """`_mg_system`'s system with the solve in f64 (b and p0 as doubles)."""
    cfg, b, a_diag, fl, p0 = system
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, dtype="float64"))
    return cfg, b.double(), a_diag, fl, p0.double()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("layout", [(2, 2), (4, 1)])
def test_p5_hierarchy_and_cycle_bitwise(layout, dtype):
    """P5's hierarchy (the packed level 0 and the distributed levels put
    together, the gathered levels, the Chebyshev rows) and one cycle on
    the blocks, gathered, bit for bit P3's (`MgGeneralWorkspace.cycle`)
    on the 256² system (levels 256², 128² on the blocks, 64² and 32²
    gathered), in f32 and in f64."""
    from euler_tpu_torch.ops.cuda import pcg_general_kernel as p13
    from euler_tpu_torch.ops.cuda import pcg_mg_blocks_kernel as p5
    from euler_tpu_torch.parallel import spatial_mg
    from euler_tpu_torch.parallel.cuda_shard import padded

    cfg, b, a_diag, fl, _ = _mg_system(256)
    if dtype == "float64":
        cfg, b, a_diag, fl, _ = _in_f64((cfg, b, a_diag, fl, _))
    p13.solve_pressure_general(cfg, b, a_diag, fl)
    ws3 = p13.workspace(cfg, b.device)
    want_z = ws3.cycle(b, per_op=False)

    def fn(comm, cut, axes):
        spatial_mg.solve_pressure_blocks(
            cfg, comm, axes, *(t[cut].contiguous() for t in (b, a_diag, fl)),
            padded(fl[cut].contiguous(), comm, 1))
        plan = spatial_mg.block_plan(cfg, comm, axes)
        ws = p5.workspace(cfg, comm, plan, b.device)
        whole = lambda t: spatial_mg.gather_plane(t, comm, axes)  # noqa
        levels = [tuple(whole(ws.block[l][k]) for k in "cen")
                  for l in range(1, plan.gather)]
        levels += [tuple(ws.whole[l][k] for k in "cen")
                   for l in range(plan.gather, len(plan.shapes))]
        z = ws.cycle(comm, axes, b[cut].contiguous())
        return (plan.gather, whole(ws.packed0), levels, ws.rows.clone(),
                whole(z))

    gather, packed0, levels, rows, z = _p5_blocks(cfg, *layout, fn)[0]
    assert gather == 2 and len(levels) == len(ws3.levels) == 3
    assert rows.dtype == ws3.rows.dtype == getattr(torch, dtype)
    assert torch.equal(packed0, ws3.packed0)
    for got, want in zip(levels, ws3.levels):
        for a, c in zip(got, want[:3]):
            assert torch.equal(a, c)
    assert torch.equal(rows, ws3.rows)
    assert bool(want_z.abs().max() > 0) and torch.equal(z, want_z)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_p5_one_block_bitwise_p3(dtype):
    """P5 on 1 x 1 blocks is P3 bit for bit (p, iterations, residual),
    cold and warm, in f32 and in f64; on 2 x 2 blocks the iterations
    within 1 and p within 5e-4 of scale (f64: the same iterations, p
    within 1e-10 of scale); one P5 launch a block a solve, no plain
    call."""
    from euler_tpu_torch.ops.cuda import pcg_general_kernel as p13

    cfg, b, a_diag, fl, p0 = _mg_system(256)
    f64 = dtype == "float64"
    if f64:
        cfg, b, a_diag, fl, p0 = _in_f64((cfg, b, a_diag, fl, p0))
    for x0 in (None, p0):
        want = p13.solve_pressure_general(cfg, b, a_diag, fl, x0=x0)
        _build.LAUNCHES.clear()
        _build.PLAIN_CALLS.clear()
        p, it, res = _p5_solve(cfg, b, a_diag, fl, 1, 1, x0)
        assert _build.LAUNCHES["P5"] == 1 and not _build.PLAIN_CALLS
        assert torch.equal(p, want[0]) and it == int(want[1])
        assert res == float(want[2])
        p, it, res = _p5_solve(cfg, b, a_diag, fl, 2, 2, x0)
        assert _build.LAUNCHES["P5"] == 5
        scale = float(want[0].abs().max())
        assert p.dtype == want[0].dtype == getattr(torch, dtype)
        assert abs(it - int(want[1])) <= (0 if f64 else 1)
        assert float((p - want[0]).abs().max()) <= (1e-10 if f64
                                                    else 5e-4) * scale


def test_p4_p5_f64_plans():
    """What each library's create makes of the 1024² grid (the CLI's
    converged MG: levels 1024² .. 32², the W on levels 0 and 1), in f32
    and f64: P5 on 1 x 1 gathers where its coarse cycle takes over, P3's
    level (f32 128², 184,320 bytes of shared memory; f64 64², 73,728: the
    levels below 128² do not fit a CTA in f64); P4's block MG on a 512²
    block of 2 x 2 takes over at the block's 128² (f32) or 64² (f64)."""
    from euler_tpu_torch.ops.cuda import pcg_general_kernel as p13
    from euler_tpu_torch.ops.cuda import pcg_mg_blocks_kernel as p5
    from euler_tpu_torch.ops.cuda import pcg_shard_kernel as p4
    from euler_tpu_torch.parallel import spatial_mg
    from euler_tpu_torch.parallel.comm import LocalGroup

    _card()
    dev = torch.device("cuda", 0)
    want = {"float32": (3, 184_320, 2), "float64": (4, 73_728, 3)}
    for dtype, (fused, smem, block_fused) in want.items():
        cfg = SimConfig(nx=1024, ny=1024, solver=SolverConfig(
            preconditioner="mg", dtype=dtype, tol_rel=1e-4,
            max_iterations=100))
        p3_plan = p13.workspace(cfg, dev).plan()
        assert (p3_plan["fused"], p3_plan["smem"]) == (fused, smem)

        def rank(comm):
            plan = spatial_mg.block_plan(cfg, comm, ("y",))
            return p5.workspace(cfg, comm, plan, dev).cycle_plan()

        with LocalGroup(1, device=dev) as g:
            got = g.run(rank)[0]
        assert got == {"fused": fused, "smem": smem, "levels": 6,
                       "gather": fused}, (dtype, got)
        ws = p4.ShardWorkspace(cfg, (512, 512), dev)
        try:
            got = ws.plan()
        finally:
            ws.close()
        below = sum(Y * X for Y, X in ws.shapes[block_fused + 1:])
        item = torch.finfo(getattr(torch, dtype)).bits // 8
        assert got == {"fused": block_fused, "smem": 9 * item * below,
                       "levels": 5}, (dtype, got)


def test_p5_col_frame_card_vs_cpu():
    """The 64² dam break (mg_min_size 8) with the global MG solve on 2 x 2
    in-process blocks, 3 frames: P5 on the card (launched once a block a
    substep, no plain version) against its plain version on the CPU (P3's
    rounding against the plain cycle's: at most 4 cells' counts apart,
    as chip_smoke.py holds frames of two layouts, the live markers and
    drops equal, u and v within 2e-3)."""
    from euler_tpu_torch.parallel.comm import LocalGroup
    from euler_tpu_torch.parallel.spatial import (
        gather_spatial,
        make_spatial_step,
        shard_spatial,
    )

    _card()
    cfg = SimConfig(nx=64, ny=64, marker_layout="slots", max_substeps=2,
                    solver=SolverConfig(max_iterations=100, tol_rel=1e-4,
                                        dtype="float32", preconditioner="mg",
                                        warm_start=True, mg_min_size=8))
    scn, st = dam_break(cfg, device="cpu")

    def run(device):
        def rank(comm):
            step = make_spatial_step(cfg, comm)
            bs, b = shard_spatial(cfg, comm, scn, st)
            for _ in range(3):
                b = step(bs, b)
            out = gather_spatial(cfg, comm, b)
            return out.replace(**{f.name: getattr(out, f.name).cpu()
                                  for f in dataclasses.fields(out)})

        with LocalGroup(2, 2, device=device) as g:
            return g.run(rank)[0]

    _build.LAUNCHES.clear()
    _build.PLAIN_CALLS.clear()
    got = run("cuda")
    assert _build.LAUNCHES["P5"] == 4 * 3 * cfg.max_substeps
    assert _build.LAUNCHES["P4"] == 0 and not any(_build.PLAIN_CALLS.values())
    want = run("cpu")
    assert int((got.marker_count != want.marker_count).sum()) <= 4
    for name in ("alive_count", "dropped_markers"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for name in ("u", "v"):
        assert float((getattr(got, name) - getattr(want, name)).abs()
                     .max()) <= 2e-3, name


def _ic0_system(ny, nx=None, dtype="float64"):
    """(cfg, b, a_diag, fluid, p0) on the card: a substep's own system of
    the dam break at ny x nx, 3 frames on, under the golden
    configuration's solve with IC(0) (f64, cap 400; P1 + P2), in `dtype`
    (the RHS of the advected velocities; the state's pressure, masked)."""
    from euler_tpu_torch.ops.cuda.grid_kernel import grid_stage_plain
    from euler_tpu_torch.ops.project import (
        divergence_rhs,
        pressure_matrix_diag,
    )

    _card()
    cfg = SimConfig(nx=nx or ny, ny=ny, marker_layout="slots",
                    solver=SolverConfig(max_iterations=400, dtype="float64",
                                        preconditioner="ic0"))
    scn, st = dam_break(cfg, device="cuda")
    for _ in range(3):
        st = sim.step_frame(cfg, scn, st)
    dt = sim._dt_from_msq(cfg, max_speed_sq(cfg, st.u, st.v),
                          torch.full((), cfg.frame_time, device="cuda"))
    ut, vt = grid_stage_plain(cfg, dt, st.u, st.v, st.fluid, st.prev_fluid,
                              scn.solid)
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, dtype=dtype))
    t = getattr(torch, dtype)
    b = divergence_rhs(cfg, ut, vt, st.fluid, dt).to(t)
    a_diag = pressure_matrix_diag(cfg, scn.solid, st.fluid)
    return cfg, b, a_diag, st.fluid, torch.where(st.fluid, st.p, 0.0).to(t)


def _p6(cfg, y, x, fn, *planes):
    """fn(comm, axes, *cuts) on y x x in-process blocks on the card, the
    blocks' results gathered: [(every output of fn put together)]."""
    from euler_tpu_torch.parallel.spatial_mg import gather_plane

    def call(comm, cut, axes):
        out = fn(comm, axes, *(None if t is None else t[cut].contiguous()
                               for t in planes))
        return tuple(gather_plane(t, comm, axes) if t.dim() == 2
                     else t.item() for t in out)

    return _p5_blocks(cfg, y, x, call)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("layout", [(2, 2), (4, 1)])
def test_p6_sweeps_bitwise_p2(layout, dtype):
    """P6's E_inv and one application on the blocks of the 256² system,
    gathered, bit for bit P2's (`ic0_apply`)."""
    from euler_tpu_torch.ops.cuda.pcg_general_kernel import ic0_apply
    from euler_tpu_torch.parallel import spatial_ic0

    cfg, b, a_diag, fl, _ = _ic0_system(256, dtype=dtype)
    z2, e2 = ic0_apply(a_diag, fl, b, e_inv=True)
    _build.LAUNCHES.clear()
    _build.PLAIN_CALLS.clear()
    e_inv, z = _p6(cfg, *layout, lambda comm, axes, a, f, r:
                   spatial_ic0.precondition_blocks(cfg, comm, axes, a, f, r),
                   a_diag, fl, b)[0]
    assert _build.LAUNCHES["P6"] == layout[0] * layout[1]
    assert not _build.PLAIN_CALLS
    assert bool(z2.abs().max() > 0)
    assert torch.equal(e_inv, e2) and torch.equal(z, z2)


def _p6_solve(cfg, b, a_diag, fl, y, x, x0=None):
    from euler_tpu_torch.parallel import spatial_ic0

    out = _p6(cfg, y, x, lambda comm, axes, *t:
              spatial_ic0.solve_pressure_blocks_ic0(cfg, comm, axes, *t),
              b, a_diag, fl, x0)
    assert len({o[1:] for o in out}) == 1
    return out[0]


def test_p6_one_block_bitwise_p1_p2():
    """P6 on 1 x 1 blocks is P1 + P2 bit for bit (p, iterations,
    residual), cold and warm; on 2 x 2 blocks the iterations within 1 and
    p within 1e-9 of scale; one P6 launch a block a solve, no plain
    call."""
    from euler_tpu_torch.ops.cuda import pcg_general_kernel as p12

    cfg, b, a_diag, fl, p0 = _ic0_system(256)
    for x0 in (None, p0):
        want = p12.solve_pressure_general(cfg, b, a_diag, fl, x0=x0)
        _build.LAUNCHES.clear()
        _build.PLAIN_CALLS.clear()
        p, it, res = _p6_solve(cfg, b, a_diag, fl, 1, 1, x0)
        assert _build.LAUNCHES["P6"] == 1 and not _build.PLAIN_CALLS
        assert torch.equal(p, want[0]) and it == int(want[1]) > 1
        assert res == float(want[2])
        p, it, res = _p6_solve(cfg, b, a_diag, fl, 2, 2, x0)
        assert _build.LAUNCHES["P6"] == 5
        assert abs(it - int(want[1])) <= 1
        scale = float(want[0].abs().max())
        assert float((p - want[0]).abs().max()) <= 1e-9 * scale


def test_p6_matches_plain_on_the_card():
    """P6 against its plain version on the same card tensors at 40 x 100
    on 2 x 2 blocks: iterations within 1, p within 1e-9 of scale."""
    from euler_tpu_torch.parallel import spatial_ic0
    from euler_tpu_torch.parallel.halo import pcg_sharded

    cfg, b, a_diag, fl, _ = _ic0_system(40, 100)
    got = _p6_solve(cfg, b, a_diag, fl, 2, 2)
    want = _p6(cfg, 2, 2, lambda comm, axes, bb, a, f: pcg_sharded(
        cfg, comm, axes, bb, a, f,
        precon=spatial_ic0.block_ic0(cfg, comm, axes, a, f),
        grid_order=True), b, a_diag, fl)[0]
    assert abs(got[1] - want[1]) <= 1 and got[1] > 1
    scale = float(want[0].abs().max())
    assert float((got[0] - want[0]).abs().max()) <= 1e-9 * scale


def test_p6_col_frame_card_vs_cpu():
    """The 64² dam break with the global IC(0) solve (f64) on 2 x 2
    in-process blocks, 2 frames: P6 on the card (launched once a block a
    substep, no plain version) against its plain version on the CPU: at
    most 4 cells' counts apart, the drops equal, u and v within 1e-4."""
    from euler_tpu_torch.parallel.comm import LocalGroup
    from euler_tpu_torch.parallel.spatial import (
        gather_spatial,
        make_spatial_step,
        shard_spatial,
    )

    _card()
    cfg = SimConfig(nx=64, ny=64, marker_layout="slots", max_substeps=2,
                    solver=SolverConfig(max_iterations=400,
                                        dtype="float64",
                                        preconditioner="ic0"))
    scn, st = dam_break(cfg, device="cpu")

    def run(device):
        def rank(comm):
            step = make_spatial_step(cfg, comm)
            bs, b = shard_spatial(cfg, comm, scn, st)
            for _ in range(2):
                b = step(bs, b)
            out = gather_spatial(cfg, comm, b)
            return out.replace(**{f.name: getattr(out, f.name).cpu()
                                  for f in dataclasses.fields(out)})

        with LocalGroup(2, 2, device=device) as g:
            return g.run(rank)[0]

    _build.LAUNCHES.clear()
    _build.PLAIN_CALLS.clear()
    got = run("cuda")
    assert _build.LAUNCHES["P6"] == 4 * 2 * cfg.max_substeps
    assert _build.LAUNCHES["P4"] == 0 and not any(_build.PLAIN_CALLS.values())
    want = run("cpu")
    assert int((got.marker_count != want.marker_count).sum()) <= 4
    for name in ("alive_count", "dropped_markers"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for name in ("u", "v"):
        assert float((getattr(got, name) - getattr(want, name)).abs()
                     .max()) <= 1e-4, name
