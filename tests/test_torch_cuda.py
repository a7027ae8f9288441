"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips on a host without an NVIDIA GPU (the
kernels have no CPU mode).  Imports nothing of JAX, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import ctypes
import dataclasses

import pytest
import torch

from euler_tpu_torch import sim
from euler_tpu_torch.config import SimConfig, SolverConfig
from euler_tpu_torch.core.presets import dam_break
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda import grid_kernel as k7
from euler_tpu_torch.ops.cuda import marker_fused_kernel as k1
from euler_tpu_torch.ops.cuda import marker_kernel as k5
from euler_tpu_torch.ops.cuda import mg_kernel as k3
from euler_tpu_torch.ops.cuda import mg_stream_kernel as k11
from euler_tpu_torch.ops.cuda import pcg_kernel as k89
from euler_tpu_torch.ops.cuda import pcg_stream_kernel as k12
from euler_tpu_torch.ops.cuda import rebin_kernel as k6
from euler_tpu_torch.ops.cuda import substep_kernel as k2
from euler_tpu_torch.ops import markers_slots as tms
from euler_tpu_torch.ops.forces import max_speed_sq
from euler_tpu_torch.ops.project import divergence_rhs, pressure_matrix_diag

from grid_states import grid_state
from marker_states import marker_state, rebin_state

pytestmark = pytest.mark.cuda

SIZE = 128


def _cfg(size=SIZE):
    return SimConfig(
        nx=size, ny=size, marker_layout="slots",
        solver=SolverConfig(max_iterations=100, dtype="float32",
                            tol_rel=1e-4, preconditioner="mg",
                            warm_start=True, fuse_projection=True))


def _develop(size):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cfg = _cfg(size)
    scn, st = dam_break(cfg, device="cuda")
    for _ in range(4):
        st = sim.step_frame(cfg, scn, st)
    dt = sim._dt_from_msq(cfg, max_speed_sq(cfg, st.u, st.v),
                          torch.tensor(cfg.frame_time, device="cuda"))
    return cfg, scn, st, dt


@pytest.fixture(scope="module")
def developed():
    return _develop(SIZE)


@pytest.fixture(scope="module")
def developed256():
    """The 256² dam break 4 frames in, and its substep's own system."""
    cfg, scn, st, dt = _develop(256)
    ut, vt = k7.grid_stage_plain(cfg, dt, st.u, st.v, st.fluid,
                                 st.prev_fluid, scn.solid)
    b = divergence_rhs(cfg, ut, vt, st.fluid, dt)
    a = pressure_matrix_diag(cfg, scn.solid, st.fluid)
    return cfg, scn, st, dt, b, a


@pytest.mark.parametrize("mask", ["state", "shifted"])
def test_marker_pass_bitwise(developed, mask):
    """The state's own fluid mask, and one that is not count > 0: the
    kernel reads the mask it is given, as the plain version does."""
    cfg, scn, st, dt = developed
    K = cfg.slots_per_cell
    fluid = st.fluid
    if mask == "shifted":
        fluid = (fluid | torch.roll(fluid, 1, 0)).contiguous()
        assert not torch.equal(fluid, st.marker_count > 0)
    args = (cfg, st.u, st.v, fluid, scn.solid,
            st.markers.reshape(2 * K, cfg.ny, cfg.nx), dt, st.marker_count)
    dead = scn.sink | scn.solid
    got = k1.march_rebin(*args, dead=dead)
    want = k1.march_rebin_plain(*args, dead=dead)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _marker_args(developed, zero_dt):
    cfg, scn, st, dt = developed
    if zero_dt:
        dt = torch.zeros((), device="cuda")
    return cfg, scn, st, dt, (cfg, st.u, st.v, st.fluid, scn.solid)


@pytest.mark.parametrize("zero_dt", [False, True])
def test_march_bitwise(developed, zero_dt):
    """K5: every slot, live and dead, bitwise; dt = 0 is an identity."""
    cfg, scn, st, dt, args = _marker_args(developed, zero_dt)
    got = k5.advect_markers(*args, st.markers, dt, st.marker_count)
    want = k5.advect_markers_plain(*args, st.markers, dt, st.marker_count)
    assert got.shape == st.markers.shape and torch.equal(got, want)
    assert torch.equal(got, st.markers) == zero_dt


def _holed(alive, seed):
    """`alive` with a seeded 30% of its live slots cleared: holes, so the
    plane is not front-compacted (every live marker keeps a real
    position)."""
    g = torch.Generator(device=alive.device).manual_seed(seed)
    keep = torch.rand(alive.shape, generator=g, device=alive.device) >= 0.3
    return alive & keep


@pytest.mark.parametrize("alive", ["state", "holes"])
@pytest.mark.parametrize("zero_dt", [False, True])
def test_rebin_bitwise(developed, zero_dt, alive):
    """K6 on K5's output with the state's alive plane, and with one with
    holes: the whole store, alive, counts and drops bitwise."""
    cfg, scn, st, dt, args = _marker_args(developed, zero_dt)
    marched = k5.advect_markers(*args, st.markers, dt, st.marker_count)
    valid = st.alive if alive == "state" else _holed(st.alive, 9)
    if alive == "holes":
        count = valid.sum(0, dtype=torch.int32)
        front = tms.live_slots(count, cfg.slots_per_cell)
        assert not torch.equal(valid, front)
    dead = scn.sink | scn.solid
    got = k6.rebin_markers(cfg, marched, valid, dead)
    want = k6.rebin_markers_plain(cfg, marched, valid, dead)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if zero_dt and alive == "state":
        assert torch.equal(got[0], st.markers)
        assert torch.equal(got[2], st.marker_count)


# K5 and K6 on seeded states (tests/marker_states.py): ragged grids at K =
# 8 and 16, cells driven over K, an empty store
UNFUSED_CASES = [(100, 136, 8, "mixed"), (100, 136, 16, "full"),
                 (257, 130, 8, "full"), (257, 130, 16, "mixed"),
                 (257, 130, 8, "empty")]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.parametrize("zero_dt", [False, True])
@pytest.mark.parametrize("Y,X,K,fill", UNFUSED_CASES)
def test_march_tiles_bitwise(Y, X, K, fill, zero_dt):
    """K5 on a store whose dead slots hold stale positions: every slot
    bitwise its plain version's, the dead ones copied through."""
    _needs_card()
    cfg, u, v, fluid, solid, slots, dt, count, dead = marker_state(
        Y, X, K, fill, seed=Y * X + K, device="cuda", stale=True)
    if zero_dt:
        dt = torch.zeros((), device="cuda")
    markers = slots.reshape(2, K, Y, X)
    args = (cfg, u, v, fluid, solid, markers, dt, count)
    got = k5.advect_markers(*args)
    want = k5.advect_markers_plain(*args)
    assert got.dtype == want.dtype and torch.equal(got, want)
    live = torch.stack([tms.live_slots(count, K)] * 2)
    assert torch.equal(got[~live], markers[~live])
    assert torch.equal(got, markers) == (zero_dt or fill == "empty")


@pytest.mark.parametrize("holes", [False, True])
@pytest.mark.parametrize("Y,X,K,fill", UNFUSED_CASES)
def test_rebin_tiles_bitwise(Y, X, K, fill, holes):
    """K6 on marched seeded stores, the alive plane front-compacted or
    with holes and live slots beyond the count: the whole store, alive,
    counts and drops bitwise its plain version's."""
    _needs_card()
    cfg, markers, alive, dead = rebin_state(Y, X, K, fill, seed=Y * X + K,
                                            holes=holes, device="cuda")
    got = k6.rebin_markers(cfg, markers, alive, dead)
    want = k6.rebin_markers_plain(cfg, markers, alive, dead)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if fill == "full" and not holes:
        assert int(got[3].sum()) > 0


def test_unfused_passes_keep_the_kernels_store(developed, monkeypatch):
    """`advect_markers_slots` and `refresh_marker_counts_slots` take the
    kernels' [2, K, Y, X] output as `state.markers` as it is: the very
    tensor, and no copy or concatenation runs on the card."""
    cfg, scn, st, dt = developed
    outs = {}

    def spy(name, fn):
        def call(*a, **kw):
            outs[name] = fn(*a, **kw)
            return outs[name]
        return call

    monkeypatch.setattr(k5, "advect_markers", spy("K5", k5.advect_markers))
    monkeypatch.setattr(k6, "rebin_markers", spy("K6", k6.rebin_markers))
    before = dict(_build.LAUNCHES)
    marched = tms.advect_markers_slots(cfg, scn, st, dt)
    rebinned = tms.refresh_marker_counts_slots(cfg, scn, marched)
    assert marched.markers is outs["K5"]
    assert rebinned.markers is outs["K6"][0]
    assert rebinned.alive is outs["K6"][1]
    assert _build.LAUNCHES["K5"] == before.get("K5", 0) + 1
    assert _build.LAUNCHES["K6"] == before.get("K6", 0) + 1
    for fn in (lambda: tms.advect_markers_slots(cfg, scn, st, dt),
               lambda: tms.refresh_marker_counts_slots(cfg, scn, marched)):
        names, _ = _kernel_launches(fn)
        assert not [n for n in names
                    if "Cat" in n or "opy" in n or "emcpy" in n], names


def _interior(out, cfg):
    """K4's outputs with the store cut to its interior."""
    slots, count, drop = out
    return (slots[:, 8:8 + cfg.ny, 128:128 + cfg.nx], count, drop)


@pytest.mark.parametrize("zero_dt", [False, True])
def test_march_rebin_padded_bitwise(developed, zero_dt):
    """K4's interior against its plain version and against K1, with
    garbage in the input's pads."""
    cfg, scn, st, dt, args = _marker_args(developed, zero_dt)
    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    store = torch.full((2 * K, Y + 16, X + 256), float("nan"), device="cuda")
    store[:, 8:8 + Y, 128:128 + X] = st.markers.reshape(2 * K, Y, X)
    dead = scn.sink | scn.solid
    got = _interior(k1.march_rebin_padded(*args, store, dt,
                                          st.marker_count, dead=dead), cfg)
    want = _interior(k1.march_rebin_padded_plain(
        *args, store, dt, st.marker_count, dead=dead), cfg)
    fused = k1.march_rebin(*args, st.markers.reshape(2 * K, Y, X), dt,
                           st.marker_count, dead=dead)
    for a, b, c in zip(got, want, fused):
        assert torch.equal(a, b) and torch.equal(a, c)
    if zero_dt:
        assert torch.equal(got[0], st.markers.reshape(2 * K, Y, X))


# K1 / K4 on seeded states (tests/marker_states.py): ragged grids that
# leave partial edge tiles, K = 4, 8 and 16, cells driven over K, an empty
# store
TILE_CASES = [(100, 136, 4, "mixed"), (100, 136, 8, "full"),
              (100, 136, 16, "mixed"), (257, 130, 8, "mixed"),
              (257, 130, 16, "full"), (257, 130, 4, "empty")]


def _tile_state(Y, X, K, fill, zero_dt):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cfg, u, v, fluid, solid, slots, dt, count, dead = marker_state(
        Y, X, K, fill, seed=Y * X + K, device="cuda")
    if zero_dt:
        dt = torch.zeros((), device="cuda")
    return cfg, (cfg, u, v, fluid, solid), slots, dt, count, dead


@pytest.mark.parametrize("zero_dt", [False, True])
@pytest.mark.parametrize("Y,X,K,fill", TILE_CASES)
def test_marker_pass_tiles_bitwise(Y, X, K, fill, zero_dt):
    """K1 against its plain version: the whole store (dead slots' zeros
    included), counts and drops bitwise; dt = 0 is an identity."""
    cfg, args, slots, dt, count, dead = _tile_state(Y, X, K, fill, zero_dt)
    got = k1.march_rebin(*args, slots, dt, count, dead=dead)
    want = k1.march_rebin_plain(*args, slots, dt, count, dead=dead)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if zero_dt:
        assert torch.equal(got[0], slots) and torch.equal(got[1], count)
        assert not bool(got[2].any())
    elif fill == "full":
        assert int(got[2].sum()) > 0


@pytest.mark.parametrize("zero_dt", [False, True])
@pytest.mark.parametrize("Y,X,K,fill", TILE_CASES)
def test_marker_pass_padded_tiles_bitwise(Y, X, K, fill, zero_dt):
    """K4 with NaN in its input's pads: the whole interior store, counts
    and drops bitwise its plain version's and K1's."""
    cfg, args, slots, dt, count, dead = _tile_state(Y, X, K, fill, zero_dt)
    store = torch.full((2 * K, Y + 16, X + 256), float("nan"), device="cuda")
    store[:, 8:8 + Y, 128:128 + X] = slots
    got = _interior(k1.march_rebin_padded(*args, store, dt, count,
                                          dead=dead), cfg)
    want = _interior(k1.march_rebin_padded_plain(*args, store, dt, count,
                                                 dead=dead), cfg)
    fused = k1.march_rebin(*args, slots, dt, count, dead=dead)
    for a, b, c in zip(got, want, fused):
        assert torch.equal(a, b) and torch.equal(a, c)
    if zero_dt:
        assert torch.equal(got[0], slots)


# cuGraphNodeGetType's kinds that put work on the card by themselves
_NODE_KINDS = {0: "kernel", 1: "Memcpy", 2: "Memset"}


def _kernel_launches(fn):
    """(names, calls): the kernels, copies and sets that one fn() call
    puts on the card, and how many times fn() was called.  The call after
    a warm-up one is captured into a CUDA graph and the graph's nodes are
    read through the driver (cuGraphGetNodes; a kernel node by its
    function's name, which holds the kernel's own).  A capture holds every
    launch: a torch.profiler session on the card now and then comes back
    without the kernel it ran (a K1 call three sessions in a row)."""
    cu = ctypes.CDLL("libcuda.so.1")

    def call(name, *args):
        rc = getattr(cu, name)(*args)
        assert rc == 0, f"{name}: CUDA driver error {rc}"

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    call("cuGraphGetNodes", raw, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    call("cuGraphGetNodes", raw, nodes, ctypes.byref(n))
    names = []
    for node in nodes:
        kind = ctypes.c_int()
        call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
        name = _NODE_KINDS.get(kind.value, f"node of kind {kind.value}")
        if kind.value == 0:
            # CUDA_KERNEL_NODE_PARAMS_v2 begins with the CUfunction
            params = (ctypes.c_void_p * 16)()
            call("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node),
                 params)
            fname = ctypes.c_char_p()
            call("cuFuncGetName", ctypes.byref(fname),
                 ctypes.c_void_p(params[0]))
            name = fname.value.decode()
        names.append(name)
    del graph
    return names, 2


@pytest.mark.parametrize("kernel", ["K1", "K4", "K5", "K6"])
def test_marker_kernels_launch_once(developed, kernel):
    """Each marker kernel is one launch of its tiled pass a call and
    allocates nothing but its outputs (no marched scratch)."""
    cfg, scn, st, dt, args = _marker_args(developed, False)
    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    dead = scn.sink | scn.solid
    padded = k1.pad_slot_store(cfg, st.markers)
    calls = {
        "K1": ("march_rebin_tiles", lambda: k1.march_rebin(
            *args, st.markers.reshape(2 * K, Y, X), dt, st.marker_count,
            dead=dead)),
        "K4": ("march_rebin_tiles", lambda: k1.march_rebin_padded(
            *args, padded, dt, st.marker_count, dead=dead)),
        "K5": ("march_tiles", lambda: (k5.advect_markers(
            *args, st.markers, dt, st.marker_count),)),
        "K6": ("rebin_tiles", lambda: k6.rebin_markers(
            cfg, st.markers, st.alive, dead)),
    }
    name, fn = calls[kernel]
    before = _build.LAUNCHES[kernel]
    launched, calls = _kernel_launches(fn)
    assert len(launched) == 1 and name in launched[0], launched
    assert _build.LAUNCHES[kernel] == before + calls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    out = fn()
    assert torch.cuda.max_memory_allocated() - held == sum(
        t.numel() * t.element_size() for t in out)


def test_grid_stage_launches_once(developed):
    """K7 is one launch of the tiled grid stage a call, in both forms, and
    allocates nothing but its outputs.  K2 and K10 run the same
    `grid_passes` (test_fused_grid_stage_is_k7 holds their output to
    K7's bit for bit)."""
    cfg, scn, st, dt = developed
    args = (st.u, st.v, st.fluid, st.prev_fluid, scn.solid)
    for extrapolated in (False, True):
        before = _build.LAUNCHES["K7"]
        launched, calls = _kernel_launches(lambda: k7.grid_stage(
            cfg, *args, dt, extrapolated=extrapolated))
        assert len(launched) == 1 and "grid_tiles" in launched[0], launched
        assert _build.LAUNCHES["K7"] == before + calls
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        out = k7.grid_stage(cfg, *args, dt, extrapolated=extrapolated)
        assert len(out) == (4 if extrapolated else 2)
        assert torch.cuda.max_memory_allocated() - held == sum(
            t.numel() * t.element_size() for t in out)


def test_substep_matches_plain(developed):
    cfg, scn, st, dt = developed
    args = (cfg, dt, dt, st.u, st.v, st.fluid, st.prev_fluid, scn.solid,
            st.p)
    u, v, it, _, msq, _ = k2.project_substep_mg(*args)
    up, vp, itp, _, msqp, _ = k2.project_substep_mg_plain(*args)
    assert (u - up).abs().max() <= 2e-3 and (v - vp).abs().max() <= 2e-3
    assert abs(int(it) - int(itp)) <= 1
    assert abs(float(msq) - float(msqp)) <= 1e-3 * float(msqp)


@pytest.mark.parametrize("warm", [False, True])
def test_solve_matches_plain(developed, warm):
    cfg, scn, st, dt = developed
    ut, vt = k2.grid_stage_plain(cfg, dt, st.u, st.v, st.fluid,
                                 st.prev_fluid, scn.solid)
    b = divergence_rhs(cfg, ut, vt, st.fluid, dt)
    a = pressure_matrix_diag(cfg, scn.solid, st.fluid)
    x0 = st.p if warm else None
    p, it, _ = k3.solve_pressure_mg(cfg, b, a, st.fluid, x0=x0)
    pp, itp, _ = k3.solve_pressure_mg_plain(cfg, b, a, st.fluid, x0)
    assert (p - pp).abs().max() <= 5e-4 * pp.abs().max()
    assert abs(int(it) - int(itp)) <= 1


@pytest.mark.parametrize("size,degree", [(128, 2), (32, 1)])
def test_solve_other_schedules(developed, size, degree):
    """Chebyshev degree 2 (the general smoother kernels) and a grid that
    is its own coarsest level (one-level cycle)."""
    import dataclasses

    cfg = _cfg(size)
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, mg_cheby_degree=degree))
    scn, st = dam_break(cfg, device="cuda")
    st = sim.step_frame(cfg, scn, st)
    dt = torch.tensor(0.05, device="cuda")
    ut, vt = k2.grid_stage_plain(cfg, dt, st.u, st.v, st.fluid,
                                 st.prev_fluid, scn.solid)
    b = divergence_rhs(cfg, ut, vt, st.fluid, dt)
    a = pressure_matrix_diag(cfg, scn.solid, st.fluid)
    p, it, _ = k3.solve_pressure_mg(cfg, b, a, st.fluid, x0=st.p)
    pp, itp, _ = k3.solve_pressure_mg_plain(cfg, b, a, st.fluid, st.p)
    assert int(itp) > 0
    assert (p - pp).abs().max() <= 5e-4 * pp.abs().max()
    assert abs(int(it) - int(itp)) <= 1


@pytest.mark.parametrize("pre,post", [(1, 1), (0, 2)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rbgs_cycle_fused_equals_per_op(developed256, dtype, pre, post):
    """P3 with RB-GS smoothing (csrc/pcg_mg.cu): one preconditioner
    application on the hierarchy of the last solve at 256² (levels 256²
    to 32², the W on levels 0 and 1), through coarse_cycle_rbgs (one
    cluster launch from 64² down) and through one launch per half-sweep
    and level operation, bitwise equal and nonzero, with 0 pre-sweeps
    too (a zero fill); near the plain `cycle_galerkin` (f32: 1e-4 of
    scale, f64: 1e-10; the plain level 0 sums its edge form's products,
    the kernel its packed neighbours)."""
    import dataclasses

    from euler_tpu_torch.ops.cuda import pcg_general_kernel as p3
    from euler_tpu_torch.ops.project import make_preconditioner

    cfg, scn, st, dt, b, a = developed256
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, dtype=dtype, mg_smoother="rbgs", mg_pre_smooth=pre,
        mg_post_smooth=post))
    b = b.to(getattr(torch, dtype))
    p3.solve_pressure_general(cfg, b, a, st.fluid)
    ws = p3.workspace(cfg, b.device)
    assert ws.plan()["fused"] == 2
    fused = ws.cycle(b, per_op=False)
    per_op = ws.cycle(b, per_op=True)
    assert bool(fused.abs().max() > 0)
    assert torch.equal(fused, per_op)
    want = make_preconditioner(cfg, a, st.fluid)(b)
    rel = 1e-4 if dtype == "float32" else 1e-10
    assert float((fused - want).abs().max()) <= rel * float(
        want.abs().max())


def test_frames_match_cpu_plain(developed):
    cfg = _cfg(64)
    scn_g, st_g = dam_break(cfg, device="cuda")
    scn_c, st_c = dam_break(cfg, device="cpu")
    for _ in range(2):
        st_g = sim.step_frame(cfg, scn_g, st_g)
        st_c = sim.step_frame(cfg, scn_c, st_c)
    assert torch.equal(st_g.marker_count.cpu(), st_c.marker_count)
    assert (st_g.u.cpu() - st_c.u).abs().max() <= 5e-3
    assert (st_g.v.cpu() - st_c.v).abs().max() <= 5e-3


def _speed(cfg):
    """The Jacobi speed mode on `cfg`'s grid (bench.py --precon jacobi)."""
    return dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, preconditioner="jacobi", tol=1e-6, tol_rel=1e-6,
        warm_start=False))


def _jacobi_system(developed):
    cfg, scn, st, dt = developed
    cfg = _speed(cfg)
    ut, vt = k2.grid_stage_plain(cfg, dt, st.u, st.v, st.fluid,
                                 st.prev_fluid, scn.solid)
    return cfg, scn, st, dt, ut, vt


def test_jacobi_solve_matches_plain(developed):
    cfg, scn, st, dt, ut, vt = _jacobi_system(developed)
    b = divergence_rhs(cfg, ut, vt, st.fluid, dt)
    a = pressure_matrix_diag(cfg, scn.solid, st.fluid)
    p, it, _ = k89.solve_pressure_jacobi(cfg, b, a, st.fluid)
    pp, itp, _ = k89.solve_pressure_jacobi_plain(cfg, b, a, st.fluid)
    assert int(it) == int(itp) > 0
    assert (p - pp).abs().max() <= 1e-4 * pp.abs().max()


def test_jacobi_project_matches_plain(developed):
    cfg, scn, st, dt, ut, vt = _jacobi_system(developed)
    args = (cfg, dt, ut, vt, st.fluid, scn.solid)
    u, v, it, _, msq = k89.project_jacobi(*args)
    up, vp, itp, _, msqp = k89.project_jacobi_plain(*args)
    assert (u - up).abs().max() <= 2e-3 and (v - vp).abs().max() <= 2e-3
    assert abs(int(it) - int(itp)) <= 1
    assert abs(float(msq) - float(msqp)) <= 1e-3 * float(msqp)


@pytest.mark.parametrize("active", [True, False])
def test_jacobi_substep_matches_plain(developed, active):
    cfg, scn, st, dt = developed
    cfg = _speed(cfg)
    dt_proj = dt if active else torch.tensor(float("inf"), device="cuda")
    if not active:
        dt = torch.zeros((), device="cuda")
    args = (cfg, dt, dt_proj, st.u, st.v, st.fluid, st.prev_fluid,
            scn.solid)
    u, v, it, res, msq = k2.project_substep_jacobi(*args)
    up, vp, itp, _, msqp = k2.project_substep_jacobi_plain(*args)
    assert (u - up).abs().max() <= 2e-3 and (v - vp).abs().max() <= 2e-3
    assert abs(int(it) - int(itp)) <= 1
    assert abs(float(msq) - float(msqp)) <= 1e-3 * float(msqp)
    if not active:
        assert int(it) == 0 and float(res) == 0.0
        assert torch.isfinite(u).all() and torch.isfinite(v).all()


def _jacobi_rhs(developed):
    cfg, scn, st, dt, ut, vt = _jacobi_system(developed)
    return (cfg, divergence_rhs(cfg, ut, vt, st.fluid, dt),
            pressure_matrix_diag(cfg, scn.solid, st.fluid), st.fluid)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("cap", [1, 7, 8, 9, 100])
def test_jacobi_stops_at_the_cap(developed, cap):
    """K8 with a tolerance no iterate meets takes exactly `cap`
    iterations (inside the first graph chunk, at its end, one into the
    second, and the speed mode's budget, 100 % 8 = 4) and matches its
    plain version: the p update deferred to the next sweep A is applied
    once and only once, the last one by the finishing launch."""
    cfg, b, a, fl = _jacobi_rhs(developed)
    cfg = _solver(cfg, max_iterations=cap, tol=0.0, tol_rel=0.0)
    p, it, res = k89.solve_pressure_jacobi(cfg, b, a, fl)
    pp, itp, _ = k89.solve_pressure_jacobi_plain(cfg, b, a, fl)
    assert int(it) == int(itp) == cap
    assert pp.abs().max() > 0 and float(res) > 0
    assert (p - pp).abs().max() <= 1e-4 * pp.abs().max()


def _sweeps(fn, sessions: int = 5):
    """fn()'s result and the launches of K8-K10's sweep A and sweep B on
    the card while it runs (torch.profiler).  The sweeps launch in pairs,
    8 of each a graph chunk, and every solve replays at least one chunk,
    so a profile whose counts differ, are not multiples of 8 or are 0
    has lost records (the profiler on the card now and then drops some:
    one counted 31 and 32 of 104 each, another none of 104): it is
    taken again, fn() run anew, up to `sessions` times."""
    from torch.profiler import ProfilerActivity

    for _ in range(sessions):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        counts = {"sweep_a": 0, "sweep_b": 0}
        for e in prof.key_averages():
            for name in counts:
                if name in e.key and not e.key.startswith("cuda"):
                    counts[name] += e.count
        if counts["sweep_a"] == counts["sweep_b"] and \
                counts["sweep_a"] % 8 == 0 and counts["sweep_a"]:
            break
    return out, counts


@pytest.mark.parametrize("cap, tol_rel, zero", [
    (100, 0.3, False), (1000, 0.3, False), (1000, 1e-2, False),
    (9, 0.0, False), (1000, 1e-6, True)])
def test_jacobi_replays_end_with_their_batch(developed, cap, tol_rel, zero):
    """A solve replays its graph of 8 iterations in batches of 13 and
    reads the stop flag only between two batches: a solve that stops
    early under a cap of 100 or of 1000 (tol_rel 0.3: in the first batch
    at 128²; 1e-2: in the second) replays up to the end of the batch it
    stops in, a cap of 9 two chunks, a zero RHS one batch of no-ops; each
    chunk launches each sweep 8 times."""
    cfg, b, a, fl = _jacobi_rhs(developed)
    cfg = _solver(cfg, max_iterations=cap, tol_rel=tol_rel,
                  tol=1e-6 if tol_rel else 0.0)
    if zero:
        b = torch.zeros_like(b)
    (_, it, _), counts = _sweeps(
        lambda: k89.solve_pressure_jacobi(cfg, b, a, fl))
    it = int(it)
    if zero:
        assert it == 0
    elif tol_rel:
        assert 0 < it < cap
    else:
        assert it == cap
    batches = -(-max(-(-it // 8), 1) // 13)
    chunks = min(-(-cap // 8), 13 * batches)
    assert counts == {"sweep_a": 8 * chunks, "sweep_b": 8 * chunks}


def _jacobi_call(kernel, developed, bad):
    """(kernel, plain) outputs of K8, K9 or K10 on the developed state
    with `bad` (inf or NaN) put into its input on a fluid cell, or with a
    zero RHS (bad = 0.0: b = 0 for K8, ut = vt = 0 for K9, dt_proj = inf
    for K10)."""
    cfg, scn, st, dt, ut, vt = _jacobi_system(developed)
    cells = st.fluid.view(-1).nonzero()
    at = int(cells[len(cells) // 2])

    def spoil(t):
        t = torch.zeros_like(t) if bad == 0.0 else t.clone()
        if bad != 0.0:
            t.view(-1)[at] = bad
        return t

    if kernel == "K8":
        _, b, a, fl = _jacobi_rhs(developed)
        args = (cfg, spoil(b), a, fl)
        fns = k89.solve_pressure_jacobi, k89.solve_pressure_jacobi_plain
    elif kernel == "K9":
        args = (cfg, dt, spoil(ut), vt if bad else torch.zeros_like(vt),
                st.fluid, scn.solid)
        fns = k89.project_jacobi, k89.project_jacobi_plain
    else:
        dtp = torch.tensor(float("inf"), device="cuda") if bad == 0.0 else dt
        u = st.u if bad == 0.0 else spoil(st.u)
        args = (cfg, dt, dtp, u, st.v, st.fluid, st.prev_fluid, scn.solid)
        fns = k2.project_substep_jacobi, k2.project_substep_jacobi_plain
    return fns[0](*args), fns[1](*args)


@pytest.mark.parametrize("bad", [float("inf"), float("nan"), 0.0])
@pytest.mark.parametrize("kernel", ["K8", "K9", "K10"])
def test_jacobi_nonfinite_and_zero_rhs(developed, kernel, bad):
    """An inf or a NaN in the RHS: the plain version's iterations and its
    NaN and inf pattern in every output plane.  A zero RHS: 0
    iterations, a zero residual, finite outputs."""
    got, want = _jacobi_call(kernel, developed, bad)
    planes = [0] if kernel == "K8" else [0, 1, 4]
    ki = 1 if kernel == "K8" else 2
    it, res = got[ki], got[ki + 1]
    assert int(it) == int(want[ki])
    if bad == 0.0:
        assert int(it) == 0 and float(res) == 0.0
        for k in planes:
            assert torch.isfinite(got[k]).all()
        return
    assert int(it) == 1
    for k in planes:
        assert torch.equal(got[k].isnan(), want[k].isnan())
        assert torch.equal(got[k].isinf(), want[k].isinf())


def test_jacobi_workspace_reuse_is_bitwise(developed):
    """Two K8 solves on one cached workspace, with K9 and K10 between
    them on the same workspace, give the same bits; the first call's p is
    a plane of its own, unchanged by what follows."""
    cfg, scn, st, dt, ut, vt = _jacobi_system(developed)
    _, b, a, fl = _jacobi_rhs(developed)
    k89.clear_workspaces()
    first = k89.solve_pressure_jacobi(cfg, b, a, fl)
    kept = [t.clone() for t in first]
    k89.project_jacobi(cfg, dt, ut, vt, fl, scn.solid)
    k2.project_substep_jacobi(cfg, dt, dt, st.u, st.v, fl, st.prev_fluid,
                              scn.solid)
    again = k89.solve_pressure_jacobi(cfg, b.clone(), a.clone(), fl.clone())
    assert len(k89._WORKSPACES) == 1
    for x, y, z in zip(first, kept, again):
        assert torch.equal(_bits(x), _bits(y))
        assert torch.equal(_bits(x), _bits(z))
    ws = k89.workspace(cfg, b.device)
    held = {t.data_ptr() for t in ws.buffers()}
    assert held.isdisjoint(t.data_ptr() for t in first + again)


def test_jacobi_two_grids_in_turn(developed256):
    """1024² and 256² in turns: each grid keeps its own cached workspace
    (the cache stays within its bound) and repeats its first solve bit for
    bit, within 1e-4 of its plain version's scale."""
    big = _jacobi_rhs(_develop(1024))
    cfg256, scn, st, dt, b, a = developed256
    small = (_speed(cfg256), b, a, st.fluid)
    k89.clear_workspaces()
    seen = {}
    for _ in range(2):
        for cfg, b, a, fl in (big, small):
            p, it, res = k89.solve_pressure_jacobi(cfg, b, a, fl)
            if cfg.ny in seen:
                for x, y in zip((p, it, res), seen[cfg.ny]):
                    assert torch.equal(_bits(x), _bits(y))
            else:
                pp, itp, _ = k89.solve_pressure_jacobi_plain(cfg, b, a, fl)
                assert int(it) == int(itp) > 0
                assert (p - pp).abs().max() <= 1e-4 * pp.abs().max()
                seen[cfg.ny] = (p, it, res)
    assert [k[1] for k in k89._WORKSPACES] == [1024, 256]
    assert k89.cached_bytes() <= k89._MAX_WORKSPACE_BYTES


@pytest.mark.parametrize("route", ["jacobi_fused", "jacobi_unfused",
                                   "jacobi_rainbow", "mg_rainbow"])
def test_route_frames_match_cpu_plain(developed, route):
    cfg = _cfg(64)
    if route != "mg_rainbow":
        cfg = _speed(cfg)
    cfg = dataclasses.replace(cfg, rainbow=route.endswith("rainbow"),
                              solver=dataclasses.replace(
                                  cfg.solver,
                                  fuse_projection=route != "jacobi_unfused"))
    scn_g, st_g = dam_break(cfg, device="cuda")
    scn_c, st_c = dam_break(cfg, device="cpu")
    for _ in range(2):
        st_g = sim.step_frame(cfg, scn_g, st_g)
        st_c = sim.step_frame(cfg, scn_c, st_c)
    assert torch.equal(st_g.marker_count.cpu(), st_c.marker_count)
    for name in ("u", "v", "r", "g", "b"):
        a, b = getattr(st_g, name).cpu(), getattr(st_c, name)
        assert (a - b).abs().max() <= 5e-3, name


def test_grid_stage_matches_plain(developed256):
    """K7 on the developed 256² state: bit for bit its plain version, and
    the rainbow form's four planes too."""
    cfg, scn, st, dt, _, _ = developed256
    args = (st.u, st.v, st.fluid, st.prev_fluid, scn.solid)
    ut, vt = k7.grid_stage(cfg, *args, dt)
    up, vp = k7.grid_stage_plain(cfg, dt, *args)
    assert torch.equal(_bits(ut), _bits(up))
    assert torch.equal(_bits(vt), _bits(vp))
    got = k7.grid_stage(cfg, *args, dt, extrapolated=True)
    want = (up, vp) + k7.extrapolate_zero(cfg, *args)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


# K7 on seeded states (tests/grid_states.py: newly fluid and solid cells
# on the borders of the plan's tiles) at 64², at ragged sizes, and under
# each tile of tools/grid_tile_lab.py's sweep at one size
GRID_CASES = [(64, 64, None), (100, 257, None), (257, 100, None),
              (37, 53, None), (130, 200, (8, 32, 256)),
              (130, 200, (32, 32, 512)), (130, 200, (8, 64, 256)),
              (130, 200, (16, 64, 512)), (130, 200, (4, 128, 512)),
              (130, 200, (8, 128, 512)), (130, 200, (16, 32, 128))]


@pytest.mark.parametrize("Y,X,tile", GRID_CASES)
def test_grid_tiles_bitwise(Y, X, tile, monkeypatch):
    _needs_card()
    if tile is not None:
        plan_of = k7.grid_tile_plan
        monkeypatch.setattr(k7, "grid_tile_plan",
                            lambda Y, X: plan_of(Y, X, *tile))
    plan = k7.grid_tile_plan(Y, X)
    cfg, *args, dt = grid_state(Y, X, (plan.tile_y, plan.tile_x),
                                seed=Y * X, device="cuda")
    want = k7.grid_stage_plain(cfg, dt, *args) + k7.extrapolate_zero(
        cfg, *args)
    got = k7.grid_stage(cfg, *args, dt, extrapolated=True)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    got = k7.grid_stage(cfg, *args, dt)
    assert len(got) == 2
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


def test_fused_grid_stage_is_k7(developed):
    """K2's and K10's grid stage is K7's bit for bit: K10 equals K9 on
    K7's output, and K2's velocities equal K2's own tail (clamp, face
    update, maxsq) applied to K7's output with K2's pressure."""
    cfg, scn, st, dt = developed
    args = (st.u, st.v, st.fluid, st.prev_fluid, scn.solid)
    scfg = _speed(cfg)
    u10, v10, it10, _, msq10 = k2.project_substep_jacobi(scfg, dt, dt,
                                                         *args)
    ut, vt = k7.grid_stage(cfg, *args, dt)
    u9, v9, it9, _, msq9 = k89.project_jacobi(scfg, dt, ut, vt, st.fluid,
                                              scn.solid)
    assert int(it10) == int(it9) > 0
    for a, b in ((u10, u9), (v10, v9), (msq10, msq9)):
        assert torch.equal(_bits(a), _bits(b))

    u2, v2, it2, _, msq2, p2 = k2.project_substep_mg(cfg, dt, dt, *args,
                                                     st.p)
    assert int(it2) > 0
    ut, vt = (x.clone() for x in k7.grid_stage(cfg, *args, dt))
    Y, X = cfg.ny, cfg.nx
    h = cfg.side_length
    p = torch.empty_like(p2)
    part = torch.empty(2 * -(-Y * X // 256), device="cuda")
    msq = torch.empty((), device="cuda")
    lib = k7.grid_lib()
    rc = lib.eu_project_tail(
        Y, X, -1.0 / (cfg.density * h), st.fluid.data_ptr(),
        scn.solid.data_ptr(), dt.data_ptr(), p2.data_ptr(), p.data_ptr(),
        ut.data_ptr(), vt.data_ptr(), part.data_ptr(), msq.data_ptr(),
        _build.stream())
    _build.check(lib, rc, "eu_project_tail")
    for a, b in ((u2, ut), (v2, vt), (msq2, msq), (p2, p)):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("F", [2, 4])
def test_mg_stream_matches_plain(developed256, monkeypatch, F):
    """The level skip at 256²: the root one level down (F = 2, the 2048²
    transfer) or two (F = 4, the 4096² transfer)."""
    cfg, scn, st, dt, b, a = developed256
    if F == 4:
        monkeypatch.setattr(k11, "_resident_start", lambda shapes: 2)
    assert k11._root(cfg)[2] == F
    p, it, _ = k11.solve_pressure_mg_stream(cfg, b, a, st.fluid)
    pp, itp, _ = k11.solve_pressure_mg_stream_plain(cfg, b, a, st.fluid)
    assert int(itp) > 0
    assert (p - pp).abs().max() <= 5e-4 * pp.abs().max()
    assert abs(int(it) - int(itp)) <= 1


@pytest.mark.parametrize("F", [2, 4])
def test_mg_stream_hierarchy_bitwise(monkeypatch, F):
    """The Galerkin hierarchy and Chebyshev rows K11 builds on the card, on
    a speckled 256² mask with its root one level down (F = 2) or two (F =
    4), equal the plain build bit for bit: every coarse level's planes
    (those between the fine level and the root included) and the rows
    from the root down with the fine level's [it0, 0, ...] after them."""
    fluid, solid, b = _speckled(256, 3)
    cfg = _cfg(256)
    if F == 4:
        monkeypatch.setattr(k11, "_resident_start", lambda shapes: 2)
    _, ls, got_F = k11._root(cfg)
    assert got_F == F
    a = pressure_matrix_diag(cfg, solid, fluid)
    ws = k3.workspace(cfg, b.device, ls)
    ws.stream_solve(a, fluid, b)
    _, packed0, planes, _ = k3.mg_host_operands(cfg, a, fluid)
    _, _, _, res_planes, rows = k11.stream_host_operands(cfg, a, fluid)
    assert torch.equal(ws.packed0, packed0)
    assert len(planes) == len(ws.levels)
    for want, got in zip(planes, ws.levels):
        for x, y in zip(want, got):
            assert torch.equal(x, y)
    for want, got in zip(res_planes, ws.levels[ls - 1:]):
        for x, y in zip(want, got):
            assert torch.equal(x, y)
    assert torch.equal(ws.rows[ls:], rows)


@pytest.mark.parametrize("cap", [1, 3, 8, 9])
def test_mg_stream_stops_at_the_cap(developed256, cap):
    """K11 with a tolerance no iterate meets takes exactly `cap`
    iterations: inside the first graph chunk, at its end, and one into the
    second."""
    cfg, scn, st, dt, b, a = developed256
    cfg = _solver(cfg, max_iterations=cap, tol=0.0, tol_rel=0.0)
    p, it, _ = k11.solve_pressure_mg_stream(cfg, b, a, st.fluid)
    pp, itp, _ = k11.solve_pressure_mg_stream_plain(cfg, b, a, st.fluid)
    assert int(it) == int(itp) == cap
    assert (p - pp).abs().max() <= 5e-4 * pp.abs().max()


def test_mg_stream_workspace_reuse_is_bitwise(developed256):
    """K3 and K11 at the same grid, in turns, each on a workspace of its
    own that an earlier solve (another RHS) has used: bitwise equal to
    solves on fresh workspaces, and nothing returned aliases a
    workspace."""
    cfg, scn, st, dt, b, a = developed256
    k3.clear_workspaces()
    fresh11 = k11.solve_pressure_mg_stream(cfg, b, a, st.fluid)
    k3.clear_workspaces()
    fresh3 = k3.solve_pressure_mg(cfg, b, a, st.fluid, x0=st.p)
    k3.clear_workspaces()
    k11.solve_pressure_mg_stream(cfg, b * 0.5, a, st.fluid)
    for _ in range(2):
        got3 = k3.solve_pressure_mg(cfg, b.clone(), a.clone(),
                                    st.fluid.clone(), x0=st.p.clone())
        got11 = k11.solve_pressure_mg_stream(cfg, b.clone(), a.clone(),
                                             st.fluid.clone())
        for x, y in zip(got3 + got11, fresh3 + fresh11):
            assert torch.equal(x, y)
    assert len(k3._WORKSPACES) == 2
    held = {t.data_ptr() for ws in k3._WORKSPACES.values() for t in ws.keep}
    assert held.isdisjoint(t.data_ptr() for t in got3 + got11)


@pytest.mark.parametrize("cap", [1, 8, 9])
def test_pcg_stream_stops_at_the_cap(developed256, cap):
    """K12 with a tolerance no iterate meets takes exactly `cap`
    iterations and matches its plain version: the p update deferred to
    the next iteration's first sweep is applied once and only once, the
    last one by the finishing launch."""
    cfg, scn, st, dt, b, a = developed256
    cfg = _solver(_speed(cfg), max_iterations=cap, tol=0.0, tol_rel=0.0)
    p, it, res = k12.solve_pressure_stream(cfg, b, a, st.fluid)
    pp, itp, resp = k12.solve_pressure_stream_plain(cfg, b, a, st.fluid)
    assert int(it) == int(itp) == cap
    assert pp.abs().max() > 0
    assert (p - pp).abs().max() <= 1e-4 * pp.abs().max()
    assert abs(float(res) - float(resp)) <= 1e-4 * float(resp)


@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
def test_pcg_stream_nonfinite_rhs(developed256, bad):
    """A non-finite RHS entry on a fluid cell: the same iterations and the
    same NaN and inf pattern in p as the plain version (the pending p
    update is guarded by a flag, not by alpha = 0, which would turn
    0 * inf into NaN)."""
    cfg, scn, st, dt, b, a = developed256
    cfg = _speed(cfg)
    b = b.clone()
    b.view(-1)[int(st.fluid.view(-1).nonzero()[0])] = bad
    p, it, _ = k12.solve_pressure_stream(cfg, b, a, st.fluid)
    pp, itp, _ = k12.solve_pressure_stream_plain(cfg, b, a, st.fluid)
    assert int(it) == int(itp)
    assert torch.equal(p.isnan(), pp.isnan())
    assert torch.equal(p.isinf(), pp.isinf())


def test_pcg_stream_matches_plain(developed256):
    cfg, scn, st, dt, b, a = developed256
    cfg = _speed(cfg)
    p, it, _ = k12.solve_pressure_stream(cfg, b, a, st.fluid)
    pp, itp, _ = k12.solve_pressure_stream_plain(cfg, b, a, st.fluid)
    assert int(it) == int(itp) > 0
    assert (p - pp).abs().max() <= 1e-4 * pp.abs().max()


def _gated_route(route, monkeypatch):
    """The config of a new route with the gates before it turned off."""
    if route == "K11":
        monkeypatch.setattr(k2, "substep_fused_fits", lambda c: False)
        monkeypatch.setattr(k3, "mg_pallas_fits", lambda c: False)
        return _cfg(128)
    cfg = _speed(_cfg(64))
    if route == "K12":
        monkeypatch.setattr(k89, "pallas_solver_fits", lambda c: False)
        monkeypatch.setattr(k89, "fused_projection_fits", lambda c: False)
        monkeypatch.setattr(k2, "substep_jacobi_fused_fits", lambda c: False)
        return cfg
    return dataclasses.replace(cfg, use_pallas_grid=True,
                               solver=dataclasses.replace(
                                   cfg.solver, fuse_projection=False))


@pytest.mark.parametrize("route", ["K5+K6", "K4"])
def test_marker_route_frames(developed, route):
    """2 frames of the 64² main path on a marker route: equal to the K1
    route on the card in counts, drops, u, v and the store; within the
    frame tolerances of the CPU plain versions."""
    cfg = _cfg(64)
    rcfg = dataclasses.replace(cfg, fuse_marker_pass=route != "K5+K6",
                               marker_padded_store=route == "K4")
    scn, st = dam_break(cfg, device="cuda")
    assert sim.marker_route(rcfg, scn) == route
    ref = sim.run_frames(cfg, scn, st, 2)
    _build.LAUNCHES.clear()
    _build.PLAIN_CALLS.clear()
    got = sim.run_frames(rcfg, scn, st, 2)
    launches, plain = dict(_build.LAUNCHES), sum(_build.PLAIN_CALLS.values())
    assert "K1" not in launches and plain == 0
    for k in route.split("+"):
        assert launches[k] == 16
    for name in ("marker_count", "dropped_markers", "u", "v", "markers",
                 "alive", "p"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    scn_c, st_c = dam_break(rcfg, device="cpu")
    st_c = sim.run_frames(rcfg, scn_c, st_c, 2)
    assert torch.equal(got.marker_count.cpu(), st_c.marker_count)
    assert (got.u.cpu() - st_c.u).abs().max() <= 5e-3
    assert (got.v.cpu() - st_c.v).abs().max() <= 5e-3


@pytest.mark.parametrize("route", ["K11", "K12", "K7"])
def test_new_route_frames_match_cpu_plain(developed, monkeypatch, route):
    cfg = _gated_route(route, monkeypatch)
    scn_g, st_g = dam_break(cfg, device="cuda")
    scn_c, st_c = dam_break(cfg, device="cpu")
    assert route in sim.route(cfg, scn_g)
    _build.LAUNCHES.clear()
    _build.PLAIN_CALLS.clear()
    for _ in range(2):
        st_g = sim.step_frame(cfg, scn_g, st_g)
    launches, plain = dict(_build.LAUNCHES), sum(_build.PLAIN_CALLS.values())
    for _ in range(2):
        st_c = sim.step_frame(cfg, scn_c, st_c)
    assert launches.get(route, 0) > 0 and plain == 0
    bypassed = {"K11": {"K2", "K3"}, "K12": {"K8", "K9", "K10"},
                "K7": {"K2", "K10"}}[route]
    assert not bypassed & set(launches)
    assert torch.equal(st_g.marker_count.cpu(), st_c.marker_count)
    assert (st_g.u.cpu() - st_c.u).abs().max() <= 5e-3
    assert (st_g.v.cpu() - st_c.v).abs().max() <= 5e-3


def _mg_system(cfg, scn, st, dt):
    """A substep's own MG system on `st`: the RHS of the advected
    velocities and the diagonal."""
    ut, vt = k2.grid_stage_plain(cfg, dt, st.u, st.v, st.fluid,
                                 st.prev_fluid, scn.solid)
    return (divergence_rhs(cfg, ut, vt, st.fluid, dt),
            pressure_matrix_diag(cfg, scn.solid, st.fluid))


def _solver(cfg, **over):
    return dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver,
                                                               **over))


@pytest.mark.parametrize("cap", [1, 3, 8, 9])
def test_solve_stops_at_the_cap(developed, cap):
    """With a tolerance no iterate meets, exactly `cap` iterations: inside
    the first graph chunk, at its end, and one into the second."""
    cfg, scn, st, dt = developed
    b, a = _mg_system(cfg, scn, st, dt)
    cfg = _solver(cfg, max_iterations=cap, tol=0.0, tol_rel=0.0)
    p, it, _ = k3.solve_pressure_mg(cfg, b, a, st.fluid, x0=st.p)
    pp, itp, _ = k3.solve_pressure_mg_plain(cfg, b, a, st.fluid, st.p)
    assert int(it) == int(itp) == cap
    assert (p - pp).abs().max() <= 5e-4 * pp.abs().max()


def test_workspace_reuse_is_bitwise(developed):
    """A second solve on the same workspace with new input tensors equals
    a solve on a fresh workspace bit for bit, and returns nothing that
    aliases the workspace."""
    cfg, scn, st, dt = developed
    b, a = _mg_system(cfg, scn, st, dt)
    k3.clear_workspaces()
    k3.solve_pressure_mg(cfg, b * 0.5, a, st.fluid, x0=st.p * 2.0)
    again = k3.solve_pressure_mg(cfg, b.clone(), a.clone(), st.fluid.clone(),
                                 x0=st.p.clone())
    assert len(k3._WORKSPACES) == 1
    k3.clear_workspaces()
    fresh = k3.solve_pressure_mg(cfg, b, a, st.fluid, x0=st.p)
    for x, y in zip(again, fresh):
        assert torch.equal(x, y)
    ws = k3.workspace(cfg, b.device)
    assert {t.data_ptr() for t in fresh}.isdisjoint(
        t.data_ptr() for t in ws.keep)


def test_alternating_configs(developed):
    """Two schedules and two grid sizes in turns, each against its plain
    version: the cache hands each its own workspace and graph."""
    cfg, scn, st, dt = developed
    small = _cfg(64)
    sscn, sst = dam_break(small, device="cuda")
    sst = sim.step_frame(small, sscn, sst)
    cases = [(cfg, _mg_system(cfg, scn, st, dt), st),
             (_solver(cfg, mg_cheby_degree=2), _mg_system(cfg, scn, st, dt),
              st),
             (small, _mg_system(small, sscn, sst, dt), sst)]
    for _ in range(2):
        for c, (b, a), s in cases:
            p, it, _ = k3.solve_pressure_mg(c, b, a, s.fluid, x0=s.p)
            pp, itp, _ = k3.solve_pressure_mg_plain(c, b, a, s.fluid, s.p)
            assert int(itp) > 0 and abs(int(it) - int(itp)) <= 1
            assert (p - pp).abs().max() <= 5e-4 * pp.abs().max()


@pytest.mark.parametrize("case", ["developed1024", "speckled256"])
def test_hierarchy_bitwise(case):
    """The Galerkin hierarchy and Chebyshev rows K3 builds on the card
    equal `mg_host_operands` bit for bit: on the developed 1024² dam break
    and on a speckled 256² mask (isolated fluid cells, enclosed blocks)."""
    if case == "developed1024":
        cfg, scn, st, dt = _develop(1024)
        b, a = _mg_system(cfg, scn, st, dt)
        fluid = st.fluid
    else:
        cfg = _cfg(256)
        fluid, solid, b = _speckled(256, 3)
        a = pressure_matrix_diag(cfg, solid, fluid)
    ws = k3.workspace(cfg, b.device)
    ws.load(a, fluid, b)
    ws.solve(warm=False)
    _, packed0, planes, rows = k3.mg_host_operands(cfg, a, fluid)
    assert torch.equal(ws.packed0, packed0)
    assert len(planes) == len(ws.levels)
    for want, got in zip(planes, ws.levels):
        for x, y in zip(want, got):
            assert torch.equal(x, y)
    assert torch.equal(ws.rows, rows)


def _speckled(size, seed):
    """A speckled mask (isolated fluid cells, a filled block, scattered
    solids) and a random RHS on its fluid cells, from a seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator().manual_seed(seed)
    fluid = torch.rand((size, size), generator=g) < 0.3
    fluid[size // 6:size * 3 // 5, size // 12:size // 2] = True
    solid = torch.rand((size, size), generator=g) < 0.05
    fluid[[0, -1], :] = fluid[:, [0, -1]] = False
    fluid &= ~solid
    fluid, solid = fluid.cuda(), solid.cuda()
    b = torch.where(fluid, torch.randn((size, size), generator=g).cuda(), 0.0)
    return fluid, solid, b


@pytest.mark.parametrize("degree", [1, 2])
def test_coarse_cycle_rounds_as_per_operation_launches(degree):
    """One preconditioner application on a speckled 512² system, whose
    coarse cycle spans 128² (the cluster), 64² and 32² as at 1024²: one
    launch a visit equals one launch per level operation bit for bit, at
    Chebyshev degree 1 (the main path's) and 2."""
    fluid, solid, b = _speckled(512, 5)
    cfg = _solver(_cfg(512), mg_cheby_degree=degree)
    a = pressure_matrix_diag(cfg, solid, fluid)
    ws = k3.workspace(cfg, b.device)
    ws.load(a, fluid, b)
    ws.solve(warm=False)
    ws.load(a, fluid, b)
    fused, per_op = ws.cycle(per_op=False), ws.cycle(per_op=True)
    assert fused.abs().max() > 0
    assert torch.equal(fused, per_op)


def test_inactive_substep_is_free(developed):
    """dt_proj = inf makes the RHS exactly zero: 0 iterations, a zero
    residual, finite outputs (the hierarchy build and every chunk are
    skipped on the device)."""
    cfg, scn, st, dt = developed
    inf = torch.tensor(float("inf"), device="cuda")
    zero = torch.zeros((), device="cuda")
    u, v, it, res, msq, p = k2.project_substep_mg(
        cfg, zero, inf, st.u, st.v, st.fluid, st.prev_fluid, scn.solid, st.p)
    assert int(it) == 0 and float(res) == 0.0
    for x in (u, v, msq, p):
        assert torch.isfinite(x).all()


# --- S1: source emission --------------------------------------------------

def _source_inputs(case):
    from euler_tpu_torch import convert

    from source_states import source_case

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cfg, scn_np, st_np, active = source_case(case)
    scn = convert.scenario_from_numpy(scn_np, device="cuda")
    return cfg, scn, st_np, torch.tensor(active, device="cuda")


S1_FIELDS = ["markers", "alive", "marker_count", "r", "g", "b", "rng",
             "alive_count", "source_exhausted"]


@pytest.mark.parametrize("case", ["active", "inactive", "exhaustion",
                                  "exhausted", "per_cell", "K", "padded"])
def test_source_pass_bitwise(case):
    """S1 against its plain version on the card, from the same seeded
    state: every field it writes bitwise (the RNG as int64)."""
    from euler_tpu_torch import convert
    from euler_tpu_torch.ops.cuda import source_kernel as s1

    cfg, scn, st_np, active = _source_inputs(case)
    got = convert.state_from_numpy(st_np, device="cuda")
    want = convert.state_from_numpy(st_np, device="cuda")
    _build.LAUNCHES.clear()
    s1.emit_sources(cfg, scn, got, active)
    assert _build.LAUNCHES["S1"] == 1
    tms.source_pass_slots(cfg, scn, want, active)
    for name in S1_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        if name == "rng":
            a, b = a.to(torch.int64), b.to(torch.int64)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    if case == "inactive":
        before = convert.state_from_numpy(st_np, device="cuda")
        for name in ("markers", "alive", "marker_count", "alive_count"):
            assert torch.equal(getattr(got, name), getattr(before, name))
        assert torch.equal(got.rng.to(torch.int64),
                           before.rng.to(torch.int64))


def test_source_frames_match_cpu_plain():
    """Waterfall in the CLI's 40 x 100 config, 2 frames on the card
    (K1, S1, K7, K8) against the CPU's plain versions: counts, alive,
    RNG, drops and colours bitwise, u and v within 5e-3."""
    from euler_tpu_torch import cli
    from euler_tpu_torch.core.scenario import load_scenario

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cfg = cli.build_config(cli.parse_args(["scenarios/waterfall.txt"]))
    scn_g, st_g = load_scenario("scenarios/waterfall.txt", cfg,
                                device="cuda")
    scn_c, st_c = load_scenario("scenarios/waterfall.txt", cfg, device="cpu")
    _build.LAUNCHES.clear()
    _build.PLAIN_CALLS.clear()
    for _ in range(2):
        st_g = sim.step_frame(cfg, scn_g, st_g)
    assert sum(_build.PLAIN_CALLS.values()) == 0
    assert {k for k, v in _build.LAUNCHES.items() if v} == {
        "K1", "S1", "K7", "K8"}
    for _ in range(2):
        st_c = sim.step_frame(cfg, scn_c, st_c)
    for name in ("marker_count", "alive", "alive_count", "dropped_markers",
                 "source_exhausted", "r", "g", "b"):
        assert torch.equal(getattr(st_g, name).cpu(), getattr(st_c, name))
    assert torch.equal(st_g.rng.cpu().to(torch.int64),
                       st_c.rng.to(torch.int64))
    assert (st_g.u.cpu() - st_c.u).abs().max() <= 5e-3
    assert (st_g.v.cpu() - st_c.v).abs().max() <= 5e-3
