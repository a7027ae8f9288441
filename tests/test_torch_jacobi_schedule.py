"""The schedule of the CUDA Jacobi-PCG solve (K8, K9, K10:
`euler_tpu_torch/csrc/jacobi_pcg.cu`) and its workspace cache, checked on
the CPU as plain Python.  Imports no JAX and compiles nothing.

  * A torch model of the schedule (two sweeps an iteration: the deferred
    p += alpha s, s in two planes swapped each iteration and recomputed
    at the four neighbours, iteration 1's s = invd r chosen by the
    iteration count, the cap and the stop flag on the "device", chunks of
    8 replayed up to the cap with the flag read only between batches of
    13, then the finishing update) equals the plain `pcg_loop` bit for
    bit in p, iterations and residual, on small systems with solids.  The
    model
    sums as `pcg_loop` does (torch's `sum`); the kernels' chain-order
    reductions are checked on the card (tests/test_torch_cuda.py,
    `chip_smoke.py`).  The model is a copy of the kernels' design, not
    tied to their code: change it together with `sweep_a`, `sweep_b`,
    `finish` and `JacobiSolver::iterate` (csrc/jacobi_pcg.cu,
    chain_reduce.cuh).
  * The workspace cache (`pcg_kernel.workspace`): its key, its bound by
    count and by bytes, and the buffers and arguments each library entry
    point receives (a recording stand-in for the library).
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from euler_tpu_torch.config import SimConfig, SolverConfig
from euler_tpu_torch.core.state import (
    shift_down,
    shift_left,
    shift_right,
    shift_up,
)
from euler_tpu_torch.ops.cuda import grid_kernel as tk7
from euler_tpu_torch.ops.cuda import pcg_kernel as tpk
from euler_tpu_torch.ops.cuda import substep_kernel as tsk
from euler_tpu_torch.ops.project import pressure_matrix_diag

MiB = 2 ** 20
CHUNK = 8  # iterations per replayed graph (csrc/jacobi_pcg.cu kChunk)
BATCH = 13  # replays between two reads of the stop flag (kBatch)


def _cfg(ny=24, nx=20, **solver):
    """`bench.py --precon jacobi` at (ny, nx): 100 iterations, tol 1e-6,
    tol_rel 1e-6."""
    base = dict(max_iterations=100, tol=1e-6, tol_rel=1e-6,
                preconditioner="jacobi", dtype="float32",
                fuse_projection=True)
    return SimConfig(nx=nx, ny=ny, marker_layout="slots",
                     solver=SolverConfig(**{**base, **solver}))


def _system(seed, ny=24, nx=20):
    """A random RHS on the fluid cells of a box with solid walls, a solid
    block inside and some air cells."""
    rng = np.random.default_rng(seed)
    solid = np.zeros((ny, nx), bool)
    solid[0], solid[-1], solid[:, 0], solid[:, -1] = True, True, True, True
    solid[8:12, 6:9] = True
    fluid = ~solid & (rng.random((ny, nx)) < 0.85)
    b = np.where(fluid, rng.standard_normal((ny, nx)), 0.0)
    cfg = _cfg(ny, nx)
    fluid_t, solid_t = torch.from_numpy(fluid), torch.from_numpy(solid)
    return (torch.from_numpy(b.astype(np.float32)),
            pressure_matrix_diag(cfg, solid_t, fluid_t), fluid_t)


def _decode(code):
    """common.cuh `decode` of the operator code a_diag * fl + 8 * fl."""
    c = code.to(torch.float32)
    fl = (c >= 8.0).to(torch.float32)
    a = c - 8.0 * fl
    return fl, a, fl / torch.clamp_min(a, 1.0)


def _at(plane, dy, dx):
    """plane[y + dy, x + dx], and whether that cell is inside the grid."""
    shift = {(0, -1): shift_left, (0, 1): shift_right,
             (-1, 0): shift_down, (1, 0): shift_up}[(dy, dx)]
    inside = shift(torch.ones_like(plane, dtype=torch.bool), False)
    return shift(plane), inside


def schedule_model(cfg, b, a_diag, fluid):
    """csrc/jacobi_pcg.cu's solve written out plane by plane: the head,
    ceil(cap / 8) chunks of 8 iterations (sweep A, sweep B), each a no-op
    once the stop flag is set, the host reading the flag before each
    batch of 13 chunks but the first, then the finishing launch.  Returns
    (p, iterations, residual)."""
    s = cfg.solver
    cap = s.max_iterations
    code = torch.where(fluid, a_diag + 8, torch.zeros_like(a_diag))
    fl, a, invd = _decode(code)
    # the head: code, r = b, p = 0, init_solve
    dev = {"r": b.clone(), "p": torch.zeros_like(b),
           "s": [torch.full_like(b, float("nan")) for _ in range(2)],
           "As": torch.full_like(b, float("nan"))}
    rmax0 = b.abs().max()
    sc = {"tol": torch.maximum(torch.tensor(s.tol), s.tol_rel * rmax0),
          "sigma": ((invd * b) * b).sum(), "beta": torch.tensor(0.0),
          "alpha": torch.tensor(float("nan")), "resid": rmax0}
    fg = {"done": not bool(rmax0 != 0) or cap <= 0, "iters": 0,
          "pending": False}

    def sweep_a(s_old, s_new):
        if fg["done"]:
            return
        first = fg["iters"] == 0
        if fg["pending"]:
            dev["p"] = dev["p"] + sc["alpha"] * s_old

        def s_k(inv, r, so):  # the plain loop's update_s
            z = inv * r
            return z if first else z + sc["beta"] * so

        sk = s_k(invd, dev["r"], s_old)

        def s_nb(dy, dx):  # recomputed at the neighbour, 0 outside
            parts = [_at(t, dy, dx) for t in (invd, dev["r"], s_old)]
            inside = parts[0][1]
            return torch.where(inside, s_k(*(p for p, _ in parts)), 0.0)

        nb = s_nb(0, -1) + s_nb(0, 1)
        nb = nb + s_nb(-1, 0)
        nb = nb + s_nb(1, 0)
        As = fl * (a * sk - nb)
        s_new.copy_(sk)
        dev["As"] = As
        zs = (As * sk).sum()
        sc["alpha"] = sc["sigma"] / torch.where(zs != 0, zs, 1.0)
        fg["pending"] = True

    def sweep_b():
        if fg["done"]:
            return
        r = dev["r"] - sc["alpha"] * dev["As"]
        dev["r"] = r
        rmax = r.abs().max()
        sigma_new = ((invd * r) * r).sum()
        sigma = sc["sigma"]
        sc["beta"] = sigma_new / torch.where(sigma != 0, sigma, 1.0)
        sc["sigma"], sc["resid"] = sigma_new, rmax
        fg["iters"] += 1
        fg["done"] = not bool(rmax > sc["tol"]) or fg["iters"] >= cap

    for k in range(-(-cap // CHUNK)):
        if k and k % BATCH == 0 and fg["done"]:
            break
        for j in range(CHUNK):
            sweep_a(dev["s"][j & 1], dev["s"][(j + 1) & 1])
            sweep_b()
    p = dev["p"]
    if fg["pending"]:
        p = p + sc["alpha"] * dev["s"][fg["iters"] & 1]
    return p, fg["iters"], sc["resid"]


def _same_bits(x, y):
    """Equal bits where finite or inf, NaN where NaN."""
    nan = torch.isnan(x)
    return (torch.equal(nan, torch.isnan(y))
            and torch.equal(x[~nan].view(torch.int32),
                            y[~nan].view(torch.int32)))


CASES = {
    "converged": dict(tol_rel=1e-3),
    "converged_cap1000": dict(max_iterations=1000, tol_rel=1e-3),
    "cap1": dict(max_iterations=1, tol=0.0, tol_rel=0.0),
    "cap7": dict(max_iterations=7, tol=0.0, tol_rel=0.0),
    "cap8": dict(max_iterations=8, tol=0.0, tol_rel=0.0),
    "cap9": dict(max_iterations=9, tol=0.0, tol_rel=0.0),
    "inf": {},
    "nan": {},
    "zero": {},
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_schedule_matches_pcg_loop_bitwise(case, seed):
    """The model of the two-sweep schedule equals `pcg_loop` (the plain
    K8) bit for bit: converged before the budget (of 100 and of 1000),
    at caps inside the first chunk, at its end and one past it, with an inf or a NaN in b on a
    fluid cell (one iteration, then the NaN-robust stop; the pending p
    update is guarded by a flag, not by alpha = 0), and on b = 0 (no
    iteration, residual 0, p = 0)."""
    b, a_diag, fluid = _system(seed)
    cfg = _cfg(**CASES[case])
    if case in ("inf", "nan"):
        b.view(-1)[int(fluid.view(-1).nonzero()[seed])] = float(case)
    if case == "zero":
        b = torch.zeros_like(b)
    p, iters, resid = schedule_model(cfg, b, a_diag, fluid)
    pp, itp, resp = tpk.solve_pressure_jacobi_plain(cfg, b, a_diag, fluid)
    assert iters == int(itp)
    assert _same_bits(p, pp)
    assert _same_bits(resid.reshape(1), resp.reshape(1))
    want = {"converged": None, "converged_cap1000": None, "inf": 1,
            "nan": 1, "zero": 0}.get(
        case, cfg.solver.max_iterations)
    if want is None:
        assert 0 < iters < cfg.solver.max_iterations
    else:
        assert iters == want
    if case == "zero":
        assert float(resid) == 0.0 and not bool(p.any())


def test_workspace_key():
    """One workspace per device and grid, whatever the stopping rule:
    the cap, tol and tol_rel live on the device."""
    key = tpk.workspace_key(_cfg(), "cuda:0")
    assert key == ("cuda:0", 24, 20)
    for over in (dict(max_iterations=7), dict(tol=0.0, tol_rel=0.5)):
        assert tpk.workspace_key(_cfg(**over), "cuda:0") == key
    assert tpk.workspace_key(_cfg(20, 24), "cuda:0") != key
    assert tpk.workspace_key(_cfg(), "cuda:1") != key


class _FakeWorkspace:
    """A workspace of a given size that records its closing."""

    sizes: dict = {}
    closed: list = []

    def __init__(self, Y, X, device):
        self.key = Y
        self.nbytes = self.sizes[Y]

    def close(self):
        self.closed.append(self.key)


@pytest.fixture
def fake_cache(monkeypatch):
    monkeypatch.setattr(tpk, "JacobiWorkspace", _FakeWorkspace)
    monkeypatch.setattr(tpk, "_WORKSPACES", type(tpk._WORKSPACES)())
    monkeypatch.setattr(_FakeWorkspace, "closed", [])
    monkeypatch.setattr(_FakeWorkspace, "sizes", {
        Y: 21 * Y * Y for Y in (256, 1024, 2123, 2124, 2125, 4096)})
    yield
    tpk.clear_workspaces()


def _keys():
    return [ws.key for ws in tpk._WORKSPACES.values()]


def test_cache_two_grids_in_turn(fake_cache):
    """Two grids in turn each keep their own workspace."""
    small = tpk.workspace(_cfg(256, 256), "cuda:0")
    big = tpk.workspace(_cfg(1024, 1024), "cuda:0")
    for _ in range(2):
        assert tpk.workspace(_cfg(256, 256), "cuda:0") is small
        assert tpk.workspace(_cfg(1024, 1024), "cuda:0") is big
    assert _keys() == [256, 1024] and _FakeWorkspace.closed == []


def test_cache_bounded_by_bytes(fake_cache):
    """Two workspaces of K8's largest grids (~95 MB each) fit the byte
    bound; a third evicts the least recently used, closed."""
    tpk.workspace(_cfg(2125, 2125), "cuda:0")
    tpk.workspace(_cfg(2124, 2124), "cuda:0")
    assert _keys() == [2125, 2124]
    tpk.workspace(_cfg(2125, 2125), "cuda:0")
    tpk.workspace(_cfg(2123, 2123), "cuda:0")
    assert _keys() == [2125, 2123]
    assert _FakeWorkspace.closed == [2124]
    assert tpk.cached_bytes() <= tpk._MAX_WORKSPACE_BYTES


def test_cache_keeps_the_newest_over_the_byte_bound(fake_cache):
    """A workspace larger than the byte bound is still cached, alone."""
    tpk.workspace(_cfg(1024, 1024), "cuda:0")
    ws = tpk.workspace(_cfg(4096, 4096), "cuda:0")
    assert ws.nbytes > tpk._MAX_WORKSPACE_BYTES
    assert _keys() == [4096]
    assert tpk.workspace(_cfg(4096, 4096), "cuda:0") is ws


def test_cache_bound_by_count(fake_cache, monkeypatch):
    """Small workspaces are still bounded by _MAX_WORKSPACES."""
    sizes = {16 * (k + 1): MiB for k in range(tpk._MAX_WORKSPACES + 1)}
    monkeypatch.setattr(_FakeWorkspace, "sizes", sizes)
    for Y in sizes:
        tpk.workspace(_cfg(Y, Y), "cuda:0")
    assert len(tpk._WORKSPACES) == tpk._MAX_WORKSPACES
    assert _FakeWorkspace.closed == [16]


class _FakeFn:
    """A bound library function: checks the call against its argtypes and
    records it; a create hands back a handle."""

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def __call__(self, *args):
        assert len(args) == len(self.argtypes), self.name
        self.calls.append((self.name, args))
        if self.name.endswith("_create"):
            args[-1]._obj.value = 1234
        return 0


class _FakeLib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, fname):
        fn = _FakeFn(fname, self.calls)
        setattr(self, fname, fn)
        return fn


STREAM = 77


class _OnCard:
    """Stands in for a CUDA tensor: the wrappers read its device and hand
    its data pointer to the library."""

    def __init__(self, t):
        self.t = t
        self.device = torch.device("cuda", 0)

    def data_ptr(self):
        return self.t.data_ptr()


@pytest.fixture
def fake_lib(monkeypatch):
    """CPU buffers and a recording library in place of the CUDA one;
    workspaces made on the CPU whatever device they are asked for."""
    lib = _FakeLib()
    real = tpk.JacobiWorkspace
    monkeypatch.setattr(tpk._build, "load", lambda name, flags=(): lib)
    monkeypatch.setattr(tpk._build, "stream", lambda: STREAM)
    monkeypatch.setattr(tpk._build, "require",
                        lambda t, *a, **k: t.data_ptr())
    monkeypatch.setattr(tpk.torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(tpk, "JacobiWorkspace",
                        lambda Y, X, device: real(Y, X, "cpu"))
    monkeypatch.setattr(tpk, "_WORKSPACES", type(tpk._WORKSPACES)())
    yield lib
    tpk.clear_workspaces()


def _calls(lib, name):
    return [args for n, args in lib.calls if n == name]


def test_workspace_layout(fake_lib):
    """The buffers a workspace hands eu_jacobi_create, in its order: the
    u8 code, r, p, As, the two s planes, 2 x 1024 chain values, the
    scalars, the flags (done, iterations, pending, ticket, cap) and the
    tail's partials; 21 bytes a cell; close frees the handle."""
    Y, X = 24, 20
    ws = tpk.workspace(_cfg(Y, X), "cuda:0")
    (args,) = _calls(fake_lib, "eu_jacobi_create")
    assert args[:2] == (Y, X)
    assert list(args[2:11]) == [t.data_ptr() for t in ws.buffers()]
    assert ws.code.dtype == torch.uint8 and ws.code.shape == (Y, X)
    assert ws.s.shape == (2, Y, X) and ws.chains.numel() == 2 * 1024
    assert ws.flags.numel() == 5 and ws.scal.numel() == 5
    assert ws.part.numel() == 2 * (-(-Y * X // 256))
    assert ws.handle == 1234
    n_ws = 21 * Y * X + 4 * (2 * 1024 + 5 + 5 + ws.part.numel())
    assert ws.nbytes == n_ws
    tpk.clear_workspaces()
    assert fake_lib.calls[-1] == ("eu_jacobi_destroy", (1234,))


def test_real_sizes(fake_lib):
    """The workspaces of the Jacobi routes at 1024² (~22 MB) and at K8's
    largest grid (2125², ~95 MB) fit the byte bound together."""
    tpk.workspace(_cfg(1024, 1024), "cuda:0")
    tpk.workspace(_cfg(2125, 2125), "cuda:0")
    sizes = [ws.nbytes for ws in tpk._WORKSPACES.values()]
    assert 21 * MiB < sizes[0] < 23 * MiB
    assert 90 * MiB < sizes[1] < 96 * MiB
    assert tpk.cached_bytes() <= tpk._MAX_WORKSPACE_BYTES


def _plane(seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((24, 20), generator=g).to(dtype)


def test_solve_entry_point(fake_lib):
    """K8: one workspace for two solves (created once), the stopping rule
    passed per call, the caller's tensors in, p written into a fresh plane
    that aliases nothing of the workspace."""
    cfg = _cfg(max_iterations=37, tol=1e-5, tol_rel=2e-6)
    b, a, fl = _plane(0), _plane(1, torch.int32), _plane(2, torch.bool)
    outs = [tpk.solve_pressure_jacobi(cfg, _OnCard(b), _OnCard(a),
                                      _OnCard(fl)) for _ in range(2)]
    assert len(_calls(fake_lib, "eu_jacobi_create")) == 1
    ws = tpk.workspace(cfg, torch.device("cuda", 0))
    held = {t.data_ptr() for t in ws.buffers()}
    solves = _calls(fake_lib, "eu_jacobi_solve")
    for (p, _, _), args in zip(outs, solves):
        assert args[:4] == (ws.handle, 37, 1e-5, 2e-6)
        assert args[4:7] == (a.data_ptr(), fl.data_ptr(), b.data_ptr())
        assert args[7:] == (p.data_ptr(), STREAM)
        assert p.shape == (24, 20) and p.data_ptr() not in held
    assert outs[0][0].data_ptr() != outs[1][0].data_ptr()
    assert tpk._build.LAUNCHES["K8"] >= 2


@pytest.mark.parametrize("kernel", ["K9", "K10"])
def test_project_entry_points(fake_lib, kernel):
    """K9 and K10 on the same cached workspace as K8: the physical
    constants and the stopping rule per call, the caller's masks and
    planes in (K9: dt for both the RHS and the face update), fresh u2,
    v2 and msq out."""
    cfg = dataclasses.replace(_cfg(max_iterations=12), side_length=0.5,
                              density=2.0)
    h = cfg.side_length
    fl, pfl, so = (_plane(k, torch.bool) for k in range(3))
    u, v = _plane(3), _plane(4)
    dt, dtp = torch.tensor(0.01), torch.tensor(0.02)
    args = [_OnCard(t) for t in (fl, pfl, so, dt, dtp, u, v)]
    if kernel == "K9":
        out = tpk.project_jacobi(cfg, args[3], args[5], args[6], args[0],
                                 args[2])
        (call,) = _calls(fake_lib, "eu_jacobi_project")
        consts = (1.0 / h, h * h * cfg.density, -1.0 / (cfg.density * h))
        ins = (fl, so, dt, dt, u, v)
    else:
        out = tsk.project_substep_jacobi(cfg, *args[3:5], *args[5:7],
                                         *args[:3])
        (call,) = _calls(fake_lib, "eu_jacobi_substep")
        consts = (1.0 / h, cfg.gravity, h * h * cfg.density,
                  -1.0 / (cfg.density * h))
        ins = (fl, pfl, so, dt, dtp, u, v)
    ws = tpk.workspace(cfg, torch.device("cuda", 0))
    k = 4 + len(consts)
    assert call[:4] == (ws.handle, 12, cfg.solver.tol, cfg.solver.tol_rel)
    assert call[4:k] == pytest.approx(consts, rel=1e-7)
    assert call[k:k + len(ins)] == tuple(t.data_ptr() for t in ins)
    u2, v2, _, _, msq = out
    tail = (u2.data_ptr(), v2.data_ptr(), msq.data_ptr())
    if kernel == "K10":  # its grid stage's tiles (K7's)
        plan = tk7.grid_tile_plan(cfg.ny, cfg.nx)
        tail += (plan.tile_y, plan.tile_x, plan.threads)
    assert call[k + len(ins):] == tail + (STREAM,)
    held = {t.data_ptr() for t in ws.buffers()}
    assert held.isdisjoint(t.data_ptr() for t in (u2, v2, msq))
    assert len(_calls(fake_lib, "eu_jacobi_create")) == 1
