"""The MG workspace cache that K3 and K11 share, checked on the CPU as
plain Python: its key, its bound by count and by bytes, and the buffers
and arguments a workspace hands the CUDA library (a recording stand-in
for the library, so nothing is compiled or launched)."""

import contextlib

import pytest
import torch

from euler_tpu_torch.config import SimConfig, SolverConfig
from euler_tpu_torch.ops.cuda import mg_kernel as tmgk
from euler_tpu_torch.ops.cuda import mg_stream_kernel as tms

MiB = 2 ** 20


def _cfg(size: int) -> SimConfig:
    """`bench.py`'s main path at `size` (Galerkin MG-PCG, tol_rel 1e-4)."""
    return SimConfig(
        nx=size, ny=size, marker_layout="slots",
        solver=SolverConfig(max_iterations=100, dtype="float32",
                            tol_rel=1e-4, preconditioner="mg",
                            warm_start=True, fuse_projection=True))


@pytest.mark.parametrize("ls_a,ls_b", [(0, 1), (0, 2), (1, 2)])
def test_workspace_key_separates_roots(ls_a, ls_b):
    """At one grid and config, K3's workspace (root level 0), K11's with
    F = 2 (root level 1) and K11's with F = 4 (root level 2) are three
    keys; the same root gives the same key."""
    cfg = _cfg(256)
    assert (tmgk.workspace_key(cfg, "cuda:0", ls_a)
            != tmgk.workspace_key(cfg, "cuda:0", ls_b))
    assert (tmgk.workspace_key(cfg, "cuda:0", ls_b)
            == tmgk.workspace_key(_cfg(256), "cuda:0", ls_b))


def test_k3_key_is_root_level_zero():
    cfg = _cfg(128)
    assert tmgk.workspace_key(cfg, "cuda:0") == tmgk.workspace_key(
        cfg, "cuda:0", 0)


class _FakeWorkspace:
    """A workspace of a given size that records its closing."""

    sizes: dict = {}
    closed: list = []

    def __init__(self, cfg, device, ls=0):
        self.key = (cfg.ny, ls)
        self.nbytes = self.sizes[self.key]

    def close(self):
        self.closed.append(self.key)


@pytest.fixture
def fake_cache(monkeypatch):
    monkeypatch.setattr(tmgk, "MgWorkspace", _FakeWorkspace)
    monkeypatch.setattr(tmgk, "_WORKSPACES", type(tmgk._WORKSPACES)())
    monkeypatch.setattr(_FakeWorkspace, "closed", [])
    # the sizes of the workspaces the routes use (see test_real_sizes)
    monkeypatch.setattr(_FakeWorkspace, "sizes", {
        (1024, 0): 60 * MiB, (2048, 1): 146 * MiB, (4096, 2): 486 * MiB,
        (8192, 3): 1944 * MiB})
    yield
    tmgk.clear_workspaces()


def _keys():
    return [ws.key for ws in tmgk._WORKSPACES.values()]


def test_cache_bounded_by_bytes(fake_cache):
    """K3 at 1024² and K11 at 2048² share the cache; K11's 4096² workspace
    evicts both (least recently used first, each closed); a 1024² solve
    after it evicts the 4096² one."""
    tmgk.workspace(_cfg(1024), "cuda:0")
    tmgk.workspace(_cfg(2048), "cuda:0", 1)
    assert _keys() == [(1024, 0), (2048, 1)]
    assert tmgk.cached_bytes() <= tmgk._MAX_WORKSPACE_BYTES
    big = tmgk.workspace(_cfg(4096), "cuda:0", 2)
    assert _keys() == [(4096, 2)]
    assert _FakeWorkspace.closed == [(1024, 0), (2048, 1)]
    assert tmgk.workspace(_cfg(4096), "cuda:0", 2) is big
    tmgk.workspace(_cfg(1024), "cuda:0")
    assert _keys() == [(1024, 0)]
    assert _FakeWorkspace.closed[-1] == (4096, 2)


def test_cache_keeps_the_newest_over_the_byte_bound(fake_cache):
    """A workspace larger than the byte bound is still cached, alone."""
    tmgk.workspace(_cfg(1024), "cuda:0")
    ws = tmgk.workspace(_cfg(8192), "cuda:0", 3)
    assert ws.nbytes > tmgk._MAX_WORKSPACE_BYTES
    assert _keys() == [(8192, 3)]
    assert tmgk.workspace(_cfg(8192), "cuda:0", 3) is ws


def test_cache_bound_by_count_with_small_entries(fake_cache, monkeypatch):
    """Small workspaces are still bounded by _MAX_WORKSPACES."""
    sizes = {(64 * (k + 1), 0): MiB for k in range(tmgk._MAX_WORKSPACES + 1)}
    monkeypatch.setattr(_FakeWorkspace, "sizes", sizes)
    for Y, _ in sizes:
        tmgk.workspace(_cfg(Y), "cuda:0")
    assert len(tmgk._WORKSPACES) == tmgk._MAX_WORKSPACES
    assert _FakeWorkspace.closed == [(64, 0)]


class _FakeFn:
    """A bound library function: checks the call against its argtypes and
    records it; a create hands back a handle."""

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def __call__(self, *args):
        assert len(args) == len(self.argtypes), self.name
        self.calls.append((self.name, args))
        if self.name.endswith("_create"):
            args[-1]._obj.value = 1
        return 0


class _FakeLib:
    def __init__(self, name):
        self.name, self.calls = name, []

    def __getattr__(self, fname):
        fn = _FakeFn(fname, self.calls)
        setattr(self, fname, fn)
        return fn


@pytest.fixture
def fake_libs(monkeypatch):
    """CPU buffers and a recording library in place of the CUDA one."""
    libs = {}

    def load(name, flags=()):
        return libs.setdefault(name, _FakeLib(name))

    monkeypatch.setattr(tmgk._build, "load", load)
    monkeypatch.setattr(tmgk.torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    return libs


def _create_args(libs, lib):
    (name, args), = [c for c in libs[lib].calls if c[0].endswith("_create")]
    return name, args


@pytest.mark.parametrize("ls", [0, 1, 2])
def test_workspace_layout(fake_libs, ls):
    """The buffers a workspace hands its library: K3 (root 0) to
    eu_mg_create, K11 (root ls) to eu_mg_stream_create, with
    every level's shape, the coarse levels' c, e, n planes, no cycle
    planes above the root, one Chebyshev row more for K11's fine level,
    and a z plane in place of K2's scratch."""
    cfg = _cfg(256)
    ws = tmgk.MgWorkspace(cfg, "cpu", ls)
    shapes = tmgk._level_shapes(256, 256, cfg.solver.mg_min_size)
    L = len(shapes)
    lib = "mg_pcg" if ls == 0 else "mg_stream"
    name, args = _create_args(fake_libs, lib)
    assert name == ("eu_mg_create" if ls == 0 else "eu_mg_stream_create")
    assert args[0] == L
    assert list(args[1]) == [v for sh in shapes for v in sh]
    planes = list(args[2] if ls == 0 else args[3])
    if ls:
        assert args[2] == ls
    assert len(planes) == tmgk._PLANES_PER_LEVEL * L
    for l in range(L):
        pl = planes[l * 9:(l + 1) * 9]
        if l == 0:
            assert pl[:3] == [None] * 3
        else:
            c, e, n, _ = ws.levels[l - 1]
            assert pl[:3] == [c.data_ptr(), e.data_ptr(), n.data_ptr()]
        cycle = pl[3:]
        if l < ls:
            assert cycle == [None] * 6
        elif l == 0:
            assert cycle[1] is None and None not in cycle[:1] + cycle[2:]
        else:
            assert None not in cycle
    assert tuple(ws.rows.shape) == (L + (ls > 0), 1 + 2 * max(
        cfg.solver.mg_cheby_degree, cfg.solver.mg_coarse_iters))
    assert hasattr(ws, "z") == (ls > 0)
    assert hasattr(ws, "tail_part") == (ls == 0)
    assert not hasattr(ws, "zu") and not hasattr(ws, "zv")
    assert ws.nbytes == sum(t.numel() * t.element_size() for t in ws.keep)
    ws.close()
    assert fake_libs[lib].calls[-1][0] == "eu_mg_destroy"


def test_stream_solve_uses_the_cached_root(monkeypatch):
    """K11's wrapper solves on the workspace of its root level, whose key
    differs from K3's at the same grid, and copies p out."""
    monkeypatch.setattr(tmgk, "_WORKSPACES", type(tmgk._WORKSPACES)())
    monkeypatch.setattr(tmgk, "MgWorkspace",
                        lambda cfg, device, ls=0: _StreamWs(ls))
    monkeypatch.setattr(tms._build, "require", lambda *a, **k: 0)

    class CudaPlane:  # stands in for a CUDA tensor; the wrapper reads .device
        device = torch.device("cuda", 0)

    cfg = _cfg(256)
    p, _, _ = tms.solve_pressure_mg_stream(cfg, CudaPlane(), None, None)
    (key, ws), = tmgk._WORKSPACES.items()
    assert ws.ls == tms._root(cfg)[1] == 1 and ws.solved == 1
    assert key == tmgk.workspace_key(cfg, CudaPlane.device, 1)
    assert key != tmgk.workspace_key(cfg, CudaPlane.device)
    assert p is not ws.p and torch.equal(p, ws.p)


class _StreamWs:
    nbytes = 0

    def __init__(self, ls):
        self.ls, self.solved = ls, 0
        self.p = torch.zeros(1)

    def stream_solve(self, a_diag, fluid, b):
        self.solved += 1
        return torch.zeros((), dtype=torch.int32), torch.zeros(())

    def close(self):
        pass


def test_real_sizes(fake_libs, monkeypatch):
    """The workspaces the routes build, at their real sizes (CPU buffers,
    never touched): K3 at 1024² and K11 at 2048² fit the byte bound
    together, K11's at 4096² alone, and the cache keeps it alone."""
    monkeypatch.setattr(tmgk, "_WORKSPACES", type(tmgk._WORKSPACES)())
    k3 = tmgk.workspace(_cfg(1024), "cpu")
    k11 = tmgk.workspace(_cfg(2048), "cpu", 1)
    assert list(tmgk._WORKSPACES.values()) == [k3, k11]
    assert 50 * MiB < k3.nbytes < 80 * MiB
    assert 120 * MiB < k11.nbytes < 200 * MiB
    assert tmgk.cached_bytes() <= tmgk._MAX_WORKSPACE_BYTES
    big = tmgk.workspace(_cfg(4096), "cpu", 2)
    assert list(tmgk._WORKSPACES.values()) == [big]
    assert 400 * MiB < big.nbytes <= tmgk._MAX_WORKSPACE_BYTES
    tmgk.clear_workspaces()
