"""The tiled launch of the marker kernels K1 / K4, K5 and K6, checked on
the CPU as plain Python (imports nothing of JAX; runs in seconds):

  * `tile_plan` covers every cell of ragged grids exactly once, stays
    within the shared memory a block may use on an H100 for K = 1..16
    (K5's and K6's layouts too; K6 keeps K1's tile), and raises for a K
    it cannot hold;
  * torch models of the kernels (csrc/marker_pass.cu `tile_pass`), each
    tile computed from its own window alone:
    - K1 (`march_rebin_tiles`): the plainly marched store cut into the
      plan's tiles, each with its one-cell halo, and re-binned tile by
      tile, each destination walking its sources in OFFSETS_OWN_FIRST
      order and their live slots in k order;
    - K6 (`rebin_tiles`): the same gather with validity from the alive
      plane's window, which may have holes (not front-compacted);
    - K5 (`march_tiles`): each tile's live markers compacted in (cell,
      slot) order by the block prefix of its counts, slot k of a cell
      taken from there for k < count and copied through otherwise.
    Each equals its plain version (`march_rebin_plain`,
    `rebin_markers_plain`, `advect_markers_plain`) bit for bit, every
    slot of the store included, on seeded states (tests/marker_states.py)
    with dead cells, cells driven over K, and markers that cross tile
    corners diagonally.
"""

import pytest
import torch

from euler_tpu_torch.ops.cuda import marker_fused_kernel as k1
from euler_tpu_torch.ops.cuda import marker_kernel as k5
from euler_tpu_torch.ops.cuda import rebin_kernel as k6
from euler_tpu_torch.ops.markers_slots import (
    OFFSETS_OWN_FIRST,
    live_slots,
    march_slots,
)

from marker_states import marker_state, rebin_state

SHAPES = [(1000, 1000), (37, 130), (8, 1)]


@pytest.mark.parametrize("K", [4, 8, 16])
@pytest.mark.parametrize("Y,X", SHAPES)
def test_tile_plan_covers_every_cell_once(Y, X, K):
    plan = k1.tile_plan(Y, X, K)
    assert (plan.tiles_y - 1) * plan.tile_y < Y <= plan.tiles_y * plan.tile_y
    assert (plan.tiles_x - 1) * plan.tile_x < X <= plan.tiles_x * plan.tile_x
    cover = torch.zeros((Y, X), dtype=torch.int32)
    for by in range(plan.tiles_y):
        for bx in range(plan.tiles_x):
            cover[by * plan.tile_y:(by + 1) * plan.tile_y,
                  bx * plan.tile_x:(bx + 1) * plan.tile_x] += 1
    assert bool((cover == 1).all())


@pytest.mark.parametrize("K", range(1, 17))
def test_tile_plan_fits_shared_memory(K):
    """The plan's bytes are the layout's, within 227 KB, and every halo
    marker has a 16-bit index; for K <= 16 two CTAs fit an SM (228 KB, 1
    KB kept for each), with tiles of 32 x 32 cells up to K = 8."""
    plan = k1.tile_plan(1024, 1024, K)
    h = (plan.tile_y + 2) * (plan.tile_x + 2)
    assert plan.smem_bytes == k1.tile_smem_bytes(plan.tile_y, plan.tile_x,
                                                 K)
    assert plan.smem_bytes >= 9 * h * K
    assert plan.smem_bytes <= 227 * 1024
    assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024
    assert h * K <= 2 ** 16
    assert plan.tile_x == 32 and plan.tile_y == (32 if K <= 8 else 16)
    assert plan.threads % 32 == 0 and plan.threads <= 512


@pytest.mark.parametrize("K", range(1, 17))
def test_tile_plans_of_k5_k6(K):
    """K5's and K6's plans: the bytes of their own layouts (K6's is K1's
    and a mask a halo cell, K5's has no halo, codes or picks), within 227
    KB, the tiling of UNFUSED_TILES that keeps the most threads resident
    on an SM (the first on a tie), and at least as many as K1's two CTAs
    of 512: tiles of 8 x 32 cells and 256 threads up to K = 8."""
    for kernel in ("K5", "K6"):
        plan = k1.tile_plan(1024, 1024, K, kernel)
        assert plan.smem_bytes == k1.tile_smem_bytes(
            plan.tile_y, plan.tile_x, K, kernel)
        assert plan.smem_bytes <= 227 * 1024
        assert plan.tile_x == 32 and plan.threads % 32 == 0
        resident = [k1.resident_ctas(ty, n, K, kernel) * n
                    for ty, n in k1.UNFUSED_TILES]
        chosen = k1.UNFUSED_TILES.index((plan.tile_y, plan.threads))
        assert resident[chosen] == max(resident) >= 2 * 512
        assert resident.index(max(resident)) == chosen
        if K <= 8:
            assert (plan.tile_y, plan.threads) == (8, 256)
    h = (8 + 2) * (32 + 2)
    assert k1.tile_smem_bytes(8, 32, K, "K6") == k1.tile_smem_bytes(
        8, 32, K) + 8 * h
    assert k1.tile_smem_bytes(8, 32, K, "K5") == (
        8 * 256 * K + 4 * (256 + 1) + 4 * 32)


def test_tile_plan_raises_for_a_k_it_cannot_hold():
    assert k1.tile_plan(64, 64, 64).tile_y == 8
    with pytest.raises(ValueError, match="shared memory"):
        k1.tile_plan(64, 64, 100)


def _windows(a, plan, fill=0):
    """[..., Y, X] -> [..., tiles_y, tiles_x, tile_y + 2, tile_x + 2]: each
    tile with its one-cell halo (`fill` beyond the grid)."""
    Y, X = a.shape[-2:]
    ty, tx = plan.tile_y, plan.tile_x
    p = torch.full(a.shape[:-2] + (plan.tiles_y * ty + 2,
                                   plan.tiles_x * tx + 2), fill,
                   dtype=a.dtype)
    p[..., 1:Y + 1, 1:X + 1] = a
    return p.unfold(-2, ty + 2, ty).unfold(-2, tx + 2, tx)


def _untile(a, Y, X):
    """[..., tiles_y, tiles_x, tile_y, tile_x] -> [..., Y, X]."""
    *lead, ny, nx, ty, tx = a.shape
    a = a.movedim(-3, -2).reshape(*lead, ny * ty, nx * tx)
    return a[..., :Y, :X]


def _tiled_gather(plan, K, px, py, live, dead, inv_h):
    """The re-bin of K1 / K4 / K6 tile by tile: positions px, py and their
    validity `live` [K, Y, X] cut into the plan's tiles with their
    one-cell halo, each destination picking from that window alone.
    Returns (slots', count', drop, arrivals across a tile corner)."""
    Y, X = px.shape[-2:]
    ty, tx = plan.tile_y, plan.tile_x
    w_live = _windows(live, plan, False)
    w_px, w_py = _windows(px, plan), _windows(py, plan)
    sy = _windows(torch.arange(Y, dtype=torch.int32)[:, None].expand(Y, X)
                  .contiguous(), plan, -9)
    sx = _windows(torch.arange(X, dtype=torch.int32)[None, :].expand(Y, X)
                  .contiguous(), plan, -9)
    ody = torch.clamp(torch.floor(w_py * inv_h).to(torch.int32) - sy, -1, 1)
    odx = torch.clamp(torch.floor(w_px * inv_h).to(torch.int32) - sx, -1, 1)
    w_dead = _windows(dead, plan, True)[..., 1:ty + 1, 1:tx + 1]

    shape = (plan.tiles_y, plan.tiles_x, ty, tx)
    run = torch.zeros(shape, dtype=torch.int64)
    out_px = torch.zeros((K + 1,) + shape)  # slot K takes what is dropped
    out_py = torch.zeros((K + 1,) + shape)
    corner = 0
    for dy, dx in OFFSETS_OWN_FIRST:
        # the window cells that are destination (y, x)'s source (y-dy, x-dx)
        src = (..., slice(1 - dy, 1 - dy + ty), slice(1 - dx, 1 - dx + tx))
        for k in range(K):
            sel = (w_live[k][src] & (ody[k][src] == dy)
                   & (odx[k][src] == dx) & ~w_dead)
            slot = torch.where(sel & (run < K), run, K)[None]
            out_px.scatter_(0, slot, w_px[k][src][None])
            out_py.scatter_(0, slot, w_py[k][src][None])
            if dy and dx:
                at_y = (torch.arange(ty) == (0 if dy > 0 else ty - 1))
                at_x = (torch.arange(tx) == (0 if dx > 0 else tx - 1))
                corner += int((sel & at_y[:, None] & at_x[None, :]).sum())
            run = run + sel
    kept = run.clamp(max=K)
    opx = _untile(out_px[:K], Y, X)
    opy = _untile(out_py[:K], Y, X)
    return (torch.cat([opx, opy]), _untile(kept, Y, X).to(torch.int32),
            _untile(run - kept, Y, X).to(torch.int32), corner)


def _inv_h(cfg):
    return float(torch.tensor(1.0) / torch.tensor(cfg.side_length))


def tiled_rebin_model(cfg, u, v, fluid, solid, slots, dt, count, *, dead):
    """K1 as the tiled kernel computes it, in torch: march every live
    marker (plainly), then re-bin each tile from its halo window alone.
    Returns (slots', count', drop, arrivals across a tile corner)."""
    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    valid = live_slots(count, K)
    mpx, mpy = march_slots(cfg, u, v, fluid, solid, slots[:K], slots[K:],
                           valid, dt)
    return _tiled_gather(k1.tile_plan(Y, X, K), K, mpx, mpy, valid, dead,
                         _inv_h(cfg))


def tiled_k6_model(cfg, markers, alive, dead):
    """K6 as the tiled kernel computes it: the gather of K1 on K6's plan,
    validity from the alive plane's window.  Returns (store', alive',
    count', drop, arrivals across a tile corner)."""
    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    slots, count, drop, corner = _tiled_gather(
        k1.tile_plan(Y, X, K, "K6"), K, markers[0], markers[1], alive, dead,
        _inv_h(cfg))
    return (slots.reshape(2, K, Y, X), live_slots(count, K), count, drop,
            corner)


def tiled_k5_model(cfg, u, v, fluid, solid, markers, dt, count):
    """K5 as the tiled kernel computes it: each tile's live markers (k <
    count) in (cell, slot) order at the block prefix of its counts, each
    marched (plainly: a pure function of its slot), and slot k of a cell
    read from there for k < count, copied through otherwise."""
    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    plan = k1.tile_plan(Y, X, K, "K5")
    ty, tx = plan.tile_y, plan.tile_x
    every = torch.ones((K, Y, X), dtype=torch.bool)
    marched = torch.stack(march_slots(cfg, u, v, fluid, solid, markers[0],
                                      markers[1], every, dt))

    def tiles(a, fill=0):
        """[..., Y, X] -> [tiles_y, tiles_x, tile cells, ...]."""
        p = torch.full(a.shape[:-2] + (plan.tiles_y * ty, plan.tiles_x * tx),
                       fill, dtype=a.dtype)
        p[..., :Y, :X] = a
        p = p.unflatten(-2, (plan.tiles_y, ty)).unflatten(-1,
                                                          (plan.tiles_x, tx))
        lead = p.dim() - 4
        return p.permute(lead, lead + 2, lead + 1, lead + 3,
                         *range(lead)).reshape(plan.tiles_y, plan.tiles_x,
                                               ty * tx, *a.shape[:-2])

    n = tiles(count.clamp(0, K))                      # [ny, nx, T]
    start = torch.cumsum(n, -1) - n                   # the block prefix
    base = torch.cumsum(n.sum(-1).flatten(), 0) - n.sum(-1).flatten()
    k = torch.arange(K)
    live = k < n[..., None]                           # [ny, nx, T, K]
    pos = tiles(marched.movedim(0, -3))[live]         # (tile, cell, slot)
    first = base.reshape(n.shape[:2])[..., None] + start
    idx = (first[..., None] + k).clamp(max=max(len(pos) - 1, 0))
    inp = tiles(markers.movedim(0, -3))               # [ny, nx, T, K, 2]
    got = torch.where(live[..., None], pos[idx] if len(pos) else inp, inp)
    out = got.reshape(plan.tiles_y, plan.tiles_x, ty, tx, K, 2)
    out = out.permute(5, 4, 0, 2, 1, 3).reshape(
        2, K, plan.tiles_y * ty, plan.tiles_x * tx)
    return out[..., :Y, :X]


CASES = [
    (1000, 1000, 4, "mixed"),
    (37, 130, 4, "mixed"),
    (37, 130, 8, "full"),
    (37, 130, 16, "mixed"),
    (37, 130, 16, "full"),
    (8, 1, 8, "mixed"),
    (8, 1, 16, "full"),
    (100, 136, 8, "empty"),
]


@pytest.mark.parametrize("Y,X,K,fill", CASES)
def test_tiled_rebin_model_equals_plain(Y, X, K, fill):
    cfg, u, v, fluid, solid, slots, dt, count, dead = marker_state(
        Y, X, K, fill, seed=Y + X + K)
    want = k1.march_rebin_plain(cfg, u, v, fluid, solid, slots, dt, count,
                                dead=dead)
    *got, corner = tiled_rebin_model(cfg, u, v, fluid, solid, slots, dt,
                                     count, dead=dead)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    slots_out, count_out, drop = want
    assert not bool(count_out[dead].any())
    live = torch.cat([live_slots(count_out, K)] * 2)
    assert not bool(slots_out[~live].any())  # dead slots are zero
    if fill == "empty":
        return
    assert bool(dead.any())
    if fill == "full":
        assert int(drop.sum()) > 0
    plan = k1.tile_plan(Y, X, K)
    if plan.tiles_y > 1 and plan.tiles_x > 1:
        assert corner > 0  # markers crossed a tile corner diagonally


@pytest.mark.parametrize("holes", [False, True])
@pytest.mark.parametrize("Y,X,K,fill", CASES)
def test_tiled_k6_model_equals_plain(Y, X, K, fill, holes):
    """K6 on the state's marched store, with the front-compacted alive
    plane or one with holes and live slots beyond the count."""
    cfg, markers, alive, dead = rebin_state(Y, X, K, fill, seed=Y + X + K,
                                            holes=holes)
    if holes and fill != "empty":
        count = alive.sum(0, dtype=torch.int32)
        assert not torch.equal(alive, live_slots(count, K))
    want = k6.rebin_markers_plain(cfg, markers, alive, dead)
    *got, corner = tiled_k6_model(cfg, markers, alive, dead)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    store, alive_out, count_out, drop = want
    assert torch.equal(alive_out, live_slots(count_out, K))
    assert not bool(count_out[dead].any())
    assert not bool(store[~torch.stack([alive_out] * 2)].any())
    if fill == "empty":
        assert not bool(store.any())
        return
    if fill == "full" and not holes:
        assert int(drop.sum()) > 0
    plan = k1.tile_plan(Y, X, K, "K6")
    if plan.tiles_y > 1 and plan.tiles_x > 1:
        assert corner > 0


@pytest.mark.parametrize("Y,X,K,fill", CASES)
def test_tiled_k5_model_equals_plain(Y, X, K, fill):
    """K5 on a store whose dead slots hold stale positions: the live
    slots marched, the dead ones copied through, every slot bitwise."""
    cfg, u, v, fluid, solid, slots, dt, count, dead = marker_state(
        Y, X, K, fill, seed=Y + X + K, stale=True)
    markers = slots.reshape(2, K, Y, X)
    want = k5.advect_markers_plain(cfg, u, v, fluid, solid, markers, dt,
                                   count)
    got = tiled_k5_model(cfg, u, v, fluid, solid, markers, dt, count)
    assert got.dtype == want.dtype and torch.equal(got, want)
    live = torch.stack([live_slots(count, K)] * 2)
    assert torch.equal(want[~live], markers[~live])
    if fill != "empty":
        assert not torch.equal(want[live], markers[live])
