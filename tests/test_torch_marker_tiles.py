"""K1 / K4's tiled launch, checked on the CPU as plain Python (imports
nothing of JAX; runs in seconds):

  * `tile_plan` covers every cell of ragged grids exactly once, stays
    within the shared memory a block may use on an H100 for K = 1..16,
    and raises for a K it cannot hold;
  * a torch model of the kernel's gather (csrc/marker_pass.cu
    `march_rebin_tiles`): the plainly marched store cut into the plan's
    tiles, each with its one-cell halo, and re-binned tile by tile from
    that window alone, each destination walking its sources in
    OFFSETS_OWN_FIRST order and their live slots in k order.  It equals
    `march_rebin_plain` bit for bit, every slot of the store included,
    on seeded states (tests/marker_states.py) with dead cells, cells
    driven over K, and markers that cross tile corners diagonally.
"""

import pytest
import torch

from euler_tpu_torch.ops.cuda import marker_fused_kernel as k1
from euler_tpu_torch.ops.markers_slots import (
    OFFSETS_OWN_FIRST,
    live_slots,
    march_slots,
)

from marker_states import marker_state

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


def tiled_rebin_model(cfg, u, v, fluid, solid, slots, dt, count, *, dead):
    """K1 as the tiled kernel computes it, in torch: march every live
    marker (plainly), then re-bin each tile from its halo window alone.
    Returns (slots', count', drop, arrivals across a tile corner)."""
    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    plan = k1.tile_plan(Y, X, K)
    ty, tx = plan.tile_y, plan.tile_x
    inv_h = float(torch.tensor(1.0) / torch.tensor(cfg.side_length))
    valid = live_slots(count, K)
    mpx, mpy = march_slots(cfg, u, v, fluid, solid, slots[:K], slots[K:],
                           valid, dt)
    # the halo window of each tile: live slots, positions, home cells
    w_cnt = _windows(count.clamp(0, K), plan)
    w_live = torch.arange(K)[:, None, None, None, None] < w_cnt[None]
    w_px, w_py = _windows(mpx, plan), _windows(mpy, plan)
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
