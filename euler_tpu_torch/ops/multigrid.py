"""Galerkin multigrid for the pressure solve (`euler_tpu/ops/multigrid.py`,
galerkin hierarchy + Chebyshev smoothing only).

Coarse operators are exact A_c = P^T A P for piecewise-constant
prolongation (each fine cell takes its 2x2 parent's value).  They stay
5-point in edge-weight form: c (diagonal), e (coupling to x+1), n
(coupling to y+1), with real-valued weights that are zero at and toward
cells whose block holds no fluid.  Level 0 is the PCG matrix itself
(main.c:554-575).  All weights are integer-valued, so the hierarchy is
exact in f32.

Smoothing is Chebyshev on [lmax/ratio, lmax], where lmax is each level's
measured Gershgorin bound: a static estimate is violated on speckled
masks and an under-estimate makes Chebyshev diverge.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from euler_tpu_torch.core.state import (
    shift_down,
    shift_left,
    shift_right,
    shift_up,
)


@dataclasses.dataclass
class EdgeLevel:
    """One level: a symmetric 5-point operator in edge-weight form."""

    c: torch.Tensor       # diagonal
    e: torch.Tensor       # east coupling, (i, j) <-> (i, j+1)
    n: torch.Tensor       # north coupling, (i, j) <-> (i+1, j)
    inv_c: torch.Tensor   # 1/c where c > 0 and active, else 0
    active: torch.Tensor  # bool: the block holds a fluid cell
    lmax: torch.Tensor    # 0-d Gershgorin bound max(c + |off-diagonals|)


def _edge_level(c, e, n, active, e_west=None, n_south=None) -> EdgeLevel:
    """The level of weights (c, e, n) and its Gershgorin bound; on a block
    of a grid (`parallel/spatial_mg.py`), `e_west` [Y] and `n_south` [X]
    are the couplings across its west and south edges (zeros when not
    given), and the bound is the block's, to be maxed over the blocks."""
    pos = c > 1e-12
    inv_c = (torch.where(active & pos, 1.0, 0.0).to(c.dtype)
             / torch.where(pos, c, 1.0))
    c = torch.where(active, c, 0.0)
    west = shift_left(e) if e_west is None else torch.cat(
        [e_west[:, None], e[:, :-1]], 1)
    south = shift_down(n) if n_south is None else torch.cat(
        [n_south[None], n[:-1]], 0)
    # off-diagonals are <= 0, so |row off-diagonal sum| = -(e + w + n + s)
    offmag = -(e + west + n + south)
    lmax = torch.clamp_min(torch.where(active, c + offmag, 0.0).max(), 1.0)
    return EdgeLevel(c, e, n, inv_c, active, lmax)


def fine_edge_level(a_diag, fluid, dtype) -> EdgeLevel:
    """The reference operator (apply_a, main.c:679-691) in edge form."""
    fl = fluid
    c = torch.where(fl, a_diag, 0).to(dtype)
    e = torch.where(fl & shift_right(fl, False), -1.0, 0.0).to(dtype)
    n = torch.where(fl & shift_up(fl, False), -1.0, 0.0).to(dtype)
    return _edge_level(c, e, n, fl)


def apply_edge(level: EdgeLevel, x):
    """A x for the symmetric edge-weight 5-point operator."""
    return (
        level.c * x
        + level.e * shift_right(x) + shift_left(level.e * x)
        + level.n * shift_up(x) + shift_down(level.n * x)
    )


def _blocks(a):
    """[Y, X] -> [Y/2, 2, X/2, 2]: (block row, row parity, block col, col
    parity)."""
    Y, X = a.shape
    return a.reshape(Y // 2, 2, X // 2, 2)


def coarsen_planes(level: EdgeLevel):
    """(c_c, e_c, n_c, active) of A_{l+1} = P^T A_l P for constant
    prolongation, by 2x2 block sums:
      c_c = block diagonal sum + 2 * intra-block couplings,
      e_c = couplings crossing to the east block,
      n_c = couplings crossing to the north block."""
    c4, e4, n4 = _blocks(level.c), _blocks(level.e), _blocks(level.n)
    c_c = (c4.sum((1, 3))
           + 2.0 * e4[:, :, :, 0].sum(1)     # east edges inside the block
           + 2.0 * n4[:, 0, :, :].sum(-1))   # north edges inside the block
    e_c = e4[:, :, :, 1].sum(1)
    n_c = n4[:, 1, :, :].sum(-1)
    act = _blocks(level.active).any(3).any(1)
    return c_c, e_c, n_c, act


def coarsen_galerkin(level: EdgeLevel) -> EdgeLevel:
    """A_{l+1} = P^T A_l P (`coarsen_planes`) with its Gershgorin bound."""
    return _edge_level(*coarsen_planes(level))


def extend_hierarchy(levels, min_size: int = 32, max_levels: int = 16):
    """Coarsen the last level of `levels` (fine to coarse, the grid's
    level l at index l) down to min_size, padding an odd level with
    inactive cells before coarsening it, to at most max_levels + 1
    levels."""
    while len(levels) <= max_levels:
        lv = levels[-1]
        Y, X = lv.c.shape
        if min(Y, X) <= min_size:
            break
        if Y % 2 or X % 2:
            pad = (0, X % 2, 0, Y % 2)
            lv = EdgeLevel(
                *(F.pad(t, pad) for t in (lv.c, lv.e, lv.n, lv.inv_c)),
                F.pad(lv.active.to(torch.uint8), pad) != 0,
                lv.lmax,
            )
            levels[-1] = lv
        levels.append(coarsen_galerkin(lv))
    return levels


def build_galerkin_hierarchy(a_diag, fluid, dtype, min_size: int = 32,
                             max_levels: int = 16):
    """EdgeLevel list, fine to coarse (level 0 = the PCG matrix).  Odd
    level sizes are padded with inactive cells before coarsening."""
    return extend_hierarchy([fine_edge_level(a_diag, fluid, dtype)],
                            min_size, max_levels)


def cheby_coefficients(lmax, degree: int, ratio: float):
    """Golub-Varga coefficient schedule on [lmax/ratio, lmax]:
    (inv_theta, [(c_prev_k, c_r_k)]) with d_0 = r_0 / theta and
    d_k = c_prev_k * d_{k-1} + c_r_k * r_k.  `lmax` may be a tensor of
    any shape (elementwise)."""
    lmin = lmax / ratio
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    sigma = theta / delta
    rho = 1.0 / sigma
    coefs = []
    for _ in range(degree):
        rho_new = 1.0 / (2.0 * sigma - rho)
        coefs.append((rho_new * rho, 2.0 * rho_new / delta))
        rho = rho_new
    return 1.0 / theta, coefs


def cheby_smooth(level: EdgeLevel, x, b, degree: int, ratio: float,
                 apply=None):
    """`degree` Chebyshev steps on [lmax/ratio, lmax] from iterate x;
    `apply(x)` is A x (`apply_edge` of the level by default)."""
    apply = functools.partial(apply_edge, level) if apply is None else apply
    inv_theta, coefs = cheby_coefficients(level.lmax.to(b.dtype), degree,
                                          ratio)
    r = b - apply(x)
    d = r * inv_theta
    for c_prev, c_r in coefs:
        x = x + d
        r = r - apply(d)
        d = c_prev * d + c_r * r
    return x


def cycle_galerkin(levels, b, lvl: int = 0, coarse_iters: int = 12,
                   w: int = 2, cheby_degree: int = 2,
                   cheby_ratio: float = 4.0, coarse_ratio: float = 100.0,
                   w_depth: int = 3):
    """One truncated-W multigrid cycle (levels < w_depth recurse `w`
    times, except directly above the coarsest) with Chebyshev smoothing
    and a degree-`coarse_iters` Chebyshev coarsest solve.  Restriction is
    the 2x2 block sum (no 1/4), prolongation the constant injection."""
    level = levels[lvl]
    Yb, Xb = b.shape
    Yl, Xl = level.c.shape
    if (Yb, Xb) != (Yl, Xl):
        b = F.pad(b, (0, Xl - Xb, 0, Yl - Yb))
    kw = dict(coarse_iters=coarse_iters, w=w, cheby_degree=cheby_degree,
              cheby_ratio=cheby_ratio, coarse_ratio=coarse_ratio,
              w_depth=w_depth)
    if lvl == len(levels) - 1:
        x = cheby_smooth(level, torch.zeros_like(b), b, coarse_iters,
                         coarse_ratio)
        return torch.where(level.active, x, 0.0)[:Yb, :Xb]
    x = cheby_smooth(level, torch.zeros_like(b), b, cheby_degree,
                     cheby_ratio)
    visits = w if (lvl < w_depth and lvl + 1 < len(levels) - 1) else 1
    for _ in range(visits):
        r = b - apply_edge(level, x)
        rc = _blocks(r).sum((1, 3))
        ec = cycle_galerkin(levels, rc, lvl + 1, **kw)
        x = x + ec.repeat_interleave(2, 0).repeat_interleave(2, 1)
    x = cheby_smooth(level, x, b, cheby_degree, cheby_ratio)
    # the prolongation adds parent values everywhere; mask once on exit
    return torch.where(level.active, x, 0.0)[:Yb, :Xb]


def cycle_kwargs(cfg) -> dict:
    """`cycle_galerkin`'s schedule from `cfg.solver`."""
    s = cfg.solver
    return dict(coarse_iters=s.mg_coarse_iters,
                w=2 if s.mg_cycle == "w" else 1,
                cheby_degree=s.mg_cheby_degree, cheby_ratio=s.mg_cheby_ratio,
                coarse_ratio=s.mg_coarse_ratio, w_depth=s.mg_w_depth)


def make_mg_preconditioner(cfg, a_diag, fluid, dtype):
    """z = M^-1 r of the JAX `make_mg_preconditioner` (multigrid.py:492)
    with the Galerkin scheme: one cycle on the hierarchy of (a_diag,
    fluid), padded where a level is odd.  The plain version of P3's
    preconditioner step."""
    levels = build_galerkin_hierarchy(a_diag, fluid, dtype,
                                      min_size=cfg.solver.mg_min_size)
    kw = cycle_kwargs(cfg)
    return lambda r: cycle_galerkin(levels, r, **kw)
