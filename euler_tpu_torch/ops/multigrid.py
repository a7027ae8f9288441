"""Multigrid for the pressure solve (`euler_tpu/ops/multigrid.py`): the
Galerkin hierarchy with Chebyshev or red-black Gauss-Seidel smoothing, and
the rediscretized hierarchy with its bilinear V-cycle.

Galerkin.  Coarse operators are exact A_c = P^T A P for piecewise-constant
prolongation (each fine cell takes its 2x2 parent's value).  They stay
5-point in edge-weight form: c (diagonal), e (coupling to x+1), n
(coupling to y+1), with real-valued weights that are zero at and toward
cells whose block holds no fluid.  Level 0 is the PCG matrix itself
(main.c:554-575).  All weights are integer-valued, so the hierarchy is
exact in f32.  Smoothing is Chebyshev on [lmax/ratio, lmax], where lmax is
each level's measured Gershgorin bound (a static estimate is violated on
speckled masks and an under-estimate makes Chebyshev diverge), or, with
`smoother="rbgs"`, symmetric red-black Gauss-Seidel (`smooth_edge`).

Rediscretized (`mg_scheme="rediscretize"`).  The masks are coarsened (a
coarse cell is fluid if any of its 2x2 children is, solid if all are) and
the 5-point operator rebuilt on each level (`build_hierarchy`); levels are
stored unpadded.  Restriction and prolongation are cell-centred bilinear
(weights 9/16, 3/16, 3/16, 1/16), the smoother is RB-GS, the cycle a V
(`v_cycle`).

Every sum keeps the JAX package's operand order, so an f64 cycle repeats
its values to the last bits where XLA contracts nothing into an FMA.
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


def _checkerboard(shape, device):
    """The red cells, (y + x) even."""
    yy = torch.arange(shape[0], device=device)[:, None]
    xx = torch.arange(shape[1], device=device)[None, :]
    return ((yy + xx) & 1) == 0


def smooth_edge(level: EdgeLevel, x, b, iters: int, reverse: bool = False):
    """`iters` red-black Gauss-Seidel sweeps on the edge-weight level (exact
    for 5-point: the colours decouple), red first or, `reverse`, black
    first (the post-smooth, so that the cycle is symmetric)."""
    red = _checkerboard(x.shape, x.device)
    first, second = (~red, red) if reverse else (red, ~red)

    def half(x, mask):
        r = b - apply_edge(level, x)
        return x + torch.where(mask, r * level.inv_c, 0.0)

    for _ in range(iters):
        x = half(half(x, first), second)
    return x


def cycle_galerkin(levels, b, lvl: int = 0, pre: int = 1, post: int = 1,
                   coarse_iters: int = 12, w: int = 2,
                   smoother: str = "cheby", cheby_degree: int = 2,
                   cheby_ratio: float = 4.0, coarse_ratio: float = 100.0,
                   w_depth: int = 3):
    """One truncated-W multigrid cycle (levels < w_depth recurse `w`
    times, except directly above the coarsest).  smoother="cheby":
    degree-`cheby_degree` Chebyshev smoothing and a degree-`coarse_iters`
    Chebyshev coarsest solve; "rbgs": `pre` and `post` RB-GS sweeps, the
    post-smooth in reversed colour order, and `coarse_iters` forward then
    as many reversed sweeps on the coarsest level.  Restriction is the 2x2
    block sum (no 1/4), prolongation the constant injection."""
    level = levels[lvl]
    Yb, Xb = b.shape
    Yl, Xl = level.c.shape
    if (Yb, Xb) != (Yl, Xl):
        b = F.pad(b, (0, Xl - Xb, 0, Yl - Yb))
    kw = dict(pre=pre, post=post, coarse_iters=coarse_iters, w=w,
              smoother=smoother, cheby_degree=cheby_degree,
              cheby_ratio=cheby_ratio, coarse_ratio=coarse_ratio,
              w_depth=w_depth)
    if lvl == len(levels) - 1:
        if smoother == "cheby":
            x = cheby_smooth(level, torch.zeros_like(b), b, coarse_iters,
                             coarse_ratio)
        else:
            x = smooth_edge(level, torch.zeros_like(b), b, coarse_iters)
            x = smooth_edge(level, x, b, coarse_iters, reverse=True)
        return torch.where(level.active, x, 0.0)[:Yb, :Xb]
    if smoother == "cheby":
        x = cheby_smooth(level, torch.zeros_like(b), b, cheby_degree,
                         cheby_ratio)
    else:
        x = smooth_edge(level, torch.zeros_like(b), b, pre)
    visits = w if (lvl < w_depth and lvl + 1 < len(levels) - 1) else 1
    for _ in range(visits):
        r = b - apply_edge(level, x)
        rc = _blocks(r).sum((1, 3))
        ec = cycle_galerkin(levels, rc, lvl + 1, **kw)
        x = x + ec.repeat_interleave(2, 0).repeat_interleave(2, 1)
    if smoother == "cheby":
        x = cheby_smooth(level, x, b, cheby_degree, cheby_ratio)
    else:
        x = smooth_edge(level, x, b, post, reverse=True)
    # the prolongation adds parent values everywhere; mask once on exit
    return torch.where(level.active, x, 0.0)[:Yb, :Xb]


def cycle_kwargs(cfg) -> dict:
    """`cycle_galerkin`'s schedule from `cfg.solver`."""
    s = cfg.solver
    return dict(pre=s.mg_pre_smooth, post=s.mg_post_smooth,
                coarse_iters=s.mg_coarse_iters,
                w=2 if s.mg_cycle == "w" else 1, smoother=s.mg_smoother,
                cheby_degree=s.mg_cheby_degree, cheby_ratio=s.mg_cheby_ratio,
                coarse_ratio=s.mg_coarse_ratio, w_depth=s.mg_w_depth)


# ---- the rediscretized hierarchy (mg_scheme="rediscretize") ----


@dataclasses.dataclass
class MGLevel:
    """One level of the rediscretized hierarchy."""

    fluid: torch.Tensor     # bool
    a_diag: torch.Tensor    # int32: 4 - #solid neighbours on fluid, else 0
    inv_diag: torch.Tensor  # 1 / a_diag on fluid with a_diag > 0, else 0


def _pad_even(a, fill):
    """`a` with a row and / or a column of `fill` after it where a side is
    odd."""
    Y, X = a.shape
    if Y % 2:
        a = torch.cat([a, torch.full_like(a[:1], fill)], 0)
    if X % 2:
        a = torch.cat([a, torch.full_like(a[:, :1], fill)], 1)
    return a


def rediscretize(solid, fluid, dtype):
    """(a_diag, inv_diag) of the 5-point operator on (solid, fluid): the
    cells beyond the plane are not solid."""
    s = solid.to(torch.int32)
    diag = 4 - (shift_left(s) + shift_right(s) + shift_down(s) + shift_up(s))
    a_diag = torch.where(fluid, diag, 0).to(torch.int32)
    inv = (torch.where(fluid & (a_diag > 0), 1.0, 0.0).to(dtype)
           / torch.clamp_min(a_diag, 1).to(dtype))
    return a_diag, inv


def coarsen_masks(solid, fluid):
    """The masks of the level below: fluid where any child is fluid (a pad
    of not fluid), solid where every child is solid (a pad of solid) and
    the cell is not fluid."""
    f = _pad_even(fluid, False)
    s = _pad_even(solid, True)
    Y2, X2 = f.shape
    cf = f.reshape(Y2 // 2, 2, X2 // 2, 2).any(3).any(1)
    cs = s.reshape(Y2 // 2, 2, X2 // 2, 2).all(3).all(1)
    return cs & ~cf, cf


def build_hierarchy(solid, fluid, dtype, min_size: int = 32,
                    max_levels: int = 16):
    """MGLevel list from fine to coarse (level 0 = the input grid), each
    level ceil(Y/2) x ceil(X/2) of the one above, down to a side of at most
    min_size."""
    levels = []
    cur_solid, cur_fluid = solid, fluid
    for _ in range(max_levels):
        levels.append(MGLevel(cur_fluid, *rediscretize(cur_solid, cur_fluid,
                                                       dtype)))
        if min(cur_fluid.shape) <= min_size:
            break
        cur_solid, cur_fluid = coarsen_masks(cur_solid, cur_fluid)
    return levels


def _apply_a(level: MGLevel, x):
    lap = level.a_diag.to(x.dtype) * x - (
        shift_left(x) + shift_right(x) + shift_down(x) + shift_up(x))
    return torch.where(level.fluid, lap, 0.0)


def _smooth(level: MGLevel, x, b, iters: int, omega: float = 1.0,
            reverse: bool = False):
    """`iters` red-black Gauss-Seidel sweeps with relaxation `omega`, red
    first or, `reverse`, black first; the result masked to the fluid."""
    red = _checkerboard(x.shape, x.device)
    first, second = (~red, red) if reverse else (red, ~red)

    def half(x, mask):
        r = b - _apply_a(level, x)
        return x + torch.where(mask, omega * r * level.inv_diag, 0.0)

    for _ in range(iters):
        x = half(half(x, first), second)
    return torch.where(level.fluid, x, 0.0)


# cell-centred bilinear weights: 3/4 from the parent, 1/4 from the
# neighbour on each axis
_W0, _W1 = 0.75, 0.25


def _prolong(e, fine_shape):
    """Bilinear prolongation, coarse [Yc, Xc] -> fine [2 Yc, 2 Xc] cropped
    to `fine_shape`: fine cell (2i + a, 2j + b) takes 9/16 of e[i, j] and
    3/16, 3/16, 1/16 of its neighbours toward its own side."""
    ny = {0: shift_down(e), 1: shift_up(e)}
    nx = {0: shift_left(e), 1: shift_right(e)}

    def quad(a, b):
        nxy = shift_left(ny[a]) if b == 0 else shift_right(ny[a])
        return ((_W0 * _W0) * e + (_W0 * _W1) * nx[b]
                + (_W1 * _W0) * ny[a] + (_W1 * _W1) * nxy)

    Yc, Xc = e.shape
    rows = torch.stack([torch.stack([quad(a, b) for b in (0, 1)], -1)
                        for a in (0, 1)], 1)       # [Yc, 2, Xc, 2]
    return rows.reshape(2 * Yc, 2 * Xc)[:fine_shape[0], :fine_shape[1]]


def _restrict(r):
    """The adjoint of `_prolong` (total mass 4), `r` zero-padded to even
    first."""
    r = _pad_even(r, 0.0)
    Y, X = r.shape
    q = r.reshape(Y // 2, 2, X // 2, 2)
    out = 0.0
    for a in (0, 1):
        opp_y = shift_up if a == 0 else shift_down
        for b in (0, 1):
            opp_x = shift_right if b == 0 else shift_left
            f = q[:, a, :, b]
            out = (out + (_W0 * _W0) * f + (_W0 * _W1) * opp_x(f)
                   + (_W1 * _W0) * opp_y(f) + (_W1 * _W1) * opp_x(opp_y(f)))
    return out


def v_cycle(levels, b, lvl: int = 0, pre: int = 2, post: int = 2,
            coarse_iters: int = 24, omega: float = 1.0):
    """One V-cycle on the rediscretized hierarchy: `pre` RB-GS sweeps, the
    bilinear restriction of the residual, the cycle below, the bilinear
    prolongation added on the fluid, `post` reversed sweeps; on the
    coarsest level `coarse_iters` forward then as many reversed sweeps."""
    level = levels[lvl]
    b = torch.where(level.fluid, b, 0.0)
    if lvl == len(levels) - 1:
        x = _smooth(level, torch.zeros_like(b), b, coarse_iters, omega)
        return _smooth(level, x, b, coarse_iters, omega, reverse=True)
    x = _smooth(level, torch.zeros_like(b), b, pre, omega)
    r = torch.where(level.fluid, b - _apply_a(level, x), 0.0)
    rc = _restrict(r)
    ec = v_cycle(levels, rc, lvl + 1, pre, post, coarse_iters, omega)
    ec = torch.where(levels[lvl + 1].fluid, ec, 0.0)
    x = x + torch.where(level.fluid, _prolong(ec, b.shape), 0.0)
    return _smooth(level, x, b, post, omega, reverse=True)


def make_mg_preconditioner(cfg, solid, fluid, dtype, a_diag=None):
    """z = M^-1 r of the JAX `make_mg_preconditioner` (multigrid.py:492):
    with the Galerkin scheme one cycle of `cycle_galerkin` on the
    hierarchy of (a_diag, fluid) (a_diag from `solid` when not given),
    padded where a level is odd; with "rediscretize" one `v_cycle` on the
    hierarchy of (solid, fluid).  The plain version of the preconditioner
    step of P3 and P7."""
    s = cfg.solver
    if s.mg_scheme == "galerkin":
        if a_diag is None:
            a_diag = rediscretize(solid, fluid, dtype)[0]
        levels = build_galerkin_hierarchy(a_diag, fluid, dtype,
                                          min_size=s.mg_min_size)
        kw = cycle_kwargs(cfg)
        return lambda r: cycle_galerkin(levels, r, **kw)
    levels = build_hierarchy(solid, fluid, dtype, min_size=s.mg_min_size)
    return functools.partial(v_cycle, levels, pre=s.mg_pre_smooth,
                             post=s.mg_post_smooth,
                             coarse_iters=s.mg_coarse_iters)
