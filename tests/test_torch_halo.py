"""The sharded pressure solve (`euler_tpu_torch/parallel/halo.py`, P4's
plain version on the CPU) against the JAX package's single-device
functions.

The JAX package's own sharded solver runs under shard_map on 8 virtual
devices, which takes minutes here, so the references are composed from
its single-device pieces (the tolerances are stated at each check):
  * the Jacobi solve on 8 row blocks of tests/test_halo.py:18-49's 64²
    system and on 4 x 2 blocks of tests/test_halo2d.py:25-58's (f64, tol
    1e-10): against JAX `solve_pressure`, atol 1e-8;
  * the block-MG preconditioner (block-Jacobi additive Schwarz, 4 row
    blocks of 16 rows), f32 and f64: one application on each block against
    JAX `cycle_galerkin` on that block's JAX hierarchy; the solve against
    the JAX `pcg_loop` with JAX's `apply_a` and those cycles block by block
    (the composite reference; one jitted compile a dtype for both) and
    against JAX `solve_pressure`, in under half of Jacobi's iterations
    (tests/test_halo.py:91-95);
  * halo.py's rule: every preconditioner but "mg" runs the jnp-form
    Jacobi (halo.py:136-139), so "none" and "ic0" are the port's
    "jacobi" bit for bit, and each is held against JAX
    `halo.make_sharded_pressure_solver` on a one-device mesh (the same
    iterations, p within 1e-12 of scale; f64, tol 1e-6);
  * the exchanges against the global neighbours, zeros at the edges;
  * the refusal of RB-GS MG, naming its ROADMAP item, and the f64 block
    MG solve, which runs;
  * `ops/project.pcg_loop`'s `dot` and `inf_norm` hooks leave P1's plain
    version bit for bit the loop before them.
Most cases run on an in-process `comm.LocalGroup` (one thread a block).
One spawn of 4 gloo ranks (tests/torch_shard_ranks.py `halo_rank`)
checks the `torch.distributed` group on the 2 x 2 Jacobi solve, the
4-block MG solve and the exchanges.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.ops import multigrid as jmg
from euler_tpu.ops import project as jproject
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.parallel import halo
from euler_tpu_torch.parallel.comm import LocalGroup
from euler_tpu_torch.parallel.dryrun import launch

import torch_shard_ranks as ranks
from torch_parity import jax_config

N = ranks.HALO_N


def _jax_system(which, dtype):
    b, fluid, solid = ranks.halo_system(which)
    fl = jnp.asarray(fluid)
    cfg = jax_config(ranks.halo_config("jacobi"), interpret=False)
    a = jproject.pressure_matrix_diag(cfg, jnp.asarray(solid), fl)
    return jnp.asarray(b, dtype), a, fl


@functools.lru_cache(maxsize=None)
def _jax_solve(which):
    """JAX `solve_pressure` of the system, f64 to tol 1e-10."""
    b, a, fl = _jax_system(which, jnp.float64)
    cfg = jax_config(ranks.halo_config("jacobi"), interpret=False)
    p, _, resid = jproject.solve_pressure(cfg, b, a, fl)
    assert float(resid) <= 1e-10
    return np.asarray(p)


def _blocks(shape, fn):
    """fn(comm) on an in-process group of `shape` blocks on the CPU."""
    with LocalGroup(*shape, device="cpu") as g:
        return g.run(fn)


def _whole(parts, shape):
    """The blocks' [Yl, Xl] planes, in rank order, put together."""
    ny, nx = shape
    return torch.cat([torch.cat(parts[y * nx:(y + 1) * nx], 1)
                      for y in range(ny)], 0)


def _solve_blocks(cfg, which, shape):
    axes = ("y",) if shape[1] == 1 else ("y", "x")

    def rank(comm):
        solve = halo.make_sharded_pressure_solver(cfg, comm, axes,
                                                  stats=True)
        return solve(*ranks.halo_block(comm, which, cfg, axes))

    out = _blocks(shape, rank)
    assert len({int(o[1]) for o in out}) == 1
    assert len({float(o[2]) for o in out}) == 1
    return _whole([o[0] for o in out], shape), int(out[0][1]), \
        float(out[0][2])


@pytest.fixture(scope="module")
def gloo():
    return launch(4, "gloo", ranks.halo_rank)


@pytest.mark.parametrize("which,shape", [("rows", (8, 1)),
                                         ("blocks", (4, 2))])
def test_sharded_jacobi_matches_jax(which, shape):
    cfg = ranks.halo_config("jacobi")
    _build.PLAIN_CALLS.clear()
    p, iters, resid = _solve_blocks(cfg, which, shape)
    assert _build.PLAIN_CALLS["P4"] == shape[0] * shape[1]
    assert resid <= cfg.solver.tol
    np.testing.assert_allclose(p.numpy(), _jax_solve(which), atol=1e-8,
                               rtol=0)


def test_sharded_jacobi_2d_on_gloo_ranks(gloo):
    p = _whole([torch.as_tensor(g["jac2d_p"]) for g in gloo], (2, 2))
    assert len({int(g["jac2d_iters"]) for g in gloo}) == 1
    assert float(gloo[0]["jac2d_resid"]) <= 1e-10
    np.testing.assert_allclose(p.numpy(), _jax_solve("blocks"), atol=1e-8,
                               rtol=0)


@pytest.mark.parametrize("shape", [(4, 2), (2, 2)])
def test_exchanges_are_the_global_neighbours(shape, gloo):
    """Rows and columns from the neighbour blocks, zeros at the edges: an
    in-process group of `shape` blocks, and the 2 x 2 gloo ranks."""
    whole = ranks.seeded_plane()
    padded = torch.nn.functional.pad(whole, (1, 1, 1, 1))
    if shape == (2, 2):
        got = [{k[3:]: torch.as_tensor(v) for k, v in g.items()
                if k.startswith("ex_")} for g in gloo]
    else:
        got = _blocks(shape, ranks.exchanged)
    Yl, Xl = N // shape[0], N // shape[1]
    for g in got:
        y0, x0 = int(g["ry"]) * Yl, int(g["rx"]) * Xl
        cols = slice(x0 + 1, x0 + Xl + 1)
        rows = slice(y0 + 1, y0 + Yl + 1)
        assert torch.equal(g["below"], padded[y0:y0 + 1, cols])
        assert torch.equal(g["above"], padded[y0 + Yl + 1:y0 + Yl + 2, cols])
        assert torch.equal(g["left"], padded[rows, x0:x0 + 1])
        assert torch.equal(g["right"], padded[rows, x0 + Xl + 1:x0 + Xl + 2])


MG_BLOCKS = 4
# the block-MG solve's tolerance, and how close the port's application and
# solve come to the JAX references (of the result's scale): f32's level
# sums and dots round apart, f64's by an ulp of each
MG_TOL = {"float32": 1e-4, "float64": 1e-10}
MG_CLOSE = {"float32": (1e-5, 1e-4), "float64": (1e-12, 1e-12)}


@functools.lru_cache(maxsize=None)
def _jax_block_cycle(dtype="float32"):
    """JAX `cycle_galerkin` on each block's own JAX hierarchy in `dtype`,
    as a function of (a, fluid, r) of one block (the blocks share a
    shape)."""
    cfg = ranks.halo_config("mg", dtype)
    s = cfg.solver

    def cycle(a, fl, r):
        levels = jmg.build_galerkin_hierarchy(a, fl, getattr(jnp, dtype),
                                              min_size=s.mg_min_size)
        z = jmg.cycle_galerkin(
            levels, r, pre=s.mg_pre_smooth, post=s.mg_post_smooth,
            coarse_iters=s.mg_coarse_iters,
            w=2 if s.mg_cycle == "w" else 1, smoother=s.mg_smoother,
            cheby_degree=s.mg_cheby_degree, cheby_ratio=s.mg_cheby_ratio,
            coarse_ratio=s.mg_coarse_ratio, w_depth=s.mg_w_depth)
        return jnp.where(fl, z, 0)

    return cycle


def _split(a):
    return jnp.stack(jnp.split(a, MG_BLOCKS, axis=0))


@functools.lru_cache(maxsize=None)
def _jax_block_mg(dtype):
    """The JAX references of the block MG in `dtype`, in one jitted call:
    the per-block cycles of the RHS, and the composite solve, JAX
    `pcg_loop` with JAX `apply_a` and the per-block cycles as its
    preconditioner (tol MG_TOL).  Returns (cycles [4, 16, 64], p,
    iterations)."""
    cfg = jax_config(ranks.halo_config("mg", dtype, MG_TOL[dtype]),
                     interpret=False)
    b, a, fl = _jax_system("rows", getattr(jnp, dtype))
    cycle = jax.vmap(_jax_block_cycle(dtype))

    def refs(b, a, fl):
        def precon(r):
            return cycle(_split(a), _split(fl), _split(r)).reshape(N, N)

        p, iters, _ = jproject.pcg_loop(cfg, b, lambda s: jproject.apply_a(
            a, fl, s), precon)
        return cycle(_split(a), _split(fl), _split(b)), p, iters

    z, p, iters = jax.jit(refs)(b, a, fl)
    return np.asarray(z), np.asarray(p), int(iters)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_block_mg_application_matches_jax(dtype):
    """One application of the block-MG preconditioner on each of 4 row
    blocks of the 64² system: the port's `block_preconditioner` against
    JAX `cycle_galerkin` on the block's JAX hierarchy, within 1e-5 (f32:
    the levels' sums round apart) or 1e-12 (f64) of the result's
    scale."""
    cfg = ranks.halo_config("mg", dtype)
    b, a, fl = _jax_system("rows", getattr(jnp, dtype))
    want = _jax_block_mg(dtype)[0]
    Yl = N // MG_BLOCKS
    for k in range(MG_BLOCKS):
        rows = slice(k * Yl, (k + 1) * Yl)
        tb = torch.as_tensor(np.array(b[rows]))
        precon = halo.block_preconditioner(
            cfg, torch.as_tensor(np.array(a[rows])),
            torch.as_tensor(np.array(fl[rows])), getattr(torch, dtype))
        got = precon(tb).numpy()
        assert got.dtype == np.dtype(dtype)
        scale = np.abs(want[k]).max()
        assert scale > 0
        np.testing.assert_allclose(got, want[k],
                                   atol=MG_CLOSE[dtype][0] * scale, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_block_mg_solve_matches_jax(gloo, dtype):
    """The block-MG solve on 4 row blocks (f32, tol 1e-4; f64, tol 1e-10):
    against the composite JAX reference (f32: p within 1e-4 of its scale,
    iterations within 1, the blocks' dots and the operator's sums round
    apart; f64: p within 1e-12 of its scale, the same iterations) and
    JAX `solve_pressure` (f64; within 1e-3 of the scale, the f32
    tolerance), on the in-process group and, in f32, on the gloo ranks;
    its iterations under half of the sharded Jacobi's
    (test_halo.py:91-95)."""
    cfg = ranks.halo_config("mg", dtype, MG_TOL[dtype])
    p, iters, resid = _solve_blocks(cfg, "rows", (MG_BLOCKS, 1))
    assert p.dtype == getattr(torch, dtype)
    _, want, w_iters = _jax_block_mg(dtype)
    exact = _jax_solve("rows")
    scale = np.abs(exact).max()
    runs = [(p, iters)]
    if dtype == "float32":
        runs.append((_whole([torch.as_tensor(g["mg_p"]) for g in gloo],
                            (4, 1)), int(gloo[0]["mg_iters"])))
    close = MG_CLOSE[dtype][1]
    for got, it in runs:
        assert abs(it - w_iters) <= (1 if dtype == "float32" else 0)
        np.testing.assert_allclose(got.numpy(), want, atol=close * scale,
                                   rtol=0)
        np.testing.assert_allclose(got.numpy(), exact, atol=1e-3 * scale,
                                   rtol=0)
    assert resid <= cfg.solver.tol
    jac = ranks.halo_config("jacobi", dtype, MG_TOL[dtype])
    _, jac_iters, _ = _solve_blocks(jac, "rows", (MG_BLOCKS, 1))
    assert iters < jac_iters // 2, (iters, jac_iters)


def test_warm_start_and_none():
    """A warm start from the exact pressure stops at once; "none" runs
    halo.py's Jacobi (not z = r), so its cold solve is "jacobi"'s bit for
    bit and converges to the exact pressure."""
    cfg = ranks.halo_config("none")
    exact = torch.tensor(_jax_solve("rows"))

    def rank(comm):
        b, a, fl = ranks.halo_block(comm, "rows", cfg)
        Yl = N // comm.size("y")
        rows = slice(comm.rank("y") * Yl, (comm.rank("y") + 1) * Yl)
        solve = halo.make_sharded_pressure_solver(cfg, comm, stats=True)
        return solve(b, a, fl), solve(b, a, fl, exact[rows].contiguous())

    out = _blocks((4, 1), rank)
    cold = _whole([o[0][0] for o in out], (4, 1))
    jac = _solve_blocks(ranks.halo_config("jacobi"), "rows", (4, 1))
    assert torch.equal(cold, jac[0]) and int(out[0][0][1]) == jac[1]
    np.testing.assert_allclose(cold.numpy(), exact.numpy(), atol=1e-8,
                               rtol=0)
    assert int(out[0][1][1]) == 0


@functools.lru_cache(maxsize=None)
def _jax_one_device(precon):
    """JAX `halo.make_sharded_pressure_solver` on a one-device ("y",) mesh
    (f64, tol 1e-6): (p, iterations)."""
    from jax.sharding import Mesh

    from euler_tpu.parallel import halo as jhalo

    mesh = Mesh(np.array(jax.devices()[:1]), ("y",))
    cfg = jax_config(ranks.halo_config(precon, tol=1e-6), interpret=False)
    p, iters, _ = jhalo.make_sharded_pressure_solver(cfg, mesh, stats=True)(
        *_jax_system("rows", jnp.float64))
    return np.asarray(p), int(iters)


@functools.lru_cache(maxsize=None)
def _tol6_solve(precon, which, shape):
    return _solve_blocks(ranks.halo_config(precon, tol=1e-6), which, shape)


@pytest.mark.parametrize("precon", ["jacobi", "none", "ic0"])
def test_every_preconditioner_but_mg_runs_jacobi(precon):
    """halo.py's rule (halo.py:136-139): "none" and "ic0" are the port's
    "jacobi" bit for bit on 4 row blocks and 2 x 2 blocks; on one block
    each takes JAX `halo.make_sharded_pressure_solver`'s iterations on a
    one-device mesh, p within 1e-12 of its scale."""
    for which, shape in (("rows", (4, 1)), ("blocks", (2, 2))):
        got = _tol6_solve(precon, which, shape)
        want = _tol6_solve("jacobi", which, shape)
        assert torch.equal(got[0], want[0]) and got[1:] == want[1:]
    p, iters, _ = _tol6_solve(precon, "rows", (1, 1))
    jp, jiters = _jax_one_device(precon)
    assert iters == jiters > 1
    np.testing.assert_allclose(p.numpy(), jp, rtol=0,
                               atol=1e-12 * np.abs(jp).max())


@pytest.mark.parametrize("over,item", [
    (dict(preconditioner="mg", dtype="float64"), "M15 part b"),
    (dict(preconditioner="mg", dtype="float32", mg_smoother="rbgs"),
     "M14"),
])
def test_refusals(over, item):
    """RB-GS MG is refused, naming M14.  f64 MG, refused until M15 part b
    was ported, runs: its block MG solve on 2 row blocks converges, every
    block on its plain version."""
    cfg = ranks.halo_config(**{"precon": over.pop("preconditioner"), **over})
    if item == "M15 part b":
        _build.PLAIN_CALLS.clear()
        p, iters, resid = _solve_blocks(cfg, "rows", (2, 1))
        assert _build.PLAIN_CALLS["P4"] == 2
        assert p.dtype == torch.float64 and iters > 0
        assert resid <= cfg.solver.tol
        return
    with pytest.raises(NotImplementedError, match=item):
        halo.make_sharded_pressure_solver(cfg, None)


def test_axes_refused():
    with pytest.raises(ValueError, match="axes"):
        halo.make_sharded_pressure_solver(ranks.halo_config("jacobi"), None,
                                          axes=("x",))


def _pcg_loop_before_hooks(cfg, b, apply_fn, precon, x0=None):
    """ops/project.pcg_loop as it was before its `dot` and `inf_norm`
    parameters: the single-device reductions written out."""
    s = cfg.solver
    b_norm = b.abs().max()
    tol = torch.maximum(torch.tensor(s.tol, dtype=b.dtype), s.tol_rel * b_norm)
    nonzero = b_norm != 0
    if x0 is None:
        p, r, done = torch.zeros_like(b), b, ~nonzero
    else:
        p = torch.where(nonzero, x0.to(b.dtype), 0.0)
        r = b - apply_fn(p)
        done = ~nonzero | ~(r.abs().max() > tol)
    z = precon(r)
    d = z
    sigma = (z * r).sum()
    iters = 0
    while iters < s.max_iterations and not bool(done):
        Ad = apply_fn(d)
        zs = (Ad * d).sum()
        alpha = sigma / torch.where(zs != 0, zs, 1.0)
        p = p + alpha * d
        r = r - alpha * Ad
        done = ~(r.abs().max() > tol)
        z = precon(r)
        sigma_new = (z * r).sum()
        beta = sigma_new / torch.where(sigma != 0, sigma, 1.0)
        d = z + beta * d
        sigma = sigma_new
        iters += 1
    return p, torch.tensor(iters, dtype=torch.int32), r.abs().max()


@pytest.mark.parametrize("precon,dtype,warm", [
    ("jacobi", "float64", False), ("none", "float64", True),
    ("jacobi", "float32", True), ("ic0", "float64", False)])
def test_pcg_loop_hooks_leave_p1_plain_bitwise(precon, dtype, warm):
    """P1's plain version (`solve_pressure_general_plain`: `pcg_loop` with
    the default reductions) is bit for bit the loop before the hooks."""
    from euler_tpu_torch.ops import project
    from euler_tpu_torch.ops.cuda.pcg_general_kernel import (
        solve_pressure_general_plain,
    )

    cfg = ranks.halo_config(precon, dtype, 1e-9 if dtype == "float64"
                            else 1e-5)
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, max_iterations=60))
    b, fluid, solid = ranks.halo_system("rows")
    fl = torch.as_tensor(fluid)
    a = project.pressure_matrix_diag(cfg, torch.as_tensor(solid), fl)
    bt = torch.as_tensor(b, dtype=getattr(torch, dtype))
    x0 = torch.where(fl, bt * 0.25, 0.0) if warm else None
    got = solve_pressure_general_plain(cfg, bt, a, fl, x0)
    want = _pcg_loop_before_hooks(
        cfg, bt, lambda s: project.apply_a(a, fl, s),
        project.make_preconditioner(cfg, a, fl), x0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
