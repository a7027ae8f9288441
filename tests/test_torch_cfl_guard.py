"""The port refuses cfl > 1 on every slot marker route (K1, K4, K5+K6),
and why: a marker that ends a march more than one cell from home is
re-binned three ways by the JAX package.

On a seeded 64² state with one marker two cells right of its home cell
(dt = 0, so the march leaves it there) the JAX package's jnp re-bin
clamps the move to one cell, its Pallas re-bin K6 takes the exact cell,
which no cell gathers from (each gathers from its 3 x 3 neighbours), so
the marker is lost, and its Pallas K1 codes the move (my + 1) * 3 + (mx + 1) = 6, the code
of (+1, -1), so the marker lands up and to the left.  The port clamps,
as the jnp re-bin does; with no route of the JAX package to follow
above one cell a substep, `sim.check_slice` raises there."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from euler_tpu.ops import markers_slots as jms
from euler_tpu.ops.pallas.marker_fused_kernel import march_rebin_pallas
from euler_tpu.ops.pallas.rebin_kernel import rebin_markers_pallas
from euler_tpu_torch import sim
from euler_tpu_torch.core.presets import dam_break
from euler_tpu_torch.ops.cuda import marker_fused_kernel as k1
from euler_tpu_torch.ops.cuda import rebin_kernel as k6

from torch_parity import (
    developed_numpy,
    jax_config,
    jax_state,
    n,
    port_config,
    port_state,
)


@pytest.mark.parametrize("route", ["K1", "K4", "K5+K6"])
@pytest.mark.parametrize("cfl", [1.5, 1.0])
def test_cfl_above_one_raises(route, cfl):
    over = {"K1": {}, "K4": {"marker_padded_store": True},
            "K5+K6": {"fuse_marker_pass": False}}[route]
    cfg = port_config(32, cfl=cfl, **over)
    scn, st = dam_break(cfg, device="cpu")
    assert sim.marker_route(cfg, scn) == route
    if cfl > 1.0:
        with pytest.raises(NotImplementedError, match="cfl"):
            sim.step_frame(cfg, scn, st)
    else:
        assert int(sim.step_frame(cfg, scn, st).frame_count) == 1


def _two_cells_from_home():
    """The developed 64² dam break with slot 0 of one fluid cell moved
    two cells right, where each re-bin's destination has room; returns
    (numpy arrays, (y, x) of the home cell)."""
    scn_np, st_np = developed_numpy(64)
    cfg = port_config(64)
    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    count = st_np["marker_count"]
    dead = scn_np["sink"] | scn_np["solid"]
    room = (count < K) & ~dead  # a cell that takes one more marker

    def at(a, dy, dx):  # a[y + dy, x + dx] at (y, x)
        return np.roll(a, (-dy, -dx), (0, 1))

    # home (y, x) and the three cells the re-bins send its marker to
    ok = ((count >= 1) & ~dead & at(room, 0, 1) & at(room, 0, 2)
          & at(room, 1, -1))
    ok[:, -4:] = ok[:, :2] = ok[-3:] = False
    ys, xs = np.nonzero(ok)
    y, x = int(ys[len(ys) // 2]), int(xs[len(xs) // 2])
    st_np = dict(st_np)
    markers = st_np["markers"].reshape(2, K, Y, X).copy()
    markers[0, 0, y, x] += 2.0 * cfg.side_length
    st_np["markers"] = markers.reshape(2, -1)
    return (scn_np, st_np), (y, x)


def test_routes_disagree_two_cells_from_home():
    cfg = port_config(64)
    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    arrays, (y, x) = _two_cells_from_home()
    jcfg = jax_config(cfg)
    jscn, jst = jax_state(arrays)
    scn, st = port_state(arrays)
    base = n(st.marker_count)
    dead = (jscn.sink | jscn.solid).astype(jnp.float32)
    px = jst.markers[0].reshape(K, Y, X)
    py = jst.markers[1].reshape(K, Y, X)
    valid = jst.alive.reshape(K, Y, X)

    jnp_cfg = dataclasses.replace(jcfg, use_pallas_markers=False)
    clamp = np.asarray(jms.refresh_marker_counts_slots(
        jnp_cfg, jscn, jst).marker_count)
    exact = np.asarray(rebin_markers_pallas(
        jcfg, px, py, valid.astype(jnp.float32), dead, True)[3])
    coded = np.asarray(march_rebin_pallas(
        jcfg, jst.u, jst.v, jst.fluid, jscn.solid,
        jst.markers.reshape(2 * K, Y, X), jnp.float32(0.0),
        jst.marker_count, True, dead=dead)[1])

    def moved_to(count):
        """Where the marker went from (y, x), or None if it was lost."""
        d = count - base
        assert d[y, x] == -1 and d.sum() in (0, -1)
        d[y, x] = 0
        if not d.any():
            return None
        (dy,), (dx,) = np.nonzero(d)
        return int(dy) - y, int(dx) - x

    assert moved_to(clamp) == (0, 1)     # jnp re-bin: clamped to one cell
    # Pallas K6 takes the exact cell, two away, but each cell gathers
    # only from its 3 x 3 neighbours: no cell gathers it, and it is lost
    assert moved_to(exact) is None
    assert moved_to(coded) == (1, -1)    # Pallas K1: code 6 aliases (+1, -1)

    # the port clamps on both of its re-bins, as the jnp re-bin does
    port_k6 = k6.rebin_markers(cfg, st.markers, st.alive,
                               scn.sink | scn.solid)[2]
    port_k1 = k1.march_rebin(cfg, st.u, st.v, st.fluid, scn.solid,
                             st.markers.reshape(2 * K, Y, X),
                             0.0 * st.u[0, 0], st.marker_count,
                             dead=scn.sink | scn.solid)[1]
    np.testing.assert_array_equal(n(port_k6), clamp)
    np.testing.assert_array_equal(n(port_k1), clamp)
