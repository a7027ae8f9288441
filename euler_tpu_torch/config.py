"""Simulation configuration, field for field the JAX package's
(`euler_tpu/config.py`): same names, same defaults, so a run is described
by the same two dataclasses on either side.

The port takes the routes the JAX package takes with
`use_pallas_markers=True` and `SolverConfig.use_pallas=True`, whatever
those two say: the hand-written marker pass on the slot layout, then the
grid stage and projection, chosen as the JAX `sim.substep` chooses them
(`sim.route`), by the JAX package's own size gates.  The marker pass is
chosen by `sim.marker_route`, which reads `fuse_marker_pass` and
`marker_padded_store`: the fused pass K1 by default, K4 on the
persistent padded store with `marker_padded_store` (mono, no sources),
the march K5 and the re-bin K6 with `fuse_marker_pass=False`.
`SolverConfig.fuse_projection` and `use_pallas_grid` are read: with
`fuse_projection` a mono substep without sources runs the fused grid
stage + projection (K2 for MG, K10 for Jacobi) and a Jacobi substep the
fused projection (K9) where their gates let it; `use_pallas_grid` runs
the unfused mono grid stage as K7; the rest goes through
`ops.project.project` (K8, K3, K11, K12, P1 or P3).  Fields that choose
between JAX implementations of the same arithmetic are read by nothing
here, because the port has one implementation of each:

  * TPU-only devices: `marker_tile`, `marker_kmax_specialize`,
    `marker_packed_insert`, `marker_interior_fast`, `pallas_interpret`
    (both classes).  Each is exact or off by default in the JAX package,
    so ignoring them changes no result.
  * Dispatch switches between equivalent JAX paths: `use_pallas_markers`,
    `advect_impl`, `SolverConfig.use_pallas`, `SolverConfig.check_every`.

Configurations outside the ported slices (f64 grid fields, the
frame-stale hierarchy, `cfl` above 1; on blocks, RB-GS and rediscretized
MG) make `sim.step_frame` raise NotImplementedError naming their ROADMAP
item (`sim.check_slice`, `pcg_shard_kernel.check_solver`).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Preconditioner = Literal["jacobi", "mg", "ic0", "none"]


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Pressure-projection (PCG) budget and multigrid schedule."""

    max_iterations: int = 100
    tol: float = 1e-6
    # exit when ||r||_inf <= max(tol, tol_rel * ||b||_inf)
    tol_rel: float = 0.0
    # seed each substep's solve from the previous substep's pressure
    warm_start: bool = False
    preconditioner: Preconditioner = "jacobi"
    mg_min_size: int = 32
    mg_pre_smooth: int = 1
    mg_post_smooth: int = 1
    # Chebyshev degree of the coarsest-level solve
    mg_coarse_iters: int = 12
    mg_smoother: str = "cheby"
    mg_cheby_degree: int = 1
    mg_cheby_ratio: float = 4.0
    mg_coarse_ratio: float = 100.0
    # levels < mg_w_depth recurse twice (truncated W)
    mg_w_depth: int = 2
    mg_scheme: str = "galerkin"
    mg_frame_hierarchy: bool = False
    mg_cycle: str = "w"
    dtype: str = "float32"
    check_every: int = 1
    use_pallas: bool = False
    fuse_projection: bool = False
    pallas_interpret: bool = False


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Full simulation configuration."""

    # grid size in P cells, including the one-cell border ring of sinks
    nx: int = 100
    ny: int = 40

    side_length: float = 1.0
    density: float = 1.0
    gravity: float = -10.0

    frame_time: float = 0.1
    max_substeps: int = 8
    cfl: float = 0.75

    markers_per_cell: int = 4
    marker_layout: str = "global"
    slots_per_cell: int = 8
    marker_dt_carry: bool = True
    use_pallas_markers: bool = False
    fuse_marker_pass: bool = True
    marker_tile: tuple = (128, 512)
    pallas_interpret: bool = False
    marker_padded_store: bool = False
    marker_interior_fast: bool = True
    marker_kmax_specialize: bool = True
    marker_packed_insert: bool = True
    use_pallas_grid: bool = False

    rainbow: bool = False
    source_color_period: float = 10.0
    initial_color_period: float = 60.0

    advect_impl: str = "stencil"
    marker_march_iters: int = 4

    solver: SolverConfig = SolverConfig()

    dtype: str = "float32"

    @property
    def max_markers(self) -> int:
        if self.marker_layout == "slots":
            return self.slots_per_cell * self.nx * self.ny
        return self.markers_per_cell * self.nx * self.ny

    @property
    def u_shape(self):
        return (self.ny, self.nx - 1)

    @property
    def v_shape(self):
        return (self.ny - 1, self.nx)

    @property
    def p_shape(self):
        return (self.ny, self.nx)


DEFAULT_CONFIG = SimConfig()
