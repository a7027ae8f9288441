"""The port's version of `test_marker_drops_bounded_on_golden_scenarios`
(tests/test_goldens.py:40-55): a bundled scenario, 50 frames on the
slot layout, f32, the Jacobi solve to tol_rel 1e-4 (K8's plain version
here), and the K = 8 slot-capacity drops.  The JAX test bounds them by
its measured counts and notes that equality holds; the port's counts
equal them.  Shared by test_torch_drops_1.py and test_torch_drops_2.py,
which split the scenarios so that each file stays short."""

import torch

from euler_tpu_torch import sim
from euler_tpu_torch.config import SimConfig, SolverConfig
from euler_tpu_torch.core.scenario import load_scenario

# tests/test_goldens.py:33-35
MEASURED_DROPS_50F = {"basic": 9, "block": 51, "filter": 38,
                      "waterfall": 172, "weird-edges": 0}

torch.set_num_threads(1)


def check_drops(name: str) -> None:
    cfg = SimConfig(marker_layout="slots",
                    solver=SolverConfig(dtype="float32", max_iterations=100,
                                        tol_rel=1e-4))
    scn, st = load_scenario(f"scenarios/{name}.txt", cfg, device="cpu")
    for _ in range(50):
        st = sim.step_frame(cfg, scn, st)
    assert int(st.dropped_markers) <= MEASURED_DROPS_50F[name]
    assert int(st.dropped_markers) == MEASURED_DROPS_50F[name]
    assert int(st.alive_count) > 0
