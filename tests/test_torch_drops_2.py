"""Slot-capacity drops over 50 frames, the port against the JAX
package's measured counts (tests/torch_drops.py): filter, and waterfall
with its 60 sources."""

import pytest

from torch_drops import check_drops


@pytest.mark.parametrize("name", ["filter", "waterfall"])
def test_marker_drops_match_jax_on_golden_scenarios(name):
    check_drops(name)
