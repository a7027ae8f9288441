"""Frame parity of the port against the REAL compiled reference binary:
the corpus under tests/goldens/ref_binary/ (the gcc-built reference's
ANSI byte stream captured in a pty, tests/oracle/capture_ref.py), byte
for byte through the port's `render.ansi.draw_frame`, in the JAX
ref-binary test's configuration (tests/test_ref_binary.py:84-102): the
default `SimConfig`, the global marker layout, f64 Jacobi with
max_iterations 400, a 60 x 130 window.

On the CPU (the plain versions) tier-1 runs frames 0 to 10 of all five
scenarios in mono and of basic.txt in rainbow; the JAX test's horizons
(`HORIZONS`: mono 50, rainbow 25, weird-edges rainbow 17, set there by
the corpus build's FMA contraction) are marked `slow`, and on the card
(G1, G2, S1, K7, P1) marked `cuda`.  Every run also checks that no solve
reached the config's cap of 400.  Needs no JAX.

Every frame to the horizon is compared.  One frame differs, on the CPU
and on the card alike: filter.txt in rainbow at frame 16, where one
colour channel of one cell is one level of 255 off (frames 15 and 17 to
25 match).  The port computes the JAX package's functions op by op, and
op by op the JAX package gives the port's bytes: `step_frame` under
`jax.disable_jit()` equals the port at every frame to 16 and parts from
the corpus at 16, where its compiled `step_frame_jit` equals the corpus
(tools/ref_binary_opbyop.py).  So the difference is XLA's compilation of
the JAX frame, which contracts some products and sums into fused
multiply-adds, not an operation of the port; by frame 16 a colour there
sits on the other side of an 8-bit step.  `KNOWN_DIFFS` pins that frame,
and the test holds it to exactly that one-level difference.
"""

import functools
import os
import re

import numpy as np
import pytest
import torch

from euler_tpu_torch import sim
from euler_tpu_torch.core.scenario import load_scenario
from euler_tpu_torch.render.ansi import draw_frame

from global_states import golden_config

GOLD = os.path.join(os.path.dirname(__file__), "goldens", "ref_binary")
WINDOW = (60, 130)  # the pty the corpus was captured under
HORIZONS = {
    ("basic", False): 50,
    ("block", False): 50,
    ("filter", False): 50,
    ("waterfall", False): 50,
    ("weird-edges", False): 50,
    ("basic", True): 25,
    ("block", True): 25,
    ("filter", True): 25,
    ("waterfall", True): 25,
    ("weird-edges", True): 17,
}
CPU_CASES = [(name, False) for name in
             ("basic", "block", "filter", "waterfall", "weird-edges")] + [
                 ("basic", True)]
CPU_HORIZON = 10
# frames whose bytes differ from the corpus by one level of one colour
# channel of one cell (see the module docstring)
KNOWN_DIFFS = {("filter", True): (16,)}
TOKEN = re.compile(rb"\x1b\[[0-9;]*[A-Za-z]|[^\x1b]")


def blobs(name: str, rainbow: bool):
    z = np.load(os.path.join(
        GOLD, f"{name}{'_rainbow' if rainbow else ''}.npz"))
    data, off = z["raw"].tobytes(), z["raw_offsets"]
    return [data[off[i]: off[i + 1]] for i in range(len(off) - 1)]


def one_level_off(got: bytes, want: bytes) -> bool:
    """Whether two frames differ in exactly one truecolor escape, by one
    in one of its channels."""
    a, b = TOKEN.findall(got), TOKEN.findall(want)
    if len(a) != len(b):
        return False
    diff = [(x, y) for x, y in zip(a, b) if x != y]
    if len(diff) != 1 or not diff[0][0].startswith(b"\x1b[38;2;"):
        return False
    x, y = (list(map(int, t[2:-1].split(b";"))) for t in diff[0])
    return (len(x) == len(y) == 5 and x[:2] == y[:2]
            and sorted(abs(i - j) for i, j in zip(x, y)) == [0, 0, 0, 0, 1])


@functools.lru_cache(maxsize=None)
def mismatches(name: str, rainbow: bool, horizon: int, device: str):
    """The frames of 0..horizon whose bytes differ from the corpus, each
    with whether it is one level off in one channel, and the most
    iterations one solve took."""
    torch.set_num_threads(1)
    want = blobs(name, rainbow)
    cfg = golden_config(rainbow=rainbow)
    scn, st = load_scenario(f"scenarios/{name}.txt", cfg, device=device)
    most, bad = 0, []
    for frame in range(horizon + 1):
        if frame:
            st, stats = sim.step_frame_stats(cfg, scn, st)
            most = max(most, int(stats["pcg_iters_max"]))
        got = draw_frame(cfg, scn, st, *WINDOW)
        # the captured blobs leave out the leading \x1b[H and the
        # trailing \x1b[?25l
        if got[3:-6] != want[frame]:
            bad.append((frame, one_level_off(got[3:-6], want[frame])))
    return bad, most


def check(name, rainbow, horizon, device):
    bad, most = mismatches(name, rainbow, horizon, device)
    known = tuple(f for f in KNOWN_DIFFS.get((name, rainbow), ())
                  if f <= horizon)
    assert tuple(f for f, _ in bad) == known, (
        f"{name} (rainbow {rainbow}): frames {[f for f, _ in bad]} differ "
        f"from the compiled reference binary (known: {known})")
    assert all(close for _, close in bad), (
        f"{name} (rainbow {rainbow}): a known frame differs by more than "
        "one level of one colour channel")
    assert most < 400


@pytest.mark.parametrize("name,rainbow", CPU_CASES,
                         ids=lambda v: {True: "rainbow", False: "mono"}.get(
                             v, v))
def test_bytes_match_reference_binary(name, rainbow):
    check(name, rainbow, CPU_HORIZON, "cpu")


CASES = sorted(HORIZONS)
IDS = lambda v: {True: "rainbow", False: "mono"}.get(v, v)  # noqa: E731


@pytest.mark.slow
@pytest.mark.parametrize("name,rainbow", CASES, ids=IDS)
def test_bytes_match_reference_binary_full(name, rainbow):
    check(name, rainbow, HORIZONS[(name, rainbow)], "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("name,rainbow", CASES, ids=IDS)
def test_bytes_match_reference_binary_card(name, rainbow):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    check(name, rainbow, HORIZONS[(name, rainbow)], "cuda")
