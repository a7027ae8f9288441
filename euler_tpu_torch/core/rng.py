"""Deterministic xorshift64* RNG (`euler_tpu/core/rng.py`), bit for bit
the reference's (misc/rng.c:4-20, main.c:203-207).

The reference seeds one xorshift64* stream with 0x9bd185c449534b91
(main.c:204) and consumes it in a fixed order: marker seeding
(main.c:254-267), then source emission (main.c:288).

Two implementations, as in the JAX package:

* Host (`XorShift64Star`): numpy uint64, used at init time by
  `core/scenario.py:seed_markers`.  `randf` divides in f64, as the
  reference does.
* Device (`next32`, `randf32`): torch ops on a [..., 2] int64 tensor of
  the (hi, lo) 32-bit words.  torch on the CPU has no `>>` on uint32 or
  uint64, so each word lives in an int64 lane and is masked to 32 bits
  after every shift and product; the 32 x 32 products are built from
  16-bit limbs so that no int64 product overflows.  Word for word the
  JAX `next32` (rng.py:93-112).  `randf32` is the correctly rounded f32
  of the u32 times 2^-32 (rng.py:115-128), which can differ from the
  host `randf` by 1 ulp.  These are the plain version of the generator
  that the source-emission kernel S1 runs (`csrc/sources.cu`).

`FluidState.rng` stays a uint32 [2] tensor, converted to and from int64
lanes at the boundary.
"""

from __future__ import annotations

import numpy as np
import torch

SEED = 0x9BD185C449534B91
_MULT = np.uint64(0x2545F4914F6CDD1D)
_MULT_HI = 0x2545F491
_MULT_LO = 0x4F6CDD1D
_U32_MAX = 4294967295.0
_M32 = 0xFFFFFFFF
_M16 = 0xFFFF


class XorShift64Star:
    """Host-side generator; see misc/rng.c:4-20."""

    def __init__(self, seed: int = SEED):
        assert seed != 0
        self.state = np.uint64(seed)

    def next64(self) -> np.uint64:
        x = self.state
        with np.errstate(over="ignore"):
            x ^= x >> np.uint64(12)
            x ^= (x << np.uint64(25)) & np.uint64(0xFFFFFFFFFFFFFFFF)
            x ^= x >> np.uint64(27)
            self.state = x
            return (x * _MULT) & np.uint64(0xFFFFFFFFFFFFFFFF)

    def next32(self) -> np.uint32:
        # misc/rng.c:18-20: the high 32 bits
        return np.uint32(self.next64() >> np.uint64(32))

    def randf(self) -> np.float32:
        # main.c:203-207: (float)(u32 / (double)UINT32_MAX)
        return np.float32(np.float64(self.next32()) / _U32_MAX)

    def state_u32_pair(self) -> np.ndarray:
        """The state as the (hi, lo) uint32 pair the device side takes."""
        return np.array(
            [self.state >> np.uint64(32), self.state & np.uint64(_M32)],
            dtype=np.uint32)


def state_from_u32_pair(pair) -> np.uint64:
    pair = np.asarray(pair, dtype=np.uint64)
    return (pair[0] << np.uint64(32)) | pair[1]


def initial_device_state() -> np.ndarray:
    """The seed (main.c:204) split into (hi, lo) uint32 words."""
    return np.array([SEED >> 32, SEED & _M32], dtype=np.uint32)


# ----------------------------------------------------------------------
# Device side: torch ops on int64 lanes holding 32-bit words
# ----------------------------------------------------------------------

def _mul_lo32(a, b: int):
    """(a * b) mod 2^32 of a 32-bit lane and a 32-bit constant."""
    a0, a1 = a & _M16, a >> 16
    return (((a1 * b) & _M16) << 16) + a0 * b & _M32


def _mul_hi32(a, b: int):
    """The high 32 bits of the 64-bit product of a 32-bit lane and a
    32-bit constant (the JAX `_mul32_wide`'s hi, by 16-bit limbs of a)."""
    a0, a1 = a & _M16, a >> 16
    mid = a1 * b + ((a0 * b) >> 16)  # < 2^49
    return mid >> 16


def next32(state: torch.Tensor):
    """One xorshift64_32star step on int64 [..., 2] (hi, lo) lanes.
    Returns (out32, new_state), both int64 lanes."""
    hi, lo = state[..., 0], state[..., 1]
    # x ^= x >> 12
    hi, lo = hi ^ (hi >> 12), lo ^ ((lo >> 12) | ((hi << 20) & _M32))
    # x ^= x << 25
    hi, lo = hi ^ (((hi << 25) & _M32) | (lo >> 7)), lo ^ ((lo << 25) & _M32)
    # x ^= x >> 27
    hi, lo = hi ^ (hi >> 27), lo ^ ((lo >> 27) | ((hi << 5) & _M32))
    # out = high 32 bits of (x * MULT mod 2^64)
    #     = hi32(lo * MULT_LO) + lo * MULT_HI + hi * MULT_LO  (mod 2^32)
    out = (_mul_hi32(lo, _MULT_LO) + _mul_lo32(lo, _MULT_HI)
           + _mul_lo32(hi, _MULT_LO)) & _M32
    return out, torch.stack([hi, lo], dim=-1)


def randf32(state: torch.Tensor):
    """Uniform f32 in [0, 1] from int64 (hi, lo) lanes: the correctly
    rounded f32 of the u32 (its top 24 bits times 256 plus its low 8,
    each exact in f32), times 2^-32.  Returns (value, new_state)."""
    x, state = next32(state)
    hi24 = (x >> 8).to(torch.float32) * 256.0
    lo8 = (x & 0xFF).to(torch.float32)
    return (hi24 + lo8) * float(np.float32(1.0 / 4294967296.0)), state
