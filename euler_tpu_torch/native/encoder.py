"""ctypes binding of the native ANSI frame encoder."""

from __future__ import annotations

import ctypes

import numpy as np

from euler_tpu_torch.native import get_lib


def encode_frame(glyph, cls, rgb, window_rows, window_cols, rainbow) -> bytes:
    glyph = np.ascontiguousarray(glyph, dtype=np.uint8)
    cls = np.ascontiguousarray(cls, dtype=np.uint8)
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    Y, X = glyph.shape
    # worst case ~24 bytes (truecolour escape + glyph) a cell + row codes
    cap = Y * X * 24 + Y * 16 + 64
    out = ctypes.create_string_buffer(cap)
    n = get_lib().euler_encode_frame(
        glyph.ctypes.data, cls.ctypes.data, rgb.ctypes.data, Y, X,
        window_rows, window_cols, 1 if rainbow else 0, out, cap)
    if n < 0:
        raise RuntimeError("native encoder buffer overflow")
    return out.raw[:n]
