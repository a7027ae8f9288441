"""ANSI frame encoding (`euler_tpu/render/ansi.py`), byte for byte
draw_rows (main.c:914-951): glyphs by clamped marker count {" ", "o",
"O", "0"}, solids "X", sinks "=", run-length colour state (prev_water)
so that escape codes are emitted only where the colour changes, 24-bit
truecolour with the sRGB conversion in rainbow mode, and the window
clipping of main.c:917-920.

The device gathers a compact frame (glyph index, cell class and RGB
bytes, 5 bytes a cell) as torch ops and copies it to the host once; the
host encodes the bytes with the port's C++ encoder (`native/`).
`encode_frame_py` is its plain version.

One reference quirk is kept: the sink branch (main.c:927-931) does not
clear prev_water, so a water run interrupted by sinks resumes without
re-emitting its colour code.
"""

from __future__ import annotations

import numpy as np
import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.core.state import FluidState, Scenario
from euler_tpu_torch.ops.color import linear_to_srgb

T_RESET = b"\x1b[0m"
T_BLUE = b"\x1b[34m"
T_CLEAR_LINE = b"\x1b[K"
T_CLEAR = b"\x1b[2J"
T_REPOSITION = b"\x1b[H"
T_HIDE_CURSOR = b"\x1b[?25l"
T_SHOW_CURSOR = b"\x1b[?25h"

SYMBOLS = (b" ", b"o", b"O", b"0")
# cell classes for the encoder
C_EMPTY, C_SOLID, C_SINK = 0, 1, 2


def gather_device(cfg: SimConfig, scn: Scenario, state: FluidState):
    """The frame on the state's device: (glyph u8 [Y, X] in 0..3, class
    u8 [Y, X], rgb u8 [Y, X, 3]), the sRGB conversion and byte
    quantisation of main.c:902-912 included."""
    u8 = torch.uint8
    glyph = torch.clamp(state.marker_count, max=3).to(u8)
    cls = torch.where(scn.solid, C_SOLID,
                      torch.where(scn.sink, C_SINK, C_EMPTY)).to(u8)
    end = float(np.nextafter(np.float32(256.0), np.float32(0.0)))

    def tobyte(x):
        return torch.clamp(end * linear_to_srgb(x), 0.0, end).to(u8)

    rgb = torch.stack([tobyte(state.r), tobyte(state.g), tobyte(state.b)],
                      dim=-1)
    return glyph, cls, rgb


def to_host(glyph, cls, rgb):
    """(glyph, cls, rgb) numpy arrays from device tensors, in one
    device-to-host copy."""
    packed = torch.cat([glyph[..., None], cls[..., None], rgb], dim=-1)
    host = packed.cpu().numpy()
    return host[..., 0], host[..., 1], host[..., 2:]


def gather_frame(cfg: SimConfig, scn: Scenario, state: FluidState):
    """The render gather: (glyph, cls, rgb) numpy arrays, computed on the
    state's device and copied to the host once."""
    return to_host(*gather_device(cfg, scn, state))


def encode_frame(cfg: SimConfig, glyph, cls, rgb, window_rows: int,
                 window_cols: int, rainbow: bool) -> bytes:
    """Host-side ANSI encoding of a gathered frame (main.c:914-951), by
    the C++ encoder; a failed build raises."""
    from euler_tpu_torch.native import encoder

    return encoder.encode_frame(glyph, cls, rgb, window_rows, window_cols,
                                rainbow)


def encode_frame_py(cfg: SimConfig, glyph, cls, rgb, window_rows: int,
                    window_cols: int, rainbow: bool) -> bytes:
    """The plain version of `encode_frame`, in Python."""
    Y, X = cfg.ny, cfg.nx
    y_cutoff = max(Y - 1 - window_rows, 1)
    out = bytearray()
    x_end = min(X - 1, window_cols + 1)  # exclusive (x < X-1 && x < wx+1)
    for y in range(Y - 2, y_cutoff - 1, -1):
        prev_water = False
        row_cls = cls[y]
        row_glyph = glyph[y]
        for x in range(1, x_end):
            c = row_cls[x]
            if c == C_SOLID:
                if prev_water:
                    out += T_RESET
                out += b"X"
                prev_water = False
            elif c == C_SINK:
                if prev_water:
                    out += T_RESET
                out += b"="
                # prev_water intentionally unchanged (main.c:927-931)
            else:
                i = min(int(row_glyph[x]), 3)  # min_u8 clamp (main.c:933)
                has_water = i > 0
                if not prev_water and has_water and not rainbow:
                    out += T_BLUE
                elif has_water and rainbow:
                    r, g, b = rgb[y, x]
                    out += b"\x1b[38;2;%d;%d;%dm" % (r, g, b)
                elif prev_water and not has_water:
                    out += T_RESET
                out += SYMBOLS[i]
                prev_water = has_water
        out += T_RESET + T_CLEAR_LINE
        if y > y_cutoff:
            out += b"\r\n"
    return bytes(out)


def draw_frame(cfg: SimConfig, scn: Scenario, state: FluidState,
               window_rows: int, window_cols: int) -> bytes:
    """The whole frame: cursor home, rows, hide cursor (main.c:953-959)."""
    glyph, cls, rgb = gather_frame(cfg, scn, state)
    body = encode_frame(cfg, glyph, cls, rgb, window_rows, window_cols,
                        cfg.rainbow)
    return T_REPOSITION + body + T_HIDE_CURSOR
