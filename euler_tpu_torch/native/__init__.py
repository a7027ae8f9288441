"""Native (C++) host components, bound with ctypes: the ANSI frame
encoder (`encoder.cpp`, the port's own copy of the JAX package's).

Built at first use with g++ -O2 -shared -fPIC into build/euler_tpu_torch/
at the repo root, under a name that carries a hash of the source and the
flags (`ops/cuda/_build.hashed_path`), never next to the sources.  A
failed build raises: `render.ansi.encode_frame_py` is the plain version
the tests hold the encoder against, not a fallback.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from pathlib import Path

from euler_tpu_torch.ops.cuda import _build

_SRC = Path(__file__).resolve().parent / "encoder.cpp"
_FLAGS = ["-O2", "-shared", "-fPIC"]


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The built and bound encoder library."""
    path = _build.hashed_path("encoder", [_SRC], _FLAGS)
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {_SRC.name} (rc "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    lib.euler_encode_frame.restype = ctypes.c_long
    lib.euler_encode_frame.argtypes = [
        ctypes.c_void_p,  # glyph
        ctypes.c_void_p,  # cls
        ctypes.c_void_p,  # rgb
        ctypes.c_long,    # Y
        ctypes.c_long,    # X
        ctypes.c_long,    # wrows
        ctypes.c_long,    # wcols
        ctypes.c_int,     # rainbow
        ctypes.c_char_p,  # out
        ctypes.c_long,    # out_cap
    ]
    return lib
