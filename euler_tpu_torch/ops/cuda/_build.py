"""Build the CUDA sources in `euler_tpu_torch/csrc/` with nvcc and bind
them with ctypes.

Each `<name>.cu` becomes its own shared library with a plain C interface
(no PyTorch headers, so a build takes seconds, not minutes), compiled at
first use for sm_90a into `build/euler_tpu_torch/` at the repo root.  The
file name carries a hash of the sources, the shared headers and the
flags, so an edited source rebuilds and an unchanged one is reused.

Every exported launcher takes device pointers and the CUDA stream as
`void*`, launches on that stream, and returns `cudaGetLastError()`; the
wrappers raise when it is not 0.

`LAUNCHES` and `PLAIN_CALLS` count, per kernel id ("K1", "K2", ...), the
wrapper calls that launched the kernel and those that took its plain
version because the tensors lay on the CPU.

`cached` is the bounded cache of the solvers' workspaces (K3/K11's and
K8-K10's).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "euler_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

# per-library build record: seconds spent in nvcc (0.0 when reused) and
# the ptxas register / shared-memory report
BUILD_LOG: dict[str, dict] = {}
_LIBS: dict[str, ctypes.CDLL] = {}

LAUNCHES: collections.Counter = collections.Counter()
PLAIN_CALLS: collections.Counter = collections.Counter()

PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def hashed_path(name: str, sources, flags) -> Path:
    """build/euler_tpu_torch/lib<name>-<hash>.so, the hash over the
    sources' names and bytes and the flags: an edited source or flag
    gives a new file, an unchanged one the same."""
    digest = hashlib.sha256()
    for path in sources:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def load(name: str, flags=()) -> ctypes.CDLL:
    """Compile csrc/<name>.cu (if its hash changed) and load it."""
    if name in _LIBS:
        return _LIBS[name]
    src = CSRC / f"{name}.cu"
    all_flags = ARCH_FLAGS + BASE_FLAGS + list(flags)
    lib_path = hashed_path(name, [src] + sorted(CSRC.glob("*.cuh")),
                           all_flags)
    record = {"seconds": 0.0, "ptxas": ""}
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *all_flags, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        record["seconds"] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src.name} (rc {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}")
        record["ptxas"] = proc.stderr
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.eu_error_string.argtypes = [INT]
    lib.eu_error_string.restype = ctypes.c_char_p
    BUILD_LOG[name] = record
    _LIBS[name] = lib
    return lib


def bind(lib: ctypes.CDLL, fname: str, argtypes) -> None:
    fn = getattr(lib, fname)
    fn.argtypes = list(argtypes)
    fn.restype = INT


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.eu_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream() -> int:
    """The current PyTorch CUDA stream, as the pointer-sized handle."""
    return torch.cuda.current_stream().cuda_stream


def require(t: torch.Tensor, name: str, dtype, shape=None, device=None):
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (and
    `shape`, and on `device` when given)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and t.shape != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    return t.data_ptr()


def cached(cache, key, make, max_entries: int, max_bytes: int):
    """The entry of `cache` (an OrderedDict) under `key`, made by `make()`
    when missing, now the most recently used.  The newest entry always
    stays; older ones go, least recently used first, each closed, while
    the cache holds more than `max_entries` entries or more than
    `max_bytes` (the sum of the entries' `nbytes`)."""
    entry = cache.pop(key, None)
    if entry is None:
        entry = make()
    cache[key] = entry
    while len(cache) > 1 and (
            len(cache) > max_entries
            or sum(e.nbytes for e in cache.values()) > max_bytes):
        cache.popitem(last=False)[1].close()
    return entry


def close_all(cache) -> None:
    """Close and drop every entry of `cache`."""
    while cache:
        cache.popitem()[1].close()
