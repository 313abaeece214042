"""ctypes bindings of the native NIH ``.npy`` loader (port of
xmir_tpu/data/native_loader.py; the C++ is ``xmir_tpu_torch/csrc/xmir_loader.cpp``,
host code, a copy of the JAX package's).

The library is built with g++ at first use into
``build/xmir_tpu_torch/loader-<hash>/`` beside the package (a directory git
ignores), keyed by the source, the flags and the host's CPU (``-march=native``),
and loaded with ctypes. A failed build raises ``NativeCompileError``: there is no
silent PIL path. A file whose layout the C++ reader refuses raises
``ValueError`` per call, and the dataset (datasets.py) then takes its PIL path
for that batch, as the JAX package does; ``LOADS`` counts which path ran.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "xmir_loader.cpp"
BUILD_ROOT = _PKG_DIR.parent / "build" / "xmir_tpu_torch"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")
_LIB_NAME = "libxmir_loader.so"

# images loaded by each path: "native" (the C++ reader) and "fallback" (a
# batch the C++ reader refused, loaded by PIL instead)
LOADS: collections.Counter = collections.Counter()
_LOADS_LOCK = threading.Lock()


class NativeCompileError(RuntimeError):
    """g++ is missing or refused the loader's source."""


def count(path: str, n: int):
    with _LOADS_LOCK:
        LOADS[path] += n


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(f"{platform.machine()} {_cpu_model()}".encode())
    return BUILD_ROOT / f"loader-{h.hexdigest()[:16]}"


def build() -> Path:
    """Compile the loader unless this source, these flags and this CPU are
    already built; returns the library's path."""
    out_dir = _build_dir()
    lib = out_dir / _LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{_LIB_NAME}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise NativeCompileError(f"{' '.join(cmd)}: {exc}") from exc
    (out_dir / "build.log").write_text(f"$ {' '.join(cmd)}\n# rc {proc.returncode}\n"
                                       f"{proc.stdout}{proc.stderr}")
    if proc.returncode != 0:
        raise NativeCompileError(f"g++ failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    return lib


_U8P, _I, _S = ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_char_p
_SIGNATURES = {
    "xmir_load_npy": (_S, _U8P, _I, _I),
    "xmir_load_npy_batch": (ctypes.POINTER(_S), _I, _U8P, _I, _I, _I, ctypes.POINTER(_I)),
    "xmir_load_npy_crop": (_S, _U8P, _I),
    "xmir_load_npy_batch_crop": (ctypes.POINTER(_S), _I, _U8P, _I, _I, ctypes.POINTER(_I)),
    "xmir_loader_version": (),
}


_LOAD_LOCK = threading.Lock()


def load() -> ctypes.CDLL:
    """Build if needed, then load the library and declare its signatures.
    The pipeline's decode threads make the first call together: one of them
    builds, the others wait for it."""
    with _LOAD_LOCK:
        return _load()


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def _u8(out: np.ndarray):
    return out.ctypes.data_as(_U8P)


def load_npy_image(path: str, out_h: int, out_w: int) -> np.ndarray:
    """One .npy -> (out_h, out_w, 3) uint8, min-max normalised and
    bilinearly resized (a square squash)."""
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = load().xmir_load_npy(str(path).encode(), _u8(out), out_h, out_w)
    if rc != 0:
        raise ValueError(f"native npy load failed ({rc}): {path}")
    return out


def _batch(fn, paths: Sequence[str], shape, *size_args, n_threads: int = 0) -> np.ndarray:
    n = len(paths)
    out = np.empty((n,) + shape, np.uint8)
    status = (ctypes.c_int * n)()
    encoded = [str(p).encode() for p in paths]  # kept alive for the call
    arr = (ctypes.c_char_p * n)(*encoded)
    failures = fn(arr, n, _u8(out), *size_args, n_threads, status)
    if failures:
        bad = [paths[i] for i in range(n) if status[i] != 0]
        raise ValueError(f"native batch load: {failures} failures, e.g. {bad[:3]}")
    return out


def load_npy_batch(paths: Sequence[str], out_h: int, out_w: int,
                   n_threads: int = 0) -> np.ndarray:
    """A batch on the C++ worker pool -> (N, out_h, out_w, 3) uint8."""
    return _batch(load().xmir_load_npy_batch, paths, (out_h, out_w, 3), out_h, out_w,
                  n_threads=n_threads)


def load_npy_image_crop(path: str, size: int) -> np.ndarray:
    """Aspect-preserving Resize(short=size) + CenterCrop(size) ->
    (size, size, 3) uint8 (torchvision's eval transform)."""
    out = np.empty((size, size, 3), np.uint8)
    rc = load().xmir_load_npy_crop(str(path).encode(), _u8(out), size)
    if rc != 0:
        raise ValueError(f"native npy load failed ({rc}): {path}")
    return out


def load_npy_batch_crop(paths: Sequence[str], size: int, n_threads: int = 0) -> np.ndarray:
    """The aspect-preserving crop of a batch on the C++ worker pool ->
    (N, size, size, 3) uint8."""
    return _batch(load().xmir_load_npy_batch_crop, paths, (size, size, 3), size,
                  n_threads=n_threads)
