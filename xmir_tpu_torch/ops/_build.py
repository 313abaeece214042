"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

The sources under ``xmir_tpu_torch/csrc`` compile into one shared library with
a plain C interface, for ``sm_90a`` (Hopper): one nvcc per source, all started
together, then one link. The library goes to
``build/xmir_tpu_torch/<hash>/`` beside the package (a directory git ignores),
keyed by a hash of the sources and the flags, and is built at first use: a
second call in the same checkout loads the cached library.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_ROOT = _PKG_DIR.parent / "build" / "xmir_tpu_torch"
NVCC_FLAGS = (  # per source; the objects are then linked with -shared
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_LIB_NAME = "libxmir_kernels.so"

# ctypes signatures of the C entry points: every pointer and the stream are
# c_void_p, or ctypes would pass them as 32-bit ints and cut them.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # Q, N, D, k, dtype, n_sms -> the plan, 9 ints (int pointer)
    "xmir_topk_plan": (_I,) * 6 + (_P,),
    # q, g, bias, dtype, Q, N, D, k, n_sms, scratch, part_v, part_i, out_v, out_i, stream
    "xmir_topk": (_P, _P, _P) + (_I,) * 6 + (_P,) * 6,
    # q, g, bias, dtype, Q, N, D, k, n_sms, scratch, words, lists, out_v, out_i, stream
    "xmir_topk_select": (_P, _P, _P) + (_I,) * 6 + (_P,) * 6,
    # rows, dtype -> row tiles per image (int pointer)
    "xmir_convnext_plan": (_I, _I, _P),
    # a, x, ln_scale, ln_bias, w1, b1, w2, b2, gamma, beta, dtype, batch, rows,
    # c, c4, h, y, part, nx, out, stream
    "xmir_convnext_tail": (_P,) * 10 + (_I,) * 5 + (_P,) * 6,
    # batch, rows, c, c4, dtype -> workspace bytes (long long pointer)
    "xmir_convnext_bwd_plan": (_I,) * 5 + (_P,),
    # h, dy, lns, lnb, w1, b1, w1t, w2t, gamma, beta, dtype, batch, rows, c, c4,
    # workspace, dacc, dw1, dw2, db1, dg, dbe, dlns, dlnb, check (or null), stream
    "xmir_convnext_bwd": (_P,) * 10 + (_I,) * 5 + (_P,) * 11,
    # x, lns, lnb, w, bias, dtype, batch, n_tok, c, heads, y, q, k, v, stream
    "xmir_ln_qkv": (_P,) * 5 + (_I,) * 5 + (_P,) * 5,
    # x, lns, lnb, w, bias, dtype, rows, c, m, gelu, y, out, stream
    "xmir_ln_dense": (_P,) * 5 + (_I,) * 5 + (_P,) * 3,
    # q, k, v, o, stats (or null), dtype, bh, n, hd, scale * log2(e), stream
    "xmir_vit_attn": (_P,) * 5 + (_I,) * 4 + (_F, _P),
    # dtype, bh, n, hd -> bytes of the backward's scratch (long long pointer)
    "xmir_vit_attn_bwd_workspace": (_I,) * 4 + (_P,),
    # q, k, v, o, g, stats, scratch, dq, dk, dv, dtype, bh, n, hd, scale * log2(e), scale, stream
    "xmir_vit_attn_bwd": (_P,) * 10 + (_I,) * 4 + (_F, _F, _P),
    # dtype, mode, bh, n, hd -> bytes of the f32 route's workspace (long long pointer)
    "xmir_window_attn_workspace": (_I,) * 5 + (_P,),
    # q, k, v, bias, scale, o, dtype, mode, bh, n, hd, d1, m1, s1, d2, m2, s2, workspace,
    # stream
    "xmir_window_attn": (_P,) * 6 + (_I,) * 11 + (_P, _P),
    # dtype, bh, n, hd, groups -> bytes of the backward's scratch (long long pointer)
    "xmir_window_attn_bwd_workspace": (_I,) * 5 + (_P,),
    # q, k, v, o, g, bias, scale, scratch, dq, dk, dv, dbias, dtype, cosine, bh, n, hd,
    # groups, g_size, stream
    "xmir_window_attn_bwd": (_P,) * 12 + (_I,) * 7 + (_P,),
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def find_nvcc() -> str:
    """nvcc from PATH, else ``$CUDA_HOME/bin/nvcc`` (default /usr/local/cuda)."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise KernelBuildError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels of "
        "xmir_tpu_torch need the CUDA toolkit to build"
    )


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless this source hash is already built; returns
    the library path. The compiler's register/shared-memory report goes to
    ``build.log`` beside the library."""
    nvcc = find_nvcc()
    out_dir = BUILD_ROOT / _source_hash()
    lib = out_dir / _LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    t0 = time.perf_counter()
    jobs = []  # (command, object, output file, process): every source compiles at once
    for src in sources():
        obj, out = out_dir / f"{src.stem}.{tag}.o", out_dir / f"{src.stem}.{tag}.log"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        with open(out, "w") as f:
            jobs.append((cmd, obj, out, subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)))
    log, ok = [], True
    for cmd, _, out, proc in jobs:
        rc = proc.wait()
        ok &= rc == 0
        log.append(f"$ {' '.join(cmd)}\n# rc {rc}\n{out.read_text()}")
        out.unlink()
    tmp = out_dir / f"{_LIB_NAME}.{tag}.tmp"
    if ok:
        # -lcuda: libcuda's cuTensorMapEncodeTiled, which makes the copy engine's tensor maps
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _, _ in jobs), "-lcuda"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        ok = proc.returncode == 0
        log.append(f"$ {' '.join(cmd)}\n# rc {proc.returncode}\n{proc.stdout}{proc.stderr}")
    for _, obj, _, _ in jobs:
        obj.unlink(missing_ok=True)
    log = f"# {time.perf_counter() - t0:.1f} s\n" + "\n".join(log)
    (out_dir / "build.log").write_text(log)
    if not ok:
        raise KernelBuildError(f"nvcc failed:\n{log}")
    os.replace(tmp, lib)  # atomic: concurrent builders never load a partial file
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, then load the library and declare its signatures."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
