"""Plants one fault at a time in the ViT kernels (K2, K7, K8) on an NVIDIA
card and prints how far each faulty kernel lies from its plain PyTorch
version, beside the real kernels' readings: the evidence the bounds in
xmir_tpu_torch/ops/vit_attn.py and ops/convnext_block.py (``agreement``)
were set from.

    python3 chip_faults.py

A fault in a CUDA source is a text substitution in a copy of
xmir_tpu_torch/csrc under a temporary directory, built by ops/_build.py like
the real sources (one build per fault, ~15 s each); the checkout's sources
are never touched. A fault in a wrapper's constant or in a plain version is
planted in Python for the one call. Readings are worst cases over the
shapes of chip_smoke.py's kernel phase that the fault can reach. Exits 1
if a real kernel is outside its bounds or a planted fault inside them.
"""
from __future__ import annotations

import shutil
import sys
import tempfile
from pathlib import Path

import torch

from xmir_tpu_torch.ops import _build
from xmir_tpu_torch.ops import convnext_block as cb
from xmir_tpu_torch.ops import ln_dense as ld
from xmir_tpu_torch.ops import vit_attn as va

REAL_CSRC = _build.CSRC_DIR
ROUND_BF16 = "__bfloat162float(__float2bfloat16({}))"

# name -> (file, old text, new text): one substitution in a copy of the sources
SOURCE_FAULTS = {
    "K2: e rounded before the sum z": (
        "vit_attn.cu", "sum += e0 + e1;",
        f"sum += {ROUND_BF16.format('e0')} + {ROUND_BF16.format('e1')};"),
    "K2: running max not rounded up (rescales no power of two)": (
        "vit_attn.cu", "const float m_new = fmaxf(m_run[h], ceilf(mx));\n      alpha[h] = pow2i("
        "m_run[h] - m_new);",
        "const float m_new = fmaxf(m_run[h], mx);\n      alpha[h] = exp2f(m_run[h] - m_new);"),
    "K7, K8: LN eps 1e-5 for 1e-6": (
        "gemm_tile.cuh", "constexpr float kLnEps = 1e-6f;", "constexpr float kLnEps = 1e-5f;"),
    "K8: erf GELU for tanh": (
        "gemm_tile.cuh",
        "return v * (0.5f * (1.f + tanhf(kGeluK0 * (v + kGeluK1 * v * v * v))));",
        "return v * (0.5f * (1.f + erff(v * 0.7071067811865476f)));"),
    "K7, K8: sum rounded before the bias": (
        "ln_dense.cu",
        "if (n < N) emit(m, n, acc[i][j] + bias[j], acc[i][j + 1] + bias[j + 1], true);",
        "if (n < N) emit(m, n, round_to(acc[i][j], T()) + bias[j], "
        "round_to(acc[i][j + 1], T()) + bias[j + 1], true);"),
}


def use_sources(directory: Path):
    _build.CSRC_DIR = directory
    _build.load.cache_clear()
    _build.load()


def worst(readings):
    out = {}
    for e in readings:
        for k, v in e.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def attention_cases(gen):
    """Random scores at the DINOv2 shape and ragged ones, and rows with few
    dominant scores (scores scaled up: the rounding of e shows most there)."""
    for bh, n, hd, gain in ((24, 1370, 64, 1.0), (3, 257, 64, 1.0), (2, 300, 72, 1.0),
                            (3, 729, 64, 4.0), (3, 300, 32, 8.0)):
        q, k, v = (torch.randn((bh, n, hd), generator=gen).cuda() for _ in range(3))
        yield (q * gain).bfloat16(), k.bfloat16(), v.bfloat16(), hd ** -0.5


def read_attention(scale_constant=None):
    gen = torch.Generator().manual_seed(0)
    readings = []
    with torch.inference_mode():
        for q, k, v, sc in attention_cases(gen):
            real = va.scale_constant
            if scale_constant is not None:
                va.scale_constant = scale_constant
            try:
                out = va.vit_attention_fused(q, k, v, sc)
            finally:
                va.scale_constant = real
            readings.append(va.agreement(out, va.attention_plain(q, k, v, sc)))
    return worst(readings)


def ln_plain_unrounded(x, lns, lnb, w, b, act):
    """K8's plain version with the LayerNorm output left in f32."""
    y = cb.layer_norm(x, lns, lnb)
    out = torch.nn.functional.linear(y.float(), w.float())
    if b is not None:
        out = out + b
    if act == "gelu":
        out = torch.nn.functional.gelu(out, approximate="tanh")
    return out.to(x.dtype)


def read_ln(dtype, plain_unrounded=False):
    gen = torch.Generator().manual_seed(1)
    r7, r8 = [], []

    def r(*shape, sc=1.0):
        return (torch.randn(shape, generator=gen) * sc).cuda()

    with torch.inference_mode():
        # the second case's rows are small (std 0.02 about 0), so that eps matters
        for b, n, c, heads, std, mean in ((2, 1370, 768, 12, 2.0, 0.5), (2, 257, 256, 4, 0.02, 0)):
            x = (r(b, n, c) * std + mean).to(dtype)
            lns, lnb = 1 + r(c, sc=0.2), r(c, sc=0.1)
            w, bias = r(3 * c, c, sc=c ** -0.5).to(dtype), r(3 * c, sc=0.1)
            w1, b1 = r(4 * c, c, sc=c ** -0.5).to(dtype), r(4 * c, sc=0.1)
            rows = x.reshape(b * n, c)
            if not plain_unrounded:
                for o, ref in zip(ld.ln_qkv_fused(x, lns, lnb, w, bias, heads),
                                  ld.ln_qkv_reference(x, lns, lnb, w, bias, heads)):
                    r7.append(ld.agreement(o, ref))
            for act in ("gelu", ""):
                out = ld.ln_dense_fused(rows, lns, lnb, w1, b1, 1e-6, act)
                ref = (ln_plain_unrounded(rows, lns, lnb, w1, b1, act) if plain_unrounded
                       else ld.ln_dense_reference(rows, lns, lnb, w1, b1, 1e-6, act))
                r8.append(ld.agreement(out, ref))
    return worst(r7), worst(r8)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_faults: torch.cuda.is_available() is False; this script needs a "
                         "CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}", flush=True)
    ok = True

    def report(name, kernel, reading, want_inside):
        nonlocal ok
        inside = cb.agrees(reading)
        ok &= inside == want_inside
        print(f"[faults] {name:60s} {kernel:9s} {'inside' if inside else 'OUTSIDE'} "
              f"(expected {'inside' if want_inside else 'outside'}): {reading}", flush=True)

    use_sources(REAL_CSRC)
    report("the kernel", "K2 bf16", read_attention(), True)
    for dtype in (torch.bfloat16, torch.float32):
        e7, e8 = read_ln(dtype)
        report("the kernel", f"K7 {str(dtype)[6:]}", e7, True)
        report("the kernel", f"K8 {str(dtype)[6:]}", e8, True)
    report("K2: q-scale constant not rounded to bf16", "K2 bf16",
           read_attention(lambda s, dtype: s * va.LOG2E), False)
    report("K8's plain version with the LN output left unrounded", "K8 bf16",
           read_ln(torch.bfloat16, plain_unrounded=True)[1], False)
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, (file, old, new)) in enumerate(SOURCE_FAULTS.items()):
            directory = Path(tmp) / f"fault{i}"
            shutil.copytree(REAL_CSRC, directory)
            text = (directory / file).read_text()
            if text.count(old) != 1:
                raise SystemExit(f"chip_faults: {file} does not hold exactly one {old!r}")
            (directory / file).write_text(text.replace(old, new))
            use_sources(directory)
            if name.startswith("K2"):
                report(name, "K2 bf16", read_attention(), False)
                continue
            e7, e8 = read_ln(torch.bfloat16)
            f7, f8 = read_ln(torch.float32)
            if "K7" in name:
                report(name, "K7 bf16", e7, False)
            report(name, "K8 bf16", e8, False)
            if "eps" in name or "erf" in name:  # faults of arithmetic, not of rounding
                report(name, "K8 float32", f8, False)
        use_sources(REAL_CSRC)
    print(f"[faults] {'every bound sits between the kernels and the faults' if ok else 'FAILED'}")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
