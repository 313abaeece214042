"""Plants one fault at a time in the ViT kernels (K2, K3, K7, K8), the Swin
attention kernels (K4, K6), the large-k top-k (K1') and the ConvNeXtV2 tail
backward (K10) on an NVIDIA card and prints how far each faulty kernel lies
from its plain PyTorch version, beside the real kernels' readings: the
evidence the bounds in xmir_tpu_torch/ops/vit_attn.py (``agreement``,
``grad_agreement``, ``window_agreement``) and ops/convnext_block.py
(``agreement``) were set from, K10's by ``grad_agreement`` too. K1' is held to
bit-equal ids and values on integer inputs.

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
from xmir_tpu_torch.ops import window_attn as wa
from xmir_tpu_torch.ops.topk_kernels import fused_topk_scores, topk_scores_reference

REAL_CSRC = _build.CSRC_DIR
ROUND_BF16 = "__bfloat162float(__float2bfloat16({}))"

# name -> (file, old text, new text, ...): substitutions in a copy of the sources
SOURCE_FAULTS = {
    "K2: e rounded before the sum z": (
        "vit_attn.cu", "sum += e0 + e1;",
        f"sum += {ROUND_BF16.format('e0')} + {ROUND_BF16.format('e1')};"),
    "K2: running max not rounded up (rescales no power of two)": (
        "vit_attn.cu", "const float m_new = fmaxf(m_run[h], ceilf(mx));\n      alpha[h] = pow2i("
        "m_run[h] - m_new);",
        "const float m_new = fmaxf(m_run[h], mx);\n      alpha[h] = exp2f(m_run[h] - m_new);"),
    "K3: dk rounded to bf16 after every query tile": (
        "vit_attn_bwd.cu",
        "        mma_bf16(acc_v[2 * dd + 1], pe, r[2], r[3]);\n      }\n    }\n",
        "        mma_bf16(acc_v[2 * dd + 1], pe, r[2], r[3]);\n      }\n    }\n"
        "    for (int dt = 0; dt < DP / 8; ++dt)\n      for (int e = 0; e < 4; ++e)\n"
        f"        acc_k[dt][e] = {ROUND_BF16.format('acc_k[dt][e]')};\n"),
    "K3: scale missing from dk": (
        "vit_attn_bwd.cu", "rqz = scale8(rq, scale * zinv);", "rqz = scale8(rq, zinv);",
        "[&](int row) { return scale * zinv(row); }", "zinv"),
    "K3: dead key columns unmasked": (
        "vit_attn_bwd.cu",
        "const bool live = k0 + nt * 8 + 2 * t + (e & 1) < n;", "const bool live = true;",
        "const float ev = k0 + tx + 16 * j < n ? exp2f(s[i][j] - m_row[i]) : 0.f;",
        "const float ev = exp2f(s[i][j] - m_row[i]);"),
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
    "K4: bias not scaled by log2(e)": (
        "window_attn.cu", "return __fadd_rn(s, MODE == kV1 ? b : __fmul_rn(b, kLog2e));",
        "return __fadd_rn(s, b);"),
    "K4: q rounded after the normalisation too, before the scale": (
        "window_attn.cu", "for (int i = 0; i < 8; ++i) f[i] = __fmul_rn(f[i], rn);",
        f"for (int i = 0; i < 8; ++i) f[i] = {ROUND_BF16.format('__fmul_rn(f[i], rn)')};"),
    "K4, K6: group index off by one fold": (
        "window_attn.cu", "return (i / g.d1) % g.m1 * g.s1 +",
        "return (i / g.d1 + 1) % g.m1 * g.s1 +"),
    "K4: norm clamp 1e-12 on the sum of squares for 1e-24": (
        "window_attn.cu", "fmaxf(sum_sq, 1e-24f)", "fmaxf(sum_sq, 1e-12f)"),
    "K6: weights rounded before they are normalised": (
        "window_attn.cu", "return d < -87.f ? 0.f : expf(d) / z;",
        f"return d < -87.f ? 0.f : {ROUND_BF16.format('expf(d)')} / z;"),
    "K1': ties to the higher row": (
        "topk_select.cu", "static_cast<unsigned>(~row);", "static_cast<unsigned>(row);",
        "return static_cast<int>(~static_cast<unsigned>(key & 0xffffffffu));",
        "return static_cast<int>(static_cast<unsigned>(key & 0xffffffffu));"),
    "K1': the k-th key left out of the gather": (
        "topk_select.cu", "take = key >= prefix;", "take = key > prefix;"),
    "K1': -0 ranked below +0": (
        "topk_select.cu", "__float_as_uint(__fadd_rn(score, 0.f))", "__float_as_uint(score)"),
    "K10: the GRN term ab dgx / gx dropped from dab": (
        "convnext_block_bwd.cu", "const float d = (dz[at] * ca + a * cb) * gelu_grad(x, t);",
        "const float d = (dz[at] * ca) * gelu_grad(x, t);"),
    "K10: the GELU derivative's 3 K1 written as K1": (
        "convnext_block_bwd.cu", "constexpr float kGelu3K1 = 0.134145f;",
        "constexpr float kGelu3K1 = 0.044715f;"),
    "K10: the LN backward's xhat mean(dyh xhat) term dropped": (
        "convnext_block_bwd.cu", "store(out + c, st.y * (dyh - m1 - xhat * m2));",
        "store(out + c, st.y * (dyh - m1));"),
    "K10: dW1 summed over the first image only": (
        "convnext_block_bwd.cu", "TnArgs t1{dh1, y, br, ws.chunk, c4, c, part_w1};",
        "TnArgs t1{dh1, y, rows, ws.chunk, c4, c, part_w1};"),
}


def use_sources(directory: Path):
    _build.CSRC_DIR = directory
    _build.load.cache_clear()
    _build.load()


def worst(readings):
    """The largest of each reading; a NaN (which agrees with nothing) sticks."""
    out = {}
    for e in readings:
        for k, v in e.items():
            seen = out.get(k, 0.0)
            out[k] = v if v != v or (seen == seen and v > seen) else seen
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


def backward_cases(gen, dtype):
    """K3's operands (q, k, v, g, scale): random scores at the DINOv2 shape
    and ragged ones, rows with few dominant scores, and rows whose every
    shift lies below -128 at a ragged N (where 2^-m of an unmasked dead key
    column overflows)."""
    for bh, n, hd, gain in ((24, 1370, 64, 1.0), (3, 257, 64, 1.0), (2, 300, 72, 1.0),
                            (3, 729, 64, 4.0), (4, 300, 64, -8.0)):
        q, k, v, g = (torch.randn((bh, n, hd), generator=gen).cuda() for _ in range(4))
        if gain < 0:
            q, k = q.abs() * gain, k.abs() * -gain
        else:
            q = q * gain
        yield q.to(dtype), k.to(dtype), v.to(dtype), g.to(dtype), hd ** -0.5


def backward_plain_with(fault):
    """``va.attention_bwd_plain`` with one rounding point moved: "t" leaves t
    in f32; "z" applies 1 / z to the score tile (p = e / z) instead of the
    small operands; "c" takes c = rowsum(p dp) from p and dp rounded to the
    input dtype instead of rowsum(g o)."""
    def plain(q, k, v, o, g, sm_scale):
        dt = q.dtype
        qs = q * torch.tensor(va.scale_constant(sm_scale, dt), dtype=dt, device=q.device)
        s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
        e = torch.exp2(s - torch.ceil(s.amax(dim=-1, keepdim=True)))
        zinv = 1.0 / e.sum(dim=-1, keepdim=True)
        g32 = g.float()
        dp = torch.matmul(g32, v.float().transpose(-1, -2))
        if fault == "c":
            c = ((e * zinv).to(dt).float() * dp.to(dt).float()).sum(dim=-1, keepdim=True)
        else:
            c = (g32 * o.float()).sum(dim=-1, keepdim=True)
        if fault == "z":
            e, row, zinv = e * zinv, sm_scale, 1.0
        else:
            row = sm_scale * zinv
        t = e * (dp - c)
        if fault != "t":
            t = t.to(dt).float()
        dq = (torch.matmul(t, k.float()) * row).to(dt)
        qz, gz = (q.float() * row).to(dt), (g32 * zinv).to(dt)
        dk = torch.matmul(t.transpose(-1, -2), qz.float()).to(dt)
        dv = torch.matmul(e.to(dt).float().transpose(-1, -2), gz.float()).to(dt)
        return dq, dk, dv

    return plain


def read_backward(dtype, plain=va.attention_bwd_plain):
    """K3's worst ``va.grad_agreement`` reading over ``backward_cases``."""
    gen = torch.Generator().manual_seed(4)
    readings = []
    for q, k, v, g, sc in backward_cases(gen, dtype):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = va.vit_attention_fused(*leaves, sc)
        grads = torch.autograd.grad(out, leaves, g)
        for a, b, floor in zip(grads, plain(q, k, v, out.detach(), g, sc),
                               va.grad_floors(q, k, v, g, sc)):
            readings.append(va.grad_agreement(a, b, floor))
    return worst(readings)


def read_train_slice():
    """chip_smoke.py's f32 DINOv2 training slice, the kernels against their
    plain versions: the reading its TRAIN_F32_MEAN_TOL gates."""
    import chip_smoke as cs

    with tempfile.TemporaryDirectory() as tmp:
        data, pt, start, steps, _ = cs.dinov2_train_setup(Path(tmp))
        run = cs.make_trainer(Path(tmp), "dinov2", data, "-p", "2")
        with cs.env_flags(XMIR_FUSED_LN_MLP=None, **cs.FUSED_VIT):
            return cs.f32_kernels_against_plain(run, pt, start, steps[0])


def tail_bwd_cases(gen, dtype):
    """K10's operands (h, dy, ln_scale, ln_bias, w1, b1, w2, gamma, beta): two
    of ConvNeXtV2-Base's stage shapes at 384 px (B = 2) and the tiny model's
    width at 49 rows."""
    for b, hw, c in ((2, 48, 256), (2, 12, 1024), (2, 7, 96)):
        c4 = 4 * c

        def r(*shape, sc=1.0):
            return (torch.randn(shape, generator=gen) * sc).cuda()

        h, dy = r(b, hw * hw, c).to(dtype), r(b, hw * hw, c).to(dtype)
        yield (h, dy, 1 + r(c, sc=0.2), r(c, sc=0.1), r(c4, c, sc=c ** -0.5).to(dtype),
               r(c4, sc=0.1), r(c, c4, sc=c4 ** -0.5).to(dtype), r(c4, sc=0.5), r(c4, sc=0.1))


def tail_plain_dh1_unrounded(h, dy, ln_scale, ln_bias, w1, b1, w2, gamma, beta):
    """K10's plain version with dh1 left in f32 before its products (dW1 and
    dyln): tail_backward_reference from its intermediates, dh1b = dh1."""
    t = cb._tail_backward_terms(h, dy, ln_scale, ln_bias, w1, b1, w2, gamma, beta)
    c, c4 = h.shape[-1], w1.shape[0]
    xhat, dh1 = t["xhat"], t["dh1"]
    dyln = dh1 @ w1.float()
    dyh = dyln * ln_scale.float()
    dacc = t["rstd"] * (dyh - dyh.mean(dim=-1, keepdim=True)
                        - xhat * (dyh * xhat).mean(dim=-1, keepdim=True))
    return (dacc.to(h.dtype), (dyln * xhat).sum(dim=(0, 1)), dyln.sum(dim=(0, 1)),
            dh1.reshape(-1, c4).t() @ t["y"].float().reshape(-1, c), dh1.sum(dim=(0, 1)),
            cb.linear_f32(dy.reshape(-1, c).t(), t["z"].reshape(-1, c4).t()),
            (t["s1"] * t["nx"]).sum(dim=(0, 1)), t["dz"].sum(dim=(0, 1)))


def read_tail_bwd(dtype, plain=cb.tail_backward_reference):
    """K10's worst ``va.grad_agreement`` reading over its eight outputs
    and ``tail_bwd_cases``."""
    gen = torch.Generator().manual_seed(5)
    readings = []
    for args in tail_bwd_cases(gen, dtype):
        for out, ref, floor in zip(cb.convnext_tail_bwd(*args), plain(*args),
                                   cb.tail_grad_floors(*args)):
            readings.append(va.grad_agreement(out, ref, floor, dtype))
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


def window_cases(gen, dtype):
    """K4's operands in its fold (head, window, image): SwinV2-Base's last two
    stage shapes at B = 2, a shifted fold with ragged N, and a case with every
    scale at the clamp, few live keys a row and rows of norm 1e-9 (which only
    the 1e-24 clamp normalises). Yields (q, k, v, bias, scale, g_size, b, nw, h)."""
    for b, nw, h, n, shifted, hard in ((2, 1, 16, 576, False, False), (2, 1, 32, 144, False, False),
                                       (2, 4, 2, 140, True, False), (3, 4, 2, 144, True, True)):
        q, k, v = (torch.randn((h * nw * b, n, 32), generator=gen).cuda() for _ in range(3))
        groups = h * nw if shifted else h
        bias = (16 * torch.rand((groups, n, n), generator=gen)).cuda()
        if shifted:
            bias += torch.where(torch.rand((groups, n, n), generator=gen) < 0.4, -100.0,
                                0.0).cuda()
        scale = (1 + 59 * torch.rand(groups, generator=gen)).cuda()
        if hard:
            scale.fill_(100.0)
            bias[:, :, 3:] -= 100.0
            q[:, ::3] *= 1e-9 / 5.6
            k[:, 1::4] *= 1e-9 / 5.6
        yield (q.to(dtype), k.to(dtype), v.to(dtype), bias, scale,
               b if shifted else nw * b, b, nw, h)


def plain_k_unrounded(q, k, v, bias, scale, g_size, cosine):
    """K4's plain version with the normalised k left in f32."""
    gidx = va.group_index(q.shape[0], bias.shape[0], g_size, q.device)
    c = (scale.reshape(-1).float() * va.LOG2E)[gidx][:, None, None]
    qf, kf = q.float(), k.float()
    qs = ((qf * va.inv_norm(qf)) * c).to(q.dtype)
    s = torch.matmul(qs.float(), (kf * va.inv_norm(kf)).transpose(-1, -2))
    s = s + (bias.float() * va.LOG2E)[gidx]
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul(e.to(v.dtype).float(), v.float())
    return (o / e.sum(dim=-1, keepdim=True)).to(v.dtype)


def read_window(dtype, k4_plain=va.biased_attention_plain):
    """(K4's, K6's) worst reading over ``window_cases``."""
    gen = torch.Generator().manual_seed(2)
    r4, r6 = [], []
    with torch.inference_mode():
        for q, k, v, bias, scale, g_size, b, nw, h in window_cases(gen, dtype):
            out = va.biased_attention_fused(q, k, v, bias, scale, g_size, True)
            r4.append(va.window_agreement(out, k4_plain(q, k, v, bias, scale, g_size, True)))
            n = q.shape[1]

            def layout(t):
                return t.reshape(h, nw, b, n, 32).permute(1, 2, 0, 3, 4).contiguous()

            qf, kf = layout(q).float(), layout(k).float()
            per_head = scale.reshape(h, -1)[:, 0].reshape(1, 1, h, 1, 1)
            ops = ((qf * va.inv_norm(qf) * per_head).to(dtype), (kf * va.inv_norm(kf)).to(dtype),
                   layout(v), bias.reshape(h, -1, n, n).permute(1, 0, 2, 3).contiguous())
            r6.append(va.window_agreement(wa.window_attention_fused(*ops),
                                          wa.window_attention_plain(*ops)))
    return worst(r4), worst(r6)


def read_select():
    """K1' on integer inputs with planted ties, masked rows and -0 scores:
    of_bound 0 when ids and values are bit-equal to the plain version's."""
    gen = torch.Generator().manual_seed(3)
    equal = True
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randint(-3, 4, (33, 64), generator=gen).float()
        g = torch.randint(-3, 4, (4099, 64), generator=gen).float()
        g[[5, 63, 64, 2048, 4098]] = g[3].clone()
        q[0] = g[3]
        q, g = q.to("cuda", dtype), g.to("cuda", dtype)
        bias = torch.zeros(4099, device="cuda")
        bias[4090:] = float("-inf")
        for k in (1025, 2048, 4099):
            v, i = fused_topk_scores(q, g, bias, k)
            torch.cuda.synchronize()
            rv, ri = topk_scores_reference(q, g, bias, k)
            equal &= torch.equal(v, rv) and torch.equal(i, ri)
        # a last product that underflows to -0 on some rows, plus a bias of
        # -0, gives scores of -0 there and +0 on the rest: all equal, so the
        # ranking is the row order
        q = torch.zeros((2, 64))
        g = torch.zeros((2100, 64))
        q[0, 63], q[1, 63] = -1e-30, 1e-30
        g[10:900:7, 63] = 1e-30
        i = fused_topk_scores(q.to("cuda", dtype), g.to("cuda", dtype),
                              torch.full((2100,), -0.0, device="cuda"), 2100)[1]
        equal &= torch.equal(i, torch.arange(2100, device="cuda", dtype=torch.int32).expand(2, -1))
    return {"max_abs_err": 0.0, "of_bound": 0.0 if equal else float("inf"), "mean_steps": 0.0}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_faults: torch.cuda.is_available() is False; this script needs a "
                         "CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}", flush=True)
    ok = True

    def report(name, kernel, reading, want_inside, agrees=cb.agrees):
        nonlocal ok
        inside = agrees(reading)
        ok &= inside == want_inside
        print(f"[faults] {name:60s} {kernel:9s} {'inside' if inside else 'OUTSIDE'} "
              f"(expected {'inside' if want_inside else 'outside'}): {reading}", flush=True)

    use_sources(REAL_CSRC)
    report("the kernel", "K2 bf16", read_attention(), True)
    for dtype in (torch.bfloat16, torch.float32):
        e7, e8 = read_ln(dtype)
        report("the kernel", f"K7 {str(dtype)[6:]}", e7, True)
        report("the kernel", f"K8 {str(dtype)[6:]}", e8, True)
    for dtype in (torch.bfloat16, torch.float32):
        e4, e6 = read_window(dtype)
        report("the kernel", f"K4 {str(dtype)[6:]}", e4, True)
        report("the kernel", f"K6 {str(dtype)[6:]}", e6, True)
    report("the kernel", "K1'", read_select(), True)
    for dtype in (torch.bfloat16, torch.float32):
        report("the kernel", f"K3 {str(dtype)[6:]}", read_backward(dtype), True, va.grad_agrees)
    for dtype in (torch.bfloat16, torch.float32):
        report("the kernel", f"K10 {str(dtype)[6:]}", read_tail_bwd(dtype), True,
               va.grad_agrees)
    report("K10's plain version with dh1 left unrounded before its products", "K10 bf16",
           read_tail_bwd(torch.bfloat16, tail_plain_dh1_unrounded), False, va.grad_agrees)
    import chip_smoke as cs

    def report_slice(name, want_inside):
        nonlocal ok
        reading = read_train_slice()
        inside = reading["mean_apart_of_mean_moved"] <= cs.TRAIN_F32_MEAN_TOL
        ok &= inside == want_inside
        print(f"[faults] {name:60s} f32 slice {'inside' if inside else 'OUTSIDE'} (expected "
              f"{'inside' if want_inside else 'outside'}): {reading}", flush=True)

    report_slice("the kernel: cli.train dinov2 f32 against the plain versions", True)
    for name, fault in (("t left in f32", "t"), ("1 / z applied to the score tile", "z"),
                        ("c taken from p and dp rounded to bf16", "c")):
        report(f"K3's plain version with {name}", "K3 bf16",
               read_backward(torch.bfloat16, backward_plain_with(fault)), False, va.grad_agrees)
    report("K4's plain version with the normalised k left unrounded", "K4 bf16",
           read_window(torch.bfloat16, plain_k_unrounded)[0], False)
    report("K2: q-scale constant not rounded to bf16", "K2 bf16",
           read_attention(lambda s, dtype: s * va.LOG2E), False)
    report("K8's plain version with the LN output left unrounded", "K8 bf16",
           read_ln(torch.bfloat16, plain_unrounded=True)[1], False)
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, (file, *subs)) in enumerate(SOURCE_FAULTS.items()):
            directory = Path(tmp) / f"fault{i}"
            shutil.copytree(REAL_CSRC, directory)
            text = (directory / file).read_text()
            for old, new in zip(subs[0::2], subs[1::2]):
                if text.count(old) < 1:
                    raise SystemExit(f"chip_faults: {file} does not hold {old!r}")
                text = text.replace(old, new)  # every occurrence: the f32 and bf16 kernels
            (directory / file).write_text(text)
            use_sources(directory)
            if name.startswith("K2"):
                report(name, "K2 bf16", read_attention(), False)
                continue
            if name.startswith("K3"):
                report(name, "K3 bf16", read_backward(torch.bfloat16), False, va.grad_agrees)
                if "rounded" not in name:  # faults of rounding do not show in f32
                    report(name, "K3 float32", read_backward(torch.float32), False,
                           va.grad_agrees)
                if "scale missing" in name:
                    report_slice(name, False)
                continue
            if name.startswith("K1'"):
                report(name, "K1'", read_select(), False)
                continue
            if name.startswith("K10"):
                for dtype in (torch.bfloat16, torch.float32):
                    report(name, f"K10 {str(dtype)[6:]}", read_tail_bwd(dtype), False,
                           va.grad_agrees)
                continue
            if name.startswith(("K4", "K6")):
                b4, b6 = read_window(torch.bfloat16)
                f4, f6 = read_window(torch.float32)
                rounding = "rounded" in name  # faults of rounding do not show in f32
                if "K4" in name:
                    report(name, "K4 bf16", b4, False)
                    if not rounding:
                        report(name, "K4 float32", f4, False)
                if "K6" in name:
                    report(name, "K6 bf16", b6, False)
                    if not rounding:
                        report(name, "K6 float32", f6, False)
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
