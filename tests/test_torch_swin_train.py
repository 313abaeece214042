"""SwinV2 training in the port against the JAX package: three train steps of
a narrow SwinV2 embedder (embed 16, depths (2, 2, 2), window 4, at 32 and 64
px: shifted, unshifted and clamped windows) in both stacks from the same
weights on the same batches, on the eager path and through the grouped-bias
attention's Function (K4's and K5's plain versions here; the JAX package's
kernel in interpret mode with XLA's vjp on the CPU); ``cli.train --model
swinv2`` with an exact ``--resume``; and the v1 kernel (K6), which has no
backward, kept out of training. Tier 1: CPU only. Tolerances as
tests/test_torch_train.py states them for DINOv2.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from test_torch_swin import _randomized, jax_interpret_kernels, narrow_swinv2  # noqa: F401
from test_torch_train import LABELS, LR, _cli, _compare_states, _images, _losses
from torch_parity_models import NARROW_SWIN, JaxNarrowSwin
from xmir_tpu.train import optim as jax_optim
from xmir_tpu.train import state as jax_state
from xmir_tpu.train import steps as jax_steps
from xmir_tpu_torch.cli import train as train_cli
from xmir_tpu_torch.models import convert
from xmir_tpu_torch.models import swin as swin_model
from xmir_tpu_torch.models.embedders import SwinV2Embedder
from xmir_tpu_torch.ops import vit_attn as va
from xmir_tpu_torch.train import TrainState, build_optimizer, make_embedding_train_step
from xmir_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

FLAGS = ("XMIR_FUSED_ATTN", "XMIR_SWIN_KERNEL")


def _swin_pair(size, seed=3):
    model = JaxNarrowSwin(embedding_dim=16)
    variables = _randomized(model.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3))),
                            seed)
    port = SwinV2Embedder(16, **NARROW_SWIN)
    port.load_state_dict(convert.swinv2_state_dict_from_jax(variables), strict=True)
    return model, dict(variables), port.train()


def _run_both(size, compute, steps=3):
    """``steps`` train steps in both stacks. Returns (JAX losses, port losses,
    JAX final state dict, port final state dict, port start state dict)."""
    model, variables, port = _swin_pair(size)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    tx = jax_optim.build_optimizer(variables["params"], lr=LR)
    jstate = jax_state.create_train_state(model, jax.random.PRNGKey(0), None, tx,
                                          variables=variables)
    state = TrainState(port, build_optimizer(port, lr=LR, backbone_prefixes=("backbone.",)))
    jstep = jax.jit(jax_steps.make_embedding_train_step(
        model, "triplet", {"margin": 0.2},
        compute_dtype=jnp.bfloat16 if compute == "bf16" else jnp.float32))
    step = make_embedding_train_step(
        port, "triplet", {"margin": 0.2},
        compute_dtype=torch.bfloat16 if compute == "bf16" else torch.float32)
    jl, tl = [], []
    for i in range(steps):
        x = _images(8, size, seed=10 + i)
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(LABELS))
        tm = step(state, torch.from_numpy(x), torch.from_numpy(LABELS))
        jl.append(float(jm["loss"]))
        tl.append(tm["loss"].item())
    want = convert.swinv2_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, {"params": jstate.params}))
    return jl, tl, want, port.state_dict(), start


@pytest.fixture
def swin_flags(monkeypatch, jax_interpret_kernels):  # noqa: F811
    for flag in FLAGS:
        monkeypatch.delenv(flag, raising=False)
    return monkeypatch


def _count_bwd(monkeypatch):
    calls = []
    real = va.biased_attention_bwd

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(va, "biased_attention_bwd", counted)
    return calls


@pytest.mark.parametrize("size", [32, 64])
@pytest.mark.parametrize("path", ["eager", "K4 + K5"])
def test_three_train_steps_match_jax_f32(swin_flags, size, path):
    """Losses of the three steps within 1e-5, the parameters after the third
    as ``_compare_states`` holds them; under XMIR_FUSED_ATTN=1 every block's
    backward goes through K5's plain version (six blocks a step)."""
    swin_flags.setenv("XMIR_FUSED_ATTN", "1" if path != "eager" else "0")
    calls = _count_bwd(swin_flags)
    jl, tl, want, got, start = _run_both(size, "f32")
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    assert _compare_states(want, got, start) > 1e-5
    assert len(calls) == (18 if path != "eager" else 0)


@pytest.mark.parametrize("path", ["eager", "K4 + K5"])
def test_three_train_steps_bf16_as_close_to_f32_as_jax(swin_flags, path):
    """bf16 compute on f32 master weights at 64 px: each loss within 2e-2 of
    the JAX package's bf16 run, and the port's bf16 losses no further from its
    own f32 run than 1.25 x the JAX bf16 run is from JAX f32 (plus 2e-3)."""
    swin_flags.setenv("XMIR_FUSED_ATTN", "1" if path != "eager" else "0")
    jl16, tl16, _, got16, _ = _run_both(64, "bf16")
    jl32, tl32, _, _, _ = _run_both(64, "f32")
    np.testing.assert_allclose(tl16, jl16, atol=2e-2, rtol=0)
    ours = np.abs(np.array(tl16) - np.array(tl32)).max()
    theirs = np.abs(np.array(jl16) - np.array(jl32)).max()
    assert ours <= 1.25 * theirs + 2e-3, (ours, theirs)
    assert all(v.dtype == torch.float32 for v in got16.values())


def test_v1_kernel_stays_out_of_training(swin_flags):
    """Under XMIR_SWIN_KERNEL=v1 a Swin in training mode takes the grouped-bias
    call (K4 + K5) and not the v1 kernel (K6, inference only), as the JAX
    package's ``and not train``; in eval mode it takes K6."""
    swin_flags.setenv("XMIR_FUSED_ATTN", "1")
    swin_flags.setenv("XMIR_SWIN_KERNEL", "v1")
    calls = {"K4": 0, "K6": 0}
    real4, real6 = swin_model.biased_attention_fused, swin_model.window_attention_fused

    def k4(*a, **k):
        calls["K4"] += 1
        return real4(*a, **k)

    def k6(*a, **k):
        calls["K6"] += 1
        return real6(*a, **k)

    swin_flags.setattr(swin_model, "biased_attention_fused", k4)
    swin_flags.setattr(swin_model, "window_attention_fused", k6)
    port = _swin_pair(32)[2]
    x = torch.from_numpy(_images(2, 32, seed=1))
    out = port.train()(x)["embedding"]
    out.sum().backward()
    assert calls == {"K4": 6, "K6": 0}
    assert all(p.grad is not None for p in port.parameters())
    with torch.inference_mode():
        port.eval()(x)
    assert calls == {"K4": 6, "K6": 6}


def test_cli_train_swinv2_resume_is_exact(tmp_path, swin_flags, narrow_swinv2):  # noqa: F811
    """``cli.train --model swinv2 --bf16`` under XMIR_FUSED_ATTN=1 (K4 + K5's
    plain versions on the CPU): two epochs in one run against one epoch, then
    --resume of its checkpoint for the second: the second epoch's losses and
    the final tensors are bit-equal."""
    swin_flags.setenv("XMIR_FUSED_ATTN", "1")
    calls = _count_bwd(swin_flags)
    whole, first, second = (str(tmp_path / d) for d in ("whole", "first", "second"))
    log_w, log_1, log_2 = (str(tmp_path / f"{n}.jsonl") for n in ("w", "1", "2"))
    args = _cli(tmp_path, "swinv2", "--bf16")
    train_cli.main(args + ["--epochs", "2", "--save-dir", whole, "--metrics-log", log_w,
                           "--ckpt-every", "1"])
    train_cli.main(args + ["--epochs", "1", "--save-dir", first, "--metrics-log", log_1,
                           "--ckpt-every", "1"])
    name = checkpoint.checkpoint_name("synthetic", "swinv2", 16, epoch=1)
    train_cli.main(args + ["--epochs", "2", "--save-dir", second, "--metrics-log", log_2,
                           "--ckpt-every", "1", "--resume", f"{first}/{name}"])
    lw, l1, l2 = _losses(log_w), _losses(log_1), _losses(log_2)
    assert len(lw) >= 4 and all(np.isfinite(v) for _, _, v in lw)
    assert lw[:len(l1)] == l1 and lw[len(l1):] == l2 and l2[0][0] == 2
    assert len(calls) == 6 * (len(lw) + len(l1) + len(l2))
    last = checkpoint.checkpoint_name("synthetic", "swinv2", 16, epoch=2)
    a = checkpoint.load_checkpoint(f"{whole}/{last}", unwrap=False)
    b = checkpoint.load_checkpoint(f"{second}/{last}", unwrap=False)
    for key, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][key]), key
    start = checkpoint.load_checkpoint(f"{first}/{name}")
    assert any(not torch.equal(v, start[k]) for k, v in a["state_dict"].items())


def test_training_after_inference_mode(swin_flags):
    """The model's cached constants (coordinate table, offsets, shift masks)
    are made outside inference mode even when an inference-mode forward
    makes them first, so a train step after it saves them for its backward
    (``cli.train``'s in-training evaluation, or any evaluation, before a
    step)."""
    port = SwinV2Embedder(16, generator=torch.Generator().manual_seed(5), **NARROW_SWIN)
    x = torch.from_numpy(_images(2, 32, seed=2))
    with torch.inference_mode():
        port.eval()(x)
    port.train()(x)["embedding"].square().sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in port.parameters())
