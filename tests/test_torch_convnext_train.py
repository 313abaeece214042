"""ConvNeXtV2 training in the port against the JAX package: three train steps
of a narrow ConvNeXtV2 and of its SRA and PCAM embedders in both stacks (f32,
bf16, and f32 through the fused block and its backward), PCAM's training
outputs, and ``cli.train --model convnextv2{,_sra,_pcam}`` on the CPU."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xmir_tpu.ops.convnext_block_pallas as jax_cbp
from test_torch_train import LABELS, LR, _compare_states, _images, _losses, _records
from torch_parity_models import NARROW_CONVNEXT, JaxNarrowConvNeXt, randomized
from xmir_tpu.train import optim as jax_optim
from xmir_tpu.train import state as jax_state
from xmir_tpu.train import steps as jax_steps
from xmir_tpu_torch.cli import train as train_cli
from xmir_tpu_torch.models import convnext as port_convnext
from xmir_tpu_torch.models import registry
from xmir_tpu_torch.models.convert import convnextv2_state_dict_from_jax
from xmir_tpu_torch.models.embedders import (
    ConvNeXtV2Embedder,
    ConvNeXtV2PCAMEmbedder,
    ConvNeXtV2SRAEmbedder,
)
from xmir_tpu_torch.ops import convnext_block as cb
from xmir_tpu_torch.train import TrainState, build_optimizer, make_embedding_train_step
from xmir_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

EMBEDDERS = {"plain": (ConvNeXtV2Embedder, dict(embedding_dim=16)),
             "sra": (ConvNeXtV2SRAEmbedder, dict(num_heads=4, lam=0.3)),
             "pcam": (ConvNeXtV2PCAMEmbedder, dict(num_classes=3, lam=0.3, embedding_dim=16))}
SIZE = 64


def _pair(kind, seed=3):
    """(JAX model, randomised variables, the port's model in training mode
    with the same weights)."""
    cls, kw = EMBEDDERS[kind]
    model = JaxNarrowConvNeXt(kind=kind, **kw)
    variables = randomized(model.init(jax.random.PRNGKey(seed), jnp.zeros((1, SIZE, SIZE, 3))),
                           seed=seed + 1)
    port = cls(**kw, **NARROW_CONVNEXT)
    port.load_state_dict(convnextv2_state_dict_from_jax(variables), strict=True)
    return model, dict(variables), port.train()


@pytest.fixture
def fused_training(monkeypatch):
    """Both stacks' blocks through the fused block in training: XMIR_FUSED_MLP=1,
    the train gate forced open (64 px leaves every stage under 2048 rows),
    the JAX block's Pallas calls in interpret mode."""
    monkeypatch.setenv("XMIR_FUSED_MLP", "1")
    monkeypatch.setattr(jax_cbp, "fused_train_wins", lambda r, c, c4: True)
    monkeypatch.setattr(port_convnext, "fused_train_wins", lambda r, c, c4: True)
    real = jax_cbp.convnext_block_fused

    def interp(*args, **kw):
        kw["interpret"] = True
        return real(*args, **kw)

    monkeypatch.setattr(jax_cbp, "convnext_block_fused", interp)
    calls = []
    real_bwd = cb.convnext_tail_bwd

    def spy(*args):
        calls.append(True)
        return real_bwd(*args)

    monkeypatch.setattr(cb, "convnext_tail_bwd", spy)
    return calls


def _run_both(kind, compute, steps=3):
    """``steps`` train steps in both stacks from the same weights on the same
    batches. Returns (JAX losses, port losses, JAX final state dict, port
    final state dict, the port's starting state dict)."""
    model, variables, port = _pair(kind)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    tx = jax_optim.build_optimizer(variables["params"], lr=LR)
    jstate = jax_state.create_train_state(model, jax.random.PRNGKey(0), None, tx,
                                          variables=variables)
    state = TrainState(port, build_optimizer(port, lr=LR, backbone_prefixes=("convnext.",)))
    jstep = jax.jit(jax_steps.make_embedding_train_step(
        model, "triplet", {"margin": 0.2},
        compute_dtype=jnp.bfloat16 if compute == "bf16" else jnp.float32))
    step = make_embedding_train_step(
        port, "triplet", {"margin": 0.2},
        compute_dtype=torch.bfloat16 if compute == "bf16" else torch.float32)
    jl, tl = [], []
    for i in range(steps):
        x = _images(8, SIZE, seed=20 + i)
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(LABELS))
        tm = step(state, torch.from_numpy(x), torch.from_numpy(LABELS))
        jl.append(float(jm["loss"]))
        tl.append(tm["loss"].item())
    want = convnextv2_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, {"params": jstate.params}))
    return jl, tl, want, port.state_dict(), start


@pytest.mark.parametrize("kind", list(EMBEDDERS))
def test_three_train_steps_match_jax_f32(kind):
    """Losses of the three steps within 1e-5; the parameters after the third
    as test_torch_train.py's _compare_states holds DINOv2's."""
    jl, tl, want, got, start = _run_both(kind, "f32")
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    assert _compare_states(want, got, start) > 1e-6  # the parameters did move


def test_three_train_steps_through_the_fused_block_match_jax(fused_training):
    """The same through the fused block in both stacks (the JAX custom_vjp
    with its Pallas tail backward in interpret mode; the port's Function with
    K10's plain version): every block's backward went through K10's
    wrapper, and losses and parameters agree as above."""
    jl, tl, want, got, start = _run_both("plain", "f32")
    assert len(fused_training) == 3 * 4  # three steps, four blocks
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    assert _compare_states(want, got, start) > 1e-6


def _embeddings(kind, dtype):
    """Both stacks' training-mode embeddings of one batch with the weights
    cast to ``dtype``, as the train step casts them: (JAX, port)."""
    from torch.func import functional_call
    from xmir_tpu.train.steps import _cast_floating

    model, variables, port = _pair(kind)
    x = _images(8, SIZE, seed=20)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = model.apply({"params": _cast_floating(variables["params"], jdt)}, jnp.asarray(x, jdt),
                      train=True)["embedding"]
    tensors = {n: p.to(dtype) for n, p in port.named_parameters()}
    with torch.no_grad():
        out = functional_call(port, tensors, (torch.from_numpy(x).to(dtype),))["embedding"]
    return np.asarray(ref, np.float32), out.float().numpy()


@pytest.mark.parametrize("kind", list(EMBEDDERS))
def test_three_train_steps_bf16_as_close_to_f32_as_jax(kind):
    """bf16 compute on f32 master weights: each of the three losses within
    2e-2 of the JAX package's bf16 run, and the port's bf16 embeddings no
    further from its own f32 ones than 1.25 x the JAX bf16 embeddings are
    from JAX f32, plus 1e-3 (three triplet losses are too few to compare
    the two stacks' bf16 error by: on the plain model one lies 5.7e-4 from
    JAX f32, the port's 3.6e-3 from its own f32, with embeddings 6.05e-3 and
    6.12e-3 from theirs)."""
    jl16, tl16, _, got16, _ = _run_both(kind, "bf16")
    np.testing.assert_allclose(tl16, jl16, atol=2e-2, rtol=0)
    assert all(v.dtype == torch.float32 for v in got16.values())
    (j16, t16), (j32, t32) = _embeddings(kind, torch.bfloat16), _embeddings(kind, torch.float32)
    ours, theirs = np.abs(t16 - t32).max(), np.abs(j16 - j32).max()
    assert ours <= 1.25 * theirs + 1e-3, (ours, theirs)


def test_pcam_returns_class_logits_and_maps_in_training():
    """In training mode the PCAM embedder also returns class_logits (B, K)
    and pcam_maps (B, H, W, K), as the JAX module does with train=True (f32,
    1e-4); in eval mode neither."""
    model, variables, port = _pair("pcam", seed=5)
    x = _images(3, SIZE, seed=6)
    ref = model.apply(variables, jnp.asarray(x), train=True)
    out = port(torch.from_numpy(x))
    assert out["class_logits"].shape == (3, 3) and out["pcam_maps"].shape == (3, 2, 2, 3)
    for key in ("embedding", "class_logits", "pcam_maps"):
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(ref[key]), rtol=1e-4,
                                   atol=1e-4)
    with torch.no_grad():
        assert set(port.eval()(torch.from_numpy(x))) == {"embedding", "features"}


# --- cli.train -----------------------------------------------------------------------


@pytest.fixture
def narrow_convnext_models(monkeypatch):
    """--model convnextv2{,_sra,_pcam} at narrow widths and 64 px (the CLI
    path is the same; full width runs on the card, in chip_smoke.py)."""
    for name in ("convnextv2", "convnextv2_sra", "convnextv2_pcam"):
        spec = dataclasses.replace(registry.get_spec(name),
                                   kwargs=tuple(sorted(NARROW_CONVNEXT.items())),
                                   input_size=SIZE, resize_size=SIZE)
        monkeypatch.setitem(registry._SPECS, name, spec)
    monkeypatch.delenv("XMIR_FUSED_MLP", raising=False)
    return monkeypatch


def _cli(tmp_path, model, *extra):
    return ["--dataset", "synthetic", "--device", "cpu", "--model", model, "--embedding-dim",
            "16", "-p", "2", "-k", "4", "-j", "2", "--print-freq", "1", "--eval-freq", "1",
            "--lr", "1e-3", "--ckpt-every", "1", "--sra-num-heads", "4",
            # on unit embeddings a margin of 2 keeps every triplet active
            "--margin", "2.0", *extra]


@pytest.mark.parametrize("model", ["convnextv2", "convnextv2_sra", "convnextv2_pcam"])
def test_cli_train_convnextv2_models(tmp_path, narrow_convnext_models, model):
    """cli.train --model convnextv2{,_sra,_pcam} trains (--bf16, the
    XMIR_FUSED_MLP=1 path with the train gate open, so the blocks run the
    Function and its backward): finite losses, an evaluation, every tensor
    of the checkpoint moved, and --resume of the first epoch's checkpoint
    continues the second bit for bit."""
    narrow_convnext_models.setenv("XMIR_FUSED_MLP", "1")
    narrow_convnext_models.setattr(port_convnext, "fused_train_wins", lambda r, c, c4: True)
    args = _cli(tmp_path, model, "--bf16")
    whole, first, second = (str(tmp_path / d) for d in ("whole", "first", "second"))
    log_w, log_2 = str(tmp_path / "w.jsonl"), str(tmp_path / "2.jsonl")
    train_cli.main(args + ["--epochs", "2", "--save-dir", whole, "--metrics-log", log_w])
    train_cli.main(args + ["--epochs", "1", "--save-dir", first])
    name = checkpoint.checkpoint_name("synthetic", model, 16, epoch=1)
    train_cli.main(args + ["--epochs", "2", "--save-dir", second, "--metrics-log", log_2,
                           "--resume", f"{first}/{name}"])
    lw, l2 = _losses(log_w), _losses(log_2)
    assert len(lw) >= 8 and all(np.isfinite(v) for _, _, v in lw)
    assert l2 and l2 == [x for x in lw if x[0] == 2]
    evals = [r for r in _records(log_w) if r["kind"] == "eval"]
    assert [r["epoch"] for r in evals] == [1, 2] and all(0 <= r["mAP"] <= 100 for r in evals)
    last = checkpoint.checkpoint_name("synthetic", model, 16, epoch=2)
    a = checkpoint.load_checkpoint(f"{whole}/{last}")
    b = checkpoint.load_checkpoint(f"{second}/{last}")
    assert all(torch.equal(v, b[key]) for key, v in a.items())
    # the SRA embedder's width is fixed (--embedding-dim names the file only)
    fresh, _ = registry.create_model(
        model, generator=torch.Generator().manual_seed(0),
        **({"num_heads": 4, "lam": 0.1} if model == "convnextv2_sra" else {"embedding_dim": 16}))
    still = [key for key, v in a.items() if torch.equal(v, fresh.state_dict()[key])]
    assert not still, still


def test_cli_train_sets_tf32_off(tmp_path, narrow_convnext_models):
    """cli.train sets both TF32 switches off explicitly, whatever they were."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        train_cli.main(_cli(tmp_path, "convnextv2") + ["--epochs", "1", "--save-dir",
                                                       str(tmp_path / "ck")])
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True


def test_cli_train_names_the_roadmap_items_of_what_waits():
    """Nothing waits any more: no model for its kernel (swinv2's, K5,
    landed), not dual_branch (the NIH dual-head item landed), not --use-mesh,
    --fsdp or --cache-dir (ROADMAP.md section 1 items 10 and 11 landed). The
    CLI takes every flag of the JAX CLI with its default, and --device."""
    import xmir_tpu.cli.train as jax_train_cli

    assert not hasattr(train_cli, "WAITING_FOR_KERNEL")
    ours, theirs = vars(train_cli.parse_args([])), vars(jax_train_cli.parse_args([]))
    assert set(ours) == set(theirs) | {"device"}
    for flag, value in theirs.items():
        assert ours[flag] == value, flag
    assert "dual_branch" in train_cli.parse_args(["--loss-name", "dual_branch"]).loss_name
    assert "Not ported yet" not in train_cli.__doc__
