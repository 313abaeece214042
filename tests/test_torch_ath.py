"""The port's ATH deep hashing (ATHNet, the train step and cli.train_ath,
hash_retrieval_metrics and cli.test_ath, the Hamming ingest -> query path)
against the JAX package.

ATHNet runs at its full 256 px in both packages. In eval mode the last
ResBlock's single-channel map is mostly cut by its ReLU under init
statistics, so the tests raise that block's BatchNorm biases: the codes then
depend on every layer. Tolerances: the eval forward within 1e-5, the train
forward within 1e-4 (batch statistics of one channel); three train
steps' losses within 1e-5 (1 + |loss|), the parameters after them with at
most one element in 1,000 outside 1e-5 and the mean difference within 1% of
the mean movement (Adam's sign noise where a gradient is rounding noise; the
hash layer's bias, whose exact gradient is 0, left out);
Hamming metrics and the Hamming hits' ids exactly equal, L2 metrics within
1e-6.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_models import randomized
from xmir_tpu.analysis import hashing_eval as jax_hashing
from xmir_tpu.cli import train_ath as jax_train_ath
from xmir_tpu.models.embedders import ATHEmbedder as JaxATH
from xmir_tpu_torch.analysis import binarize_codes, hash_retrieval_metrics
from xmir_tpu_torch.cli import train_ath
from xmir_tpu_torch.cli.common import ath_num_classes
from xmir_tpu_torch.models.convert import ath_state_dict_from_jax, load_torch_checkpoint
from xmir_tpu_torch.models.embedders import ATHEmbedder
from xmir_tpu_torch.ops.distance import neg_hamming_scores

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
# in training the last block normalises its one channel by the batch's own
# statistics, which carry the two stacks' different summation orders into
# the codes: 1e-4, as the DenseNet and ResNet forwards
TRAIN_TOL = dict(rtol=1e-4, atol=1e-4)


def _images(n=4, size=256, seed=0):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def _jax_variables(num_classes=3, size=256, seed=0):
    """Random JAX ATHEmbedder weights and statistics; the last block's
    BatchNorm biases raised by 1 so that its ReLU passes most of the map."""
    model = JaxATH(48, num_classes, size)
    init = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((2, size, size, 3)))
    variables = randomized(init, seed=seed + 1)
    for bn in ("bn2", "down_bn"):
        variables["params"]["ath"]["dense"][bn]["bias"] = (
            variables["params"]["ath"]["dense"][bn]["bias"] + 1.0)
    return model, variables


def _port(variables, num_classes=3, size=256):
    port = ATHEmbedder(48, num_classes, size)
    port.load_state_dict(ath_state_dict_from_jax(variables), strict=True)
    return port


def test_ath_eval_matches_jax():
    model, variables = _jax_variables()
    port = _port(variables).eval()
    x = _images()
    ref = jax.jit(model.apply)(variables, jnp.asarray(x))
    seen = []
    port.ath.dense.register_forward_hook(lambda m, i, o: seen.append(o))
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert float((seen[0] > 0).float().mean()) > 0.5  # the codes see the whole net
    assert out["hash_codes"].shape == (4, 48) and out["logits"].shape == (4, 3)
    for key in ("embedding", "hash_codes", "logits"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), **TOL)


def test_ath_train_mode_matches_jax():
    """Training mode: batch statistics, and the running buffers of every
    BatchNorm moved as flax's (momentum 0.9, biased variance)."""
    model, variables = _jax_variables(seed=2)
    port = _port(variables).train()
    x = _images(n=6, seed=3)
    ref, updates = jax.jit(lambda v, x: model.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    for key in ("hash_codes", "logits"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), **TRAIN_TOL)
    moved = ath_state_dict_from_jax({"params": variables["params"],
                                     "batch_stats": updates["batch_stats"]})
    for key, value in port.state_dict().items():
        np.testing.assert_allclose(value.numpy(), moved[key].numpy(), **TOL)


def test_ath_input_size_must_divide_by_8():
    with pytest.raises(ValueError, match="divisible by 8"):
        ATHEmbedder(48, 3, 100)


def test_sample_triplets_match_jax():
    labels = np.random.default_rng(0).integers(0, 3, 50)
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):
        for got, want in zip(train_ath.sample_triplets(labels, 8, a),
                             jax_train_ath.sample_triplets(labels, 8, b)):
            np.testing.assert_array_equal(got, want)


def _to_jax(sd):
    """The port's ATHEmbedder state dict -> the JAX package's tree."""
    sd = {k: v.detach().numpy() for k, v in sd.items()}
    params, stats = {}, {}
    for block in ("block1", "block2", "dense"):
        bp, bs = {}, {}
        for conv, bn in (("conv1", "bn1"), ("conv2", "bn2"), ("down_conv", "down_bn")):
            pre = f"ath.{block}"
            bp[conv] = {"kernel": np.transpose(sd[f"{pre}.{conv}.weight"], (2, 3, 1, 0))}
            bp[bn] = {"scale": sd[f"{pre}.{bn}.weight"], "bias": sd[f"{pre}.{bn}.bias"]}
            bs[bn] = {"mean": sd[f"{pre}.{bn}.running_mean"], "var": sd[f"{pre}.{bn}.running_var"]}
        params[block], stats[block] = bp, bs
    params["sa"] = {"conv": {"kernel": np.transpose(sd["ath.sa.conv.weight"], (2, 3, 1, 0))}}
    for head in ("hashlayer", "typelayer"):
        params[head] = {"kernel": sd[f"ath.{head}.weight"].T, "bias": sd[f"ath.{head}.bias"]}
    return {"params": {"ath": params}, "batch_stats": {"ath": stats}}


def _jax_trajectory(variables, size, batch, steps, lr=1e-3, margin=0.5, ce_weight=1.0, seed=0):
    """The JAX CLI's step (xmir_tpu/cli/train_ath.py), its triplets and
    images, from ``variables``: (losses [(loss, hash, ce)], final tree)."""
    import optax

    from xmir_tpu.data import SyntheticImageDataset
    from xmir_tpu.data.pipeline import _decode_batch
    from xmir_tpu.data.transforms import normalize
    from xmir_tpu.losses import triplet_hash_loss
    from xmir_tpu.train import create_train_state

    model = JaxATH(48, 3, size)
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(lr))
    state = create_train_state(model, jax.random.PRNGKey(seed), None, tx, variables=variables)

    def step_fn(state, images, type_labels):
        def losses(params):
            vs = {"params": params, "batch_stats": state.batch_stats}
            out, updates = model.apply(vs, images, train=True, mutable=["batch_stats"])
            codes, logits = out["hash_codes"], out["logits"]
            hash_loss = triplet_hash_loss(codes[:batch], codes[batch:2 * batch],
                                          codes[2 * batch:], margin)
            ce = optax.softmax_cross_entropy_with_integer_labels(logits[:batch],
                                                                 type_labels).mean()
            return hash_loss + ce_weight * ce, (hash_loss, ce, updates["batch_stats"])

        (loss, (hl, ce, new_stats)), grads = jax.value_and_grad(losses, has_aux=True)(
            state.params)
        return state.apply_gradients(grads, new_stats), (loss, hl, ce)

    step_fn = jax.jit(step_fn)
    ds = SyntheticImageDataset(n=64, size=64, seed=0)
    labels = np.asarray(ds.labels)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        a, pos, neg = jax_train_ath.sample_triplets(labels, batch, rng)
        imgs, _, _ = _decode_batch(ds, np.concatenate([a, pos, neg]).tolist(), size)
        x = normalize(jnp.asarray(imgs), (0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
        state, reading = step_fn(state, x, jnp.asarray(labels[a]))
        out.append(tuple(float(v) for v in reading))
    return out, {"params": state.params, "batch_stats": state.batch_stats}


def test_train_ath_cli_three_steps_match_jax(tmp_path):
    """cli.train_ath on the CPU (64 px, batch 4: 12 images a step, three
    steps) against the JAX CLI's step from the same seeded weights on the
    same triplets: losses within 1e-5 (1 + |loss|), the trained tensors
    (BatchNorm statistics over all 3B images included) as the module
    docstring says; the saved .pt reads back strictly."""
    size, batch, steps = 64, 4, 3
    start = ATHEmbedder(48, 3, size, generator=torch.Generator().manual_seed(0)).state_dict()
    save = str(tmp_path / "ath.pt")
    run = train_ath.main(["--dataset", "synthetic", "--device", "cpu", "--image-size",
                          str(size), "--batch-size", str(batch), "--epochs", str(steps),
                          "--steps-per-epoch", "1", "-j", "1", "--save", save])
    want, final = _jax_trajectory(_to_jax(start), size, batch, steps)
    assert len(run["losses"]) == steps
    for got, ref in zip(run["losses"], want):
        for key, value in zip(("loss", "hash", "ce"), ref):
            assert abs(got[key] - value) <= 1e-5 * (1 + abs(value)), (key, got, ref)
    trained = ATHEmbedder(48, 3, size)
    load_torch_checkpoint(trained, save)
    got_sd, want_sd = trained.state_dict(), ath_state_dict_from_jax(jax.device_get(final))
    moved, apart = [], []
    # the hash layer's bias cancels in every code difference the triplet loss
    # sees, and the cross entropy does not reach it: its exact gradient is 0,
    # so both stacks' Adam steps on it are rounding noise
    for key in [k for k in want_sd if k != "ath.hashlayer.bias"]:
        w, g, s = (t[key].numpy().ravel() for t in (want_sd, got_sd, start))
        moved.append(np.abs(w - s))
        apart.append(np.abs(g - w))
    moved, apart = np.concatenate(moved), np.concatenate(apart)
    assert (apart > 1e-5).sum() <= 1e-3 * apart.size
    assert apart.mean() <= 0.01 * moved.mean(), (apart.mean(), moved.mean())
    assert ath_num_classes(save) == 3


def _codes(seed=0, q=24, n=60, bits=48):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((q, bits)).astype(np.float32), rng.integers(0, 3, q),
            rng.standard_normal((n, bits)).astype(np.float32), rng.integers(0, 3, n),
            rng.standard_normal((q, 3)).astype(np.float32))


def test_hash_retrieval_metrics_hamming_equal_jax():
    """At 48 bits and 60 rows the Hamming distances tie everywhere: the
    stable ranking and every metric equal the JAX package's exactly."""
    qc, ql, gc, gl, logits = _codes()
    kw = dict(topk_values=(1, 5, 10, 60), binary_codes=True)
    got = hash_retrieval_metrics(qc, ql, gc, gl, logits, device="cpu", **kw)
    assert got == jax_hashing.hash_retrieval_metrics(qc, ql, gc, gl, logits, **kw)


def test_hash_retrieval_metrics_l2_within_jax():
    qc, ql, gc, gl, logits = _codes(seed=1)
    got = hash_retrieval_metrics(qc, ql, gc, gl, logits, binary_codes=False, device="cpu")
    want = jax_hashing.hash_retrieval_metrics(qc, ql, gc, gl, logits, binary_codes=False)
    assert got["classification_acc"] == want["classification_acc"]
    for k, m in want["retrieval"].items():
        for key, value in m.items():
            assert got["retrieval"][k][key] == pytest.approx(value, abs=1e-6), (k, key)


def test_binarize_codes_matches_jax_and_does_not_compose_with_hamming():
    """binarize_codes gives {0, 1}; the Hamming scores binarise by >= 0
    again, so fed those codes every distance is 0 (the JAX package's
    behaviour, kept)."""
    qc, _, gc, _, _ = _codes(seed=2)
    np.testing.assert_array_equal(binarize_codes(qc), jax_hashing.binarize_codes(qc))
    scores = neg_hamming_scores(torch.from_numpy(binarize_codes(qc)),
                                torch.from_numpy(binarize_codes(gc)))
    assert torch.equal(scores, torch.zeros_like(scores))


@pytest.fixture(scope="module")
def ath_checkpoints(tmp_path_factory):
    """One set of 256 px weights as the JAX CLIs' .msgpack and the port's
    .pt (a plain state dict in the port's keys)."""
    from xmir_tpu.utils import save_checkpoint

    tmp = tmp_path_factory.mktemp("ath")
    _, variables = _jax_variables(seed=5)
    msgpack = str(tmp / "ath.msgpack")
    save_checkpoint(msgpack, jax.device_get(variables))
    pt = str(tmp / "ath.pt")
    torch.save(dict(ath_state_dict_from_jax(variables)), pt)
    return msgpack, pt


@pytest.mark.parametrize("binary", [True, False], ids=["hamming", "l2"])
def test_test_ath_cli_matches_jax(ath_checkpoints, binary):
    from xmir_tpu.cli import test_ath as jax_test_ath
    from xmir_tpu_torch.cli import test_ath

    msgpack, pt = ath_checkpoints
    common = ["--dataset", "synthetic", "--batch-size", "32"] + (
        ["--binary-codes"] if binary else [])
    want = jax_test_ath.main(common + ["--resume", msgpack])
    got = test_ath.main(common + ["--resume", pt, "--device", "cpu"])
    if binary:
        assert got == want
        return
    assert got["classification_acc"] == want["classification_acc"]
    for k, m in want["retrieval"].items():
        for key, value in m.items():
            assert got["retrieval"][k][key] == pytest.approx(value, abs=1e-6), (k, key)


def test_ath_hamming_ingest_query_matches_jax(ath_checkpoints, tmp_path):
    """cli.ingest --model ath --metric hamming -> cli.query: the port on the
    CPU from the .pt (a 3-class type head, which the registry's 5-class
    default would refuse strictly: the model takes the checkpoint's count)
    against the JAX CLIs from the .msgpack (its non-strict merge keeps the
    5-class head from init); the hits' ids and distances equal, ties in
    gallery order."""
    from xmir_tpu.cli import ingest as jax_ingest
    from xmir_tpu.cli import query as jax_query
    from xmir_tpu_torch.cli import ingest, query

    msgpack, pt = ath_checkpoints
    common = ["--dataset", "synthetic", "--model", "ath", "--batch-size", "32"]
    hits = {}
    for name, ing, qry, extra in (("jax", jax_ingest, jax_query, ["--resume", msgpack]),
                                  ("port", ingest, query, ["--resume", pt, "--device", "cpu"])):
        gal = str(tmp_path / f"g_{name}.npz")
        ing.main(common + extra + ["--split", "train", "--metric", "hamming", "--output", gal])
        out = str(tmp_path / f"h_{name}.json")
        qry.main(common + extra + ["--index", gal, "--top-k", "10", "--output", out])
        with open(out) as f:
            hits[name] = json.load(f)
    assert len(hits["port"]) == 32
    for got, want in zip(hits["port"], hits["jax"]):
        assert [(h["id"], h["distance"]) for h in got["results"]] == [
            (h["id"], h["distance"]) for h in want["results"]]
