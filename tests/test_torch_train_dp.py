"""Data-parallel and FSDP training (``cli.train --use-mesh [--fsdp]``,
xmir_tpu_torch/parallel/data_parallel.py) at a world of 2 ranks (gloo,
spawned: tests/torch_mesh_workers.py) against a world of 1, on a narrow
DenseNet121 (BatchNorm) and a narrow DINOv2 (K7 / K2 / K3 through their
plain versions, under XMIR_FLASH_ATTN=1 XMIR_FUSED_LN=1; no LayerScale, so
that random weights give embeddings apart and the losses are well
conditioned), one epoch of 6 steps.

Bounds: the first step's loss within 1e-5 of world 1's, and its two group
norms (before the clip) within 1e-5 relative, which a gradient ``world``
times too large breaks; the parameters at the end within 1e-3 by
mean distance over mean movement (the cli.train convention, chip_smoke.py);
BatchNorm's running buffers equal on both ranks; the per-rank resident bytes
of the sharded leaves' master weights and both moments half of world 1's;
the world-2 --fsdp checkpoint loads strictly at world 1 and resumes there."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from torch_mesh_workers import run_world, train_worker
from xmir_tpu_torch.cli import train as train_cli
from xmir_tpu_torch.models import registry
from xmir_tpu_torch.parallel import fsdp_shard_axis
from xmir_tpu_torch.utils import checkpoint

NARROW_DENSENET = dict(growth_rate=8, block_config=(2, 2, 2, 2), num_init_features=16)
NARROW_DINO = dict(dim=128, depth=2, num_heads=2, img_size=56, use_layerscale=False)
SPECS = {"densenet121": (NARROW_DENSENET, 64), "dinov2": (NARROW_DINO, 56)}
ENV = {"XMIR_FLASH_ATTN": "1", "XMIR_FUSED_LN": "1"}
LOSS_TOL, NORM_RTOL, PARAM_TOL = 1e-5, 1e-5, 1e-3
RUNS = [("densenet121", ()), ("densenet121", ("--fsdp",)), ("dinov2", ()),
        ("dinov2", ("--fsdp",))]


def _argv(root, name, model, *extra):
    return ["--dataset", "synthetic", "--device", "cpu", "--model", model, "--embedding-dim",
            "16", "-p", "2", "-k", "4", "-j", "1", "--print-freq", "1", "--eval-freq", "1",
            "--ckpt-every", "1", "--lr", "1e-3", "--margin", "2.0", "--epochs", "1",
            "--save-dir", f"{root}/{name}", "--metrics-log", f"{root}/{name}.jsonl", *extra]


def _losses(path):
    with open(path) as f:
        return [json.loads(line)["loss"] for line in f if '"train"' in line]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """(world-1 records by model, world-2 records by (model, fsdp) and rank,
    the run directory)."""
    root = tmp_path_factory.mktemp("dp")
    one = run_world(train_worker, 1, root / "w1",
                    [_argv(root, f"w1_{m}", m) for m in ("densenet121", "dinov2")], SPECS, ENV)
    two = run_world(train_worker, 2, root / "w2",
                    [_argv(root, f"w2_{m}{'_fsdp' * bool(x)}", m, "--use-mesh", *x)
                     for m, x in RUNS], SPECS, ENV)
    world1 = dict(zip(("densenet121", "dinov2"), one[0]))
    world2 = {(m, bool(x)): [two[r][i] for r in range(2)] for i, (m, x) in enumerate(RUNS)}
    return world1, world2, root


@pytest.mark.parametrize("model,fsdp", [(m, bool(x)) for m, x in RUNS],
                         ids=[f"{m}{'-fsdp' * bool(x)}" for m, x in RUNS])
def test_world_of_two_trains_like_world_of_one(worlds, model, fsdp):
    world1, world2, root = worlds
    ref, (r0, r1) = world1[model], world2[(model, fsdp)]
    l1 = _losses(f"{root}/w1_{model}.jsonl")
    l2 = _losses(f"{root}/w2_{model}{'_fsdp' * fsdp}.jsonl")
    assert len(l1) == len(l2) == 6 and abs(l1[0] - l2[0]) <= LOSS_TOL, (l1, l2)
    assert len(r0["norms"]) == len(ref["norms"]) == 12  # 2 groups x 6 steps
    np.testing.assert_allclose(r0["norms"][:2], ref["norms"][:2], rtol=NORM_RTOL, atol=0)
    assert r0["norms"] == r1["norms"]  # both ranks clip alike
    a, b, start = r0["state"]["state_dict"], ref["state"]["state_dict"], ref["start"]
    assert a.keys() == b.keys()
    moved = torch.cat([(b[k] - start[k]).abs().flatten() for k in b if k in dict(
        ref["start"]) and b[k].is_floating_point()])
    apart = torch.cat([(a[k] - b[k]).abs().flatten() for k in b if b[k].is_floating_point()])
    assert (apart.mean() / moved.mean()).item() <= PARAM_TOL
    assert all(torch.equal(v, r1["buffers"][k]) for k, v in r0["buffers"].items())
    for k, v in r0["state"]["state_dict"].items():  # rank 1's whole state is rank 0's
        assert torch.equal(v, r1["state"]["state_dict"][k]), k
    if model == "densenet121":  # BatchNorm: the global batch's statistics, alike on each rank
        drift = max((r0["buffers"][k] - ref["buffers"][k]).abs().max().item()
                    for k in r0["buffers"] if k.endswith("running_var"))
        assert drift <= 1e-4


def test_fsdp_holds_half_the_state_per_rank(worlds):
    world1, world2, _ = worlds
    ref = world1["dinov2"]
    sd = ref["state"]["state_dict"]
    shapes = {k: v.shape for k, v in ref["start"].items()}
    sharded = [k for k, v in sd.items() if k in shapes and v.is_floating_point()
               and fsdp_shard_axis(v.shape, v.dtype, 2) is not None]
    assert sharded, "the narrow DINOv2 has no leaf the rule shards"
    # world 1 holds each such leaf's master weights and both moments whole (f32)
    whole = sum(3 * sd[k].numel() * 4 for k in sharded)
    for rank_rec in world2[("dinov2", True)]:
        assert rank_rec["bytes"] and all(b * 2 == whole for b in rank_rec["bytes"])
    assert all(b == 0 for rec in world2[("dinov2", False)] for b in rec["bytes"])


def test_fsdp_checkpoint_loads_strictly_at_world_one(worlds, tmp_path, monkeypatch):
    _, world2, root = worlds
    name = checkpoint.checkpoint_name("synthetic", "dinov2", 16, epoch=1)
    path = f"{root}/w2_dinov2_fsdp/{name}"
    tree = checkpoint.load_checkpoint(path, unwrap=False)
    from xmir_tpu_torch.models.embedders import DinoV2Embedder

    model = DinoV2Embedder(16, **NARROW_DINO)
    model.load_state_dict(tree["state_dict"], strict=True)
    params = list(model.parameters())
    for i, st in tree["optimizer"]["state"].items():  # moments in the world-1 layout
        assert st["mu"].shape == st["nu"].shape == params[i].shape
    assert tree["step"] == 6 and tree["epoch"] == 1
    for k, v in world2[("dinov2", True)][0]["state"]["state_dict"].items():
        assert torch.equal(v, tree["state_dict"][k])
    # and resumes at world 1 (no mesh), continuing at epoch 2
    for name_, (kwargs, size) in SPECS.items():
        monkeypatch.setitem(registry._SPECS, name_, dataclasses.replace(
            registry.get_spec(name_), kwargs=tuple(sorted(kwargs.items())), input_size=size,
            resize_size=size))
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    log = str(tmp_path / "resumed.jsonl")
    # a later --epochs / --metrics-log overrides _argv's
    train_cli.main(_argv(tmp_path, "resumed", "dinov2", "--resume", path, "--epochs", "2",
                         "--metrics-log", log))
    with open(log) as f:
        epochs = {json.loads(line)["epoch"] for line in f if '"train"' in line}
    assert epochs == {2}


def test_fsdp_without_use_mesh_raises():
    with pytest.raises(SystemExit, match="requires --use-mesh"):
        train_cli.main(["--dataset", "synthetic", "--device", "cpu", "--fsdp"])
