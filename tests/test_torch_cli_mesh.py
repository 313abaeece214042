"""The CLIs under --use-mesh at a world of 2 ranks (gloo, spawned:
tests/torch_mesh_workers.py) against a world of 1: ingest -> query (the
sharded index; the counterpart of tests/test_cli.py:58-80), cli.test,
compute_saliency and evaluate_saliency (SBSM's mask fan-out, the pairs'
fan-out), cli.train --cache-dir (the counterpart of tests/test_cli.py:252:
the cache is complete after the first epoch, written by both ranks, and the
runs that fill and read it train to the checkpoint of a run without it), and
--upload-originals (the stored URIs equal the JAX ``upload_originals``'s on
the same tree). Ids equal; similarities, embeddings, maps and AUCs within
1e-5 (a rank embeds half a batch, and the over-masks sum is reassociated)."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from torch_mesh_workers import cli_worker, run_world
from xmir_tpu.utils import objectstore as jax_objectstore
from xmir_tpu_torch.cli import test as test_cli
from xmir_tpu_torch.data.datasets import CovidxDataset
from xmir_tpu_torch.data.synthetic import write_synthetic_covidx
from xmir_tpu_torch.utils import checkpoint

TOL = 1e-5
SALIENCY = ["--window-size", "32", "--stride", "16", "--gpu-batch", "4", "--top-k", "2",
            "--limit", "2"]


def _common(root):
    """A COVIDx-format tree of 24 PNGs (the same manifest for every split):
    files to upload, and uneven shards at both worlds."""
    img_dir, manifest = write_synthetic_covidx(os.path.join(root, "tree"), n=24, size=64)
    return ["--dataset", "covid", "--dataset-dir", img_dir, "--train-image-list", manifest,
            "--test-image-list", manifest, "--device", "cpu", "--model", "tiny",
            "--embedding-dim", "16", "-j", "2"]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli_mesh"))
    common = _common(root)
    test_cli.main(common + ["--save-dir", os.path.join(root, "w1_ref", "res")])
    one = run_world(cli_worker, 1, os.path.join(root, "spawn1"), root, common, SALIENCY)[0]
    two = run_world(cli_worker, 2, os.path.join(root, "spawn2"), root, common, SALIENCY)
    return root, one, two


def test_ingest_query_and_test_match_world_one(worlds):
    root, one, two = worlds
    assert two[0]["hits"] == two[1]["hits"]
    for r1, r2 in zip(one["hits"], two[0]["hits"]):
        assert [h["id"] for h in r1["results"]] == [h["id"] for h in r2["results"]]
        for h1, h2 in zip(r1["results"], r2["results"]):
            assert abs(h1["similarity"] - h2["similarity"]) <= TOL
    with open(os.path.join(root, "w2", "h.json")) as f:  # rank 0 wrote it
        assert [[h["id"] for h in r["results"]] for r in json.load(f)] == [
            [h["id"] for h in r["results"]] for r in two[0]["hits"]]
    g1, g2 = (np.load(os.path.join(root, f"w{w}", "g.npz")) for w in (1, 2))
    np.testing.assert_allclose(g2["embeds"], g1["embeds"], atol=TOL, rtol=0)
    assert (g1["labels"] == g2["labels"]).all() and str(g1["meta"]) == str(g2["meta"])
    assert one["info"]["sharding"] == {"devices": 1, "rows_per_shard": 128}
    assert two[1]["info"]["sharding"] == {"devices": 2, "rows_per_shard": 128}
    for key, v in one["metrics"].items():
        if isinstance(v, float):
            assert abs(two[0]["metrics"][key] - v) <= 1e-4, key
    a1, a2 = (np.load(os.path.join(root, f"w{w}", "res", "evaluation_results.npz"))
              for w in (1, 2))
    np.testing.assert_allclose(a2["embeds"], a1["embeds"], atol=TOL, rtol=0)


def test_saliency_clis_match_world_one(worlds):
    root, one, two = worlds
    names = sorted(os.listdir(os.path.join(root, "w1", "maps")))
    assert len(names) == 4 and names == sorted(os.listdir(os.path.join(root, "w2", "maps")))
    for name in names:
        np.testing.assert_allclose(np.load(os.path.join(root, "w2", "maps", name)),
                                   np.load(os.path.join(root, "w1", "maps", name)),
                                   atol=TOL, rtol=0)
    s1, s2 = one["insdel"], two[0]["insdel"]
    assert (s1["summary"]["use_mesh"], s1["summary"]["mesh_devices"]) == (True, 1)
    assert (s2["summary"]["use_mesh"], s2["summary"]["mesh_devices"]) == (True, 2)
    assert s2["summary"]["index"]["sharding"]["devices"] == 2
    for r1, r2 in zip(s1["results"], s2["results"]):
        assert r1["retrieved"] == r2["retrieved"]
        np.testing.assert_allclose(r2["per_pair_del"] + r2["per_pair_ins"],
                                   r1["per_pair_del"] + r1["per_pair_ins"], atol=TOL, rtol=0)
    assert two[0]["insdel"] == two[1]["insdel"]


def test_cache_dir_write_through_at_two_ranks(worlds):
    root, one, two = worlds
    assert one["cache_complete_after_epoch_1"] and two[0]["cache_complete_after_epoch_1"]
    cache = os.path.join(root, "w2", "cache")
    with open(os.path.join(cache, "meta.json")) as f:
        meta = json.load(f)
    images = np.load(os.path.join(cache, "images.npy"))
    assert meta["n"] == images.shape[0] == 64 and images.any(axis=(1, 2, 3)).all()
    name = checkpoint.checkpoint_name("synthetic", "tiny", 16, seed=3, epoch=1)
    for w in (1, 2):
        ref = checkpoint.load_checkpoint(os.path.join(root, f"w{w}", "plain", name))
        for run in ("cached1", "cached2"):
            got = checkpoint.load_checkpoint(os.path.join(root, f"w{w}", run, name))
            assert all(torch.equal(v, got[k]) for k, v in ref.items()), (w, run)


def test_upload_originals_equal_jax(worlds, tmp_path):
    root, _, _ = worlds
    g = np.load(os.path.join(root, "w2", "g.npz"))
    tree = os.path.join(root, "tree")
    names = [str(n) for n in CovidxDataset(os.path.join(tree, "images"),
                                           os.path.join(tree, "manifest.txt")).image_names]
    store = os.path.join(root, "w2", "store")
    want = jax_objectstore.upload_originals(
        names, jax_objectstore.LocalDirStore(store), "original")
    assert [str(p) for p in g["paths"]] == want and all(p.startswith(store) for p in want)
    for stored, original in zip(want, names):
        with open(stored, "rb") as a, open(original, "rb") as b:
            assert a.read() == b.read()
