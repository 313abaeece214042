"""The port's sharded gallery (xmir_tpu_torch/index/gallery.py) against the
JAX ``ShardedGalleryIndex.build(mesh)`` on the JAX conftest's 8 devices: the
port's per-shard bodies (``make_local_shard_search``) run for shard ids 0-7
in one process and merged (``merge_shard_candidates``), and a spawned world
of 3 (gloo) searches through ``search``. On small-integer inputs ids and
values are bit-equal, tie order included; on random unit rows ids are equal
except at near-ties (a gap below 1e-5 in the exact ranking) and values
within 1e-6. Cases: the four metrics, uneven shards and shards with no valid
row, k above a shard's rows, exclude_ids, the sharded full ranking, and
duplicate rows planted across every shard boundary."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from torch_mesh_workers import index_worker, run_world
from xmir_tpu.index.gallery import ShardedGalleryIndex as JaxIndex
from xmir_tpu.parallel import mesh as jax_mesh
from xmir_tpu_torch.index.gallery import (
    ShardedGalleryIndex,
    make_local_shard_search,
    merge_shard_candidates,
    shard_layout,
)
from xmir_tpu_torch.ops.topk import exclude_self_topk
from xmir_tpu_torch.parallel import Mesh

METRICS = ("cosine", "ip", "l2", "hamming")
TIE_GAP, VAL_TOL = 1e-5, 1e-6


def _int_rows(rng, n, d):
    return rng.integers(-3, 4, (n, d)).astype(np.float32)


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _planted(rng, n, d, world, integer):
    """Rows with a duplicate of a neighbour at each shard boundary of the
    world's layout (the last row of a shard equal to the next shard's
    first), and one of them also copied into every query."""
    g = (_int_rows if integer else _unit_rows)(rng, n, d)
    shard, _ = shard_layout(n, world)
    for b in range(shard, n, shard):
        g[b] = g[b - 1]
    q = (_int_rows if integer else _unit_rows)(rng, 5, d)
    q[0] = g[shard - 1]
    return g, q


def jax_search(g, q, k, metric, exclude=None, devices=8):
    mesh = jax_mesh.make_mesh((devices,), axis_names=(jax_mesh.DATA_AXIS,),
                              devices=jax.devices()[:devices])
    idx = JaxIndex(g.shape[1], metric=metric)
    idx.add(g)
    idx.build(mesh)
    v, i = idx.search(q, k, exclude_ids=exclude)
    s, r = idx.full_ranking(q)
    return (np.asarray(v), np.asarray(i)), (np.asarray(s), np.asarray(r)), idx.info()


def port_per_shard(g, q, k, metric, exclude=None, world=8):
    """The port's per-shard bodies at every shard id, then the merge: what
    a world of ``world`` ranks computes, in one process."""
    shards = [ShardedGalleryIndex(g.shape[1], metric=metric) for _ in range(world)]
    for r, idx in enumerate(shards):
        idx.add(g)
        idx.build(mesh=Mesh(world=world, rank=r, device=torch.device("cpu")))
    qq, kmetric = shards[0]._query_side(q)
    fetch = min(k + 1 if exclude is not None else k, g.shape[0])
    body = make_local_shard_search(fetch, shards[0]._shard_rows, g.shape[0], kmetric,
                                   torch.float32)
    cands = [body(qq, idx._device_embeds, r) for r, idx in enumerate(shards)]
    v, i = merge_shard_candidates(torch.stack([c[0] for c in cands]),
                                  torch.stack([c[1] for c in cands]), fetch)
    v = shards[0]._value_side(v)
    if exclude is not None:
        v, i = exclude_self_topk(v, i, exclude, k)
    return v.numpy(), i.numpy()


def assert_same(got, want, exact):
    (v, i), (wv, wi) = got, want
    assert v.shape == wv.shape and i.shape == wi.shape
    if exact:
        np.testing.assert_array_equal(v, wv)
        np.testing.assert_array_equal(i, wi)
        return
    np.testing.assert_allclose(v, wv, atol=VAL_TOL, rtol=0)
    for row_v, row_i, want_i in zip(wv, i, wi):
        for pos in np.nonzero(row_i != want_i)[0]:
            near = [abs(row_v[pos] - row_v[p]) < TIE_GAP
                    for p in (pos - 1, pos + 1) if 0 <= p < len(row_v)]
            assert any(near), f"ids differ at {pos} with no near-tie: {row_i} {want_i}"


def ties_go_to_lower_ids(v, i):
    for row_v, row_i in zip(v, i):
        for a in range(len(row_v) - 1):
            if row_v[a] == row_v[a + 1]:
                assert row_i[a] < row_i[a + 1], (row_v, row_i)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n,k", [(1000, 10), (1000, 200), (300, 40), (9, 9)],
                         ids=["uneven", "k-above-shard", "empty-shards", "tiny"])
def test_per_shard_bodies_equal_jax_mesh(metric, n, k):
    rng = np.random.default_rng(n + k)
    integer = metric != "cosine"
    g = (_int_rows if integer else _unit_rows)(rng, n, 16)
    q = (_int_rows if integer else _unit_rows)(rng, 7, 16)
    (want, _, info) = jax_search(g, q, k, metric)
    got = port_per_shard(g, q, k, metric)
    assert_same(got, want, exact=integer)
    ties_go_to_lower_ids(*got)
    assert info["sharding"] == {"devices": 8, "rows_per_shard": shard_layout(n, 8)[0]}


@pytest.mark.parametrize("integer", [True, False], ids=["integer", "unit"])
def test_exclude_ids_and_planted_duplicates(integer):
    rng = np.random.default_rng(5)
    g, q = _planted(rng, 1000, 16, 8, integer)
    metric = "ip" if integer else "cosine"
    for k, exclude, queries in ((12, None, q), (7, np.arange(5) * 128 + 127, g[127:1000:128][:5])):
        want, _, _ = jax_search(g, queries, k, metric, exclude)
        got = port_per_shard(g, queries, k, metric, exclude)
        assert_same(got, want, exact=integer)
        ties_go_to_lower_ids(*got)
    # query 0 is row 127's copy: rows 127 and 128 tie at the top, lower id first
    v, i = port_per_shard(g, q, 4, metric)
    assert list(i[0, :2]) == [127, 128] and v[0, 0] == v[0, 1]


def test_plain_merge_picks_the_lower_id():
    # two shards' top 3 with equal scores inside and across the blocks
    vals = torch.tensor([[[3.0, 2.0, 2.0]], [[3.0, 2.0, 1.0]]])
    idxs = torch.tensor([[[1, 0, 2]], [[4, 5, 6]]], dtype=torch.int32)
    v, i = merge_shard_candidates(vals, idxs, 3)
    assert v.tolist() == [[3.0, 3.0, 2.0]] and i.tolist() == [[1, 4, 0]]
    # a shard's padding slots (-inf, its base) never displace a real row
    vals = torch.tensor([[[5.0, 1.0, 0.0]], [[4.0, float("-inf"), float("-inf")]]])
    idxs = torch.tensor([[[0, 1, 2]], [[4, 4, 4]]], dtype=torch.int32)
    v, i = merge_shard_candidates(vals, idxs, 3)
    assert v.tolist() == [[5.0, 4.0, 1.0]] and i.tolist() == [[0, 4, 1]]


def test_world_of_three_searches_like_jax(tmp_path):
    """One spawned world of 3 ranks (gloo): every metric's search, exclude_ids,
    the sharded full ranking and info() against the JAX 8-device mesh, on
    every rank alike."""
    rng = np.random.default_rng(11)
    cases, wants = [], []
    for metric in METRICS:
        integer = metric != "cosine"
        g, q = _planted(rng, 500, 12, 3, integer)
        exclude = None
        if metric == "ip":
            q, exclude = g[:6], np.arange(6)
        k = 170 if metric == "l2" else 9  # 170 > a shard's 128 rows
        cases.append((metric, g, q, k, exclude))
        wants.append((jax_search(g, q, k, metric, exclude), integer))
    per_rank = run_world(index_worker, 3, tmp_path, cases)
    for rank_out in per_rank:
        for (search, ranking, info, local_rows), ((want, want_rank, _), integer) in zip(
                rank_out, wants):
            assert_same(tuple(t.numpy() for t in search), want, exact=integer)
            ties_go_to_lower_ids(*(t.numpy() for t in search))
            s, r = (t.numpy() for t in ranking)
            if integer:
                np.testing.assert_array_equal(s, want_rank[0])
                np.testing.assert_array_equal(r, want_rank[1])
            else:
                np.testing.assert_allclose(s, want_rank[0], atol=VAL_TOL, rtol=0)
            assert info["sharding"] == {"devices": 3, "rows_per_shard": 256}
            assert local_rows == 256  # each rank holds only its shard
    for a, b in zip(per_rank[0], per_rank[2]):
        assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
