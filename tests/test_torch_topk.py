"""The port's top-k (K1 wrapper, metric transforms, plain tiled top-k, scores)
against the JAX package on the same numpy inputs.

The JAX side runs the Pallas kernel in interpret mode, once with each TPU body
(algorithm="pruned" for k <= 128 and "merge"), at small tiles so several
gallery tiles and query blocks are crossed. The port side runs on the CPU,
where the wrapper takes its plain PyTorch version; the CUDA kernel itself is
held against that plain version on the card (test_kernel_matches_plain_on_card
and chip_smoke.py).

Above k = 1024 (K1', csrc/topk_select.cu on the card) the JAX side is its XLA
path, ``tiled_topk`` and ``full_ranking``: its interpret-mode merge kernel
unrolls k passes per tile and is too slow there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from torch_parity import assert_topk_match
from xmir_tpu.ops import topk as jax_topk
from xmir_tpu.ops import topk_pallas as jax_pallas
from xmir_tpu.ops.distance import scores as jax_scores
from xmir_tpu_torch.ops import _build
from xmir_tpu_torch.ops import topk as port_topk
from xmir_tpu_torch.ops.distance import scores as port_scores
from xmir_tpu_torch.ops.topk_fused import fused_topk, fused_topk_masked
from xmir_tpu_torch.index import ShardedGalleryIndex
from xmir_tpu_torch.ops.topk_kernels import (
    F32_SCORE_C,
    FUSED_K,
    ROUTE_FUSED,
    ROUTE_SELECT,
    f32_score_error,
    fused_topk_scores,
    launch_plan,
    select_topk_scores,
    topk_scores_reference,
)

torch.set_num_threads(1)

Q, N, D = 9, 300, 24
METRICS = ("cosine", "ip", "l2", "hamming")
# (TPU body, k): the pruned body takes k <= 128, the merge body any k
BODIES = [("pruned", 1), ("pruned", 10), ("pruned", 128),
          ("merge", 1), ("merge", 10), ("merge", 128), ("merge", 129)]


def _inputs(kind: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    if kind == "int":
        # small integers: every dot product is exact in any summation order;
        # planted duplicates tie inside a tile, across the 128-row tile
        # boundary and at the ragged end
        q = rng.integers(-3, 4, (Q, D)).astype(np.float32)
        g = rng.integers(-3, 4, (N, D)).astype(np.float32)
        g[[5, 127, 128, 200, N - 1]] = g[3]
        q[0] = g[3]
    else:
        q = rng.standard_normal((Q, D)).astype(np.float32)
        g = rng.standard_normal((N, D)).astype(np.float32)
    return q, g


def _true_scores(q, g, metric, valid_count=N):
    q64, g64 = q.astype(np.float64), g.astype(np.float64)
    if metric == "cosine":
        s = (q64 / np.linalg.norm(q64, axis=1, keepdims=True)) @ (
            g64 / np.linalg.norm(g64, axis=1, keepdims=True)).T
    elif metric == "ip":
        s = q64 @ g64.T
    elif metric == "l2":
        s = -np.linalg.norm(q64[:, None] - g64[None], axis=-1)
    else:
        sq, sg = np.where(q >= 0, 1.0, -1.0), np.where(g >= 0, 1.0, -1.0)
        s = -(q.shape[1] - sq @ sg.T) / 2.0
    s[:, valid_count:] = -np.inf
    return s


def _jax_fused(q, g, k, metric, algorithm, valid_count=N):
    v, i = jax_pallas.fused_topk_masked(
        jnp.asarray(q), jnp.asarray(g), k, valid_count, metric, tile_q=8, tile_g=128,
        interpret=True, algorithm=algorithm, precision="highest",
    )
    return np.asarray(v), np.asarray(i)


@pytest.mark.parametrize("kind", ["int", "random"])
@pytest.mark.parametrize("algorithm,k", BODIES)
@pytest.mark.parametrize("metric", METRICS)
def test_fused_topk_matches_jax_kernel(metric, algorithm, k, kind):
    q, g = _inputs(kind)
    ref_v, ref_i = _jax_fused(q, g, k, metric, algorithm)
    v, i = fused_topk(torch.from_numpy(q), torch.from_numpy(g), k, metric)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    if kind == "int" and metric != "cosine":
        # exact arithmetic on both sides (cosine normalises to non-integers)
        np.testing.assert_array_equal(v.numpy(), ref_v)
        np.testing.assert_array_equal(i.numpy(), ref_i)
    else:
        assert_topk_match(v, i, ref_v, ref_i, _true_scores(q, g, metric), atol=1e-5)


@pytest.mark.parametrize("algorithm", ["pruned", "merge"])
@pytest.mark.parametrize("metric", METRICS)
def test_valid_count_below_k(metric, algorithm):
    """Rows >= valid_count never appear; slots past them are (-inf, 0)."""
    q, g = _inputs("int", seed=1)
    ref_v, ref_i = _jax_fused(q, g, 10, metric, algorithm, valid_count=4)
    v, i = fused_topk_masked(torch.from_numpy(q), torch.from_numpy(g), 10, 4, metric)
    assert np.isneginf(v.numpy()[:, 4:]).all() and (i.numpy()[:, 4:] == 0).all()
    assert_topk_match(v, i, ref_v, ref_i, _true_scores(q, g, metric, valid_count=4),
                      atol=1e-5)


def test_all_equal_scores_take_lowest_rows():
    g = np.ones((N, D), np.float32)
    q = np.ones((2, D), np.float32)
    ref_v, ref_i = _jax_fused(q, g, 129, "ip", "merge")
    v, i = fused_topk(torch.from_numpy(q), torch.from_numpy(g), 129, "ip")
    np.testing.assert_array_equal(i.numpy(), ref_i)
    np.testing.assert_array_equal(i.numpy(), np.tile(np.arange(129), (2, 1)))
    np.testing.assert_array_equal(v.numpy(), ref_v)


def test_bf16_inputs_accumulate_in_f32():
    q, g = _inputs("int")
    bias = torch.zeros(N)
    v, i = fused_topk_scores(torch.from_numpy(q).bfloat16(), torch.from_numpy(g).bfloat16(),
                             bias, 10)
    rv, ri = fused_topk_scores(torch.from_numpy(q), torch.from_numpy(g), bias, 10)
    np.testing.assert_array_equal(v.numpy(), rv.numpy())  # small ints are exact in bf16
    np.testing.assert_array_equal(i.numpy(), ri.numpy())


def test_reference_reports_zero_index_in_neg_inf_slots():
    """The stable sort alone would report the first masked row's index."""
    q = torch.ones((1, 4))
    g = torch.ones((6, 4))
    bias = torch.tensor([0.0, float("-inf"), 1.0, float("-inf"), float("-inf"), float("-inf")])
    v, i = topk_scores_reference(q, g, bias, 4)
    assert v[0, :2].tolist() == [5.0, 4.0] and i[0, :2].tolist() == [2, 0]
    assert np.isneginf(v[0, 2:].numpy()).all() and i[0, 2:].tolist() == [0, 0]


@pytest.mark.parametrize("k,match", [(0, "at least 1"), (1025, None), (N + 1, "gallery size")])
def test_k_out_of_range_raises(k, match):
    """k < 1 and k > N raise; k = 1025, which the kernel of k <= 1024 used to
    refuse, is served."""
    g = torch.zeros((max(N, 1100), D))
    if match == "gallery size":
        g = torch.zeros((N, D))
    if match is None:
        v, i = fused_topk_scores(torch.zeros((2, D)), g, torch.zeros(g.shape[0]), k)
        assert v.shape == i.shape == (2, k) and i[0].tolist() == list(range(k))
        return
    with pytest.raises(ValueError, match=match):
        fused_topk_scores(torch.zeros((2, D)), g, torch.zeros(g.shape[0]), k)


def test_wrapper_rejects_mixed_inputs():
    q, g, b = torch.zeros((2, D)), torch.zeros((N, D)), torch.zeros(N)
    with pytest.raises(TypeError):
        fused_topk_scores(q.double(), g.double(), b, 3)
    with pytest.raises(TypeError):
        fused_topk_scores(q, g, b.double(), 3)
    with pytest.raises(ValueError):
        fused_topk_scores(q, g, torch.zeros(N + 1), 3)
    with pytest.raises(ValueError):
        fused_topk_scores(q, g.to("meta"), b, 3)


def test_cpu_path_does_not_count_launches():
    before = fused_topk_scores.launches
    q, g = _inputs("random")
    for metric in METRICS:
        fused_topk(torch.from_numpy(q), torch.from_numpy(g), 10, metric)
    assert fused_topk_scores.launches == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build()


@pytest.mark.cuda
@pytest.mark.parametrize("n_queries,n_rows,k", [
    (1024, 100_000, 10), (1024, 100_000, 1024), (1, 100_000, 10), (9, 300, 129),
    (70, 4099, 10), (5, 1, 1), (3, 129, 1), (100_000, 500, 10), (64, 256, 10),
    (16, 100_000, 128), (1024, 100_000, 33),
])
def test_split_plan_covers_gallery(n_queries, n_rows, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the launch plan is made in csrc/topk.cu")
    for dtype, tile in ((torch.float32, 128), (torch.bfloat16, 256)):
        plan = launch_plan(n_queries, n_rows, k, 132, 1024, dtype)
        assert plan.route == (ROUTE_FUSED if k <= FUSED_K else ROUTE_SELECT)
        assert plan.tile_rows == tile and plan.depth == 1024
        # two consumer warpgroups (128 queries a block) above 64 queries
        assert plan.block_queries == (128 if n_queries > 64 else 64) == 64 * plan.wgs
        assert 1 <= plan.n_splits <= 160 and plan.rows_per_split % tile == 0
        assert (plan.n_splits - 1) * plan.rows_per_split < n_rows <= plan.n_splits * plan.rows_per_split
        q_blocks = -(-n_queries // plan.block_queries)
        assert q_blocks * plan.n_splits <= max(132, q_blocks)  # one wave of one block per SM
        assert 2 <= plan.stages <= 8 and plan.smem <= 232448
        if (n_queries, n_rows, k) == (1024, 100_000, 10):
            assert (plan.n_splits, q_blocks) == (16, 8)  # 128 of 132 SMs busy
        if n_queries <= 64 and n_rows == 100_000:  # a split per SM at small Q
            assert plan.n_splits >= 128


@pytest.mark.cuda
def test_plan_pads_depths_the_copy_engine_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the launch plan is made in csrc/topk.cu")
    for d, f32, bf16 in ((1024, 1024, 1024), (97, 100, 104), (100, 100, 104), (8, 8, 8)):
        assert launch_plan(70, 4099, 10, 132, d, torch.float32).depth == f32
        assert launch_plan(70, 4099, 10, 132, d, torch.bfloat16).depth == bf16


@pytest.mark.cuda
def test_plan_rejects_sizes_the_kernel_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the launch plan is made in csrc/topk.cu")
    for sizes in ((0, 10, 1), (4, 3, 10), (4, 10, 0)):
        with pytest.raises(ValueError, match="no top-k launch plan"):
            launch_plan(*sizes, 132, 64, torch.float32)
    with pytest.raises(TypeError):
        launch_plan(4, 10, 1, 132, 64, torch.float16)


@pytest.mark.parametrize("metric", METRICS)
def test_scores_match_jax(metric):
    q, g = _inputs("random")
    ref = np.asarray(jax_scores(jnp.asarray(q), jnp.asarray(g), metric, precision="highest"))
    out = port_scores(torch.from_numpy(q), torch.from_numpy(g), metric).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("valid_count", [None, 250])
@pytest.mark.parametrize("metric", METRICS)
def test_tiled_topk_matches_jax(metric, valid_count):
    q, g = _inputs("random", seed=2)
    ref_v, ref_i = jax_topk.tiled_topk(jnp.asarray(q), jnp.asarray(g), 10, tile=128,
                                      metric=metric, valid_count=valid_count,
                                      precision="highest")
    v, i = port_topk.tiled_topk(torch.from_numpy(q), torch.from_numpy(g), 10, tile=128,
                                metric=metric, valid_count=valid_count)
    vc = N if valid_count is None else valid_count
    assert_topk_match(v, i, ref_v, ref_i, _true_scores(q, g, metric, vc), atol=1e-5)


def test_tiled_topk_ties_match_fused():
    q, g = _inputs("int")
    v, i = port_topk.tiled_topk(torch.from_numpy(q), torch.from_numpy(g), 20, tile=128,
                                metric="ip")
    fv, fi = fused_topk(torch.from_numpy(q), torch.from_numpy(g), 20, "ip")
    assert torch.equal(v, fv) and torch.equal(i, fi)


def test_full_ranking_matches_jax():
    q, g = _inputs("int")
    ref_s, ref_r = jax_topk.full_ranking(jnp.asarray(q), jnp.asarray(g), "ip",
                                         precision="highest")
    s, r = port_topk.full_ranking(torch.from_numpy(q), torch.from_numpy(g), "ip")
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))
    np.testing.assert_array_equal(r.numpy(), np.asarray(ref_r))


BIG_N = 2100  # above 2048, so that k = 2048 is not the whole gallery


def _big_inputs(kind, seed=5):
    rng = np.random.default_rng(seed)
    if kind == "int":
        q = rng.integers(-3, 4, (5, D)).astype(np.float32)
        g = rng.integers(-3, 4, (BIG_N, D)).astype(np.float32)
        g[[5, 1023, 1024, 2047, 2048, BIG_N - 1]] = g[3]  # ties across every boundary
        q[0] = g[3]
    else:
        q = rng.standard_normal((5, D)).astype(np.float32)
        g = rng.standard_normal((BIG_N, D)).astype(np.float32)
    return q, g


@pytest.mark.parametrize("kind", ["int", "random"])
@pytest.mark.parametrize("k", [1025, 2048, BIG_N])
@pytest.mark.parametrize("metric", METRICS)
def test_fused_topk_above_1024_matches_jax(metric, k, kind):
    """k in {1025, 2048, N} against the JAX package's tiled_topk: ids and tie
    order equal on integer-valued inputs, all four metrics."""
    q, g = _big_inputs(kind)
    ref_v, ref_i = jax_topk.tiled_topk(jnp.asarray(q), jnp.asarray(g), k, tile=512, metric=metric,
                                      precision="highest")
    v, i = fused_topk(torch.from_numpy(q), torch.from_numpy(g), k, metric)
    assert v.shape == i.shape == (5, k) and k > 1024
    if kind == "int" and metric != "cosine":
        np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
        # l2 reports a square root, which the two stacks round an ulp apart
        np.testing.assert_allclose(v.numpy(), np.asarray(ref_v),
                                   rtol=1e-6 if metric == "l2" else 0, atol=0)
    else:
        true = _true_scores(q, g, metric, valid_count=BIG_N)
        assert_topk_match(v, i, np.asarray(ref_v), np.asarray(ref_i), true, atol=1e-5)


@pytest.mark.parametrize("metric", ["ip", "hamming"])
def test_full_ranking_through_fused_topk_matches_jax(metric):
    """k = N is the whole ranking: the JAX package's full_ranking order."""
    q, g = _big_inputs("int")
    _, ref_r = jax_topk.full_ranking(jnp.asarray(q), jnp.asarray(g), metric, precision="highest")
    _, i = fused_topk(torch.from_numpy(q), torch.from_numpy(g), BIG_N, metric)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_r))
    _, r = port_topk.full_ranking(torch.from_numpy(q), torch.from_numpy(g), metric)
    np.testing.assert_array_equal(i.numpy(), r.numpy())


@pytest.mark.parametrize("k", [1025, 2048, BIG_N])
def test_index_search_above_1024(k):
    """ShardedGalleryIndex.search needs no branch of its own for large k."""
    q, g = _big_inputs("random", seed=6)
    idx = ShardedGalleryIndex(D, metric="ip")
    idx.add(g, np.arange(BIG_N) % 3, [str(n) for n in range(BIG_N)])
    idx.build("cpu")
    v, i = idx.search(torch.from_numpy(q), k)
    order = np.argsort(-(q.astype(np.float64) @ g.astype(np.float64).T), axis=1, kind="stable")
    assert_topk_match(v, i, np.take_along_axis(q @ g.T, order[:, :k], 1), order[:, :k],
                      q.astype(np.float64) @ g.astype(np.float64).T, atol=1e-5)
    hits = idx.search_with_metadata(q[:1], k)
    assert len(hits[0]) == k and hits[0][0]["image_path"] == str(hits[0][0]["id"])


def test_select_kernel_wrapper_takes_cuda_tensors_only():
    q, g = _big_inputs("int")
    q, g = torch.from_numpy(q), torch.from_numpy(g)
    before = select_topk_scores.launches
    vals = torch.empty((5, 1025))
    idxs = torch.empty((5, 1025), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        select_topk_scores(q, g, torch.zeros(BIG_N), 1025, 132, q.shape[1], vals, idxs)
    with pytest.raises(ValueError, match="gallery size"):
        fused_topk_scores(q, g, torch.zeros(BIG_N), BIG_N + 1)
    fused_topk(q, g, 1025, "ip")  # CPU: the plain version
    assert select_topk_scores.launches == before


def test_exclude_self_topk_matches_jax():
    rng = np.random.default_rng(3)
    vals = -np.sort(-rng.standard_normal((4, 6)).astype(np.float32), axis=1)
    idxs = rng.permutation(40)[:24].reshape(4, 6).astype(np.int32)
    qids = np.array([idxs[0, 0], idxs[1, 3], -1, idxs[3, 5]], np.int32)
    ref_v, ref_i = jax_topk.exclude_self_topk(jnp.asarray(vals), jnp.asarray(idxs), qids, 5)
    v, i = port_topk.exclude_self_topk(torch.from_numpy(vals), torch.from_numpy(idxs),
                                       torch.from_numpy(qids), 5)
    np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.integers(-3, 4, (70, 96)).astype(np.float32)).to("cuda", dtype)
    g = torch.from_numpy(rng.integers(-3, 4, (4099, 96)).astype(np.float32)).to("cuda", dtype)
    g[[5, 2048, 4098]] = g[3].clone()
    bias = torch.zeros(4099, device="cuda")
    bias[4000:] = float("-inf")
    for k in (1, 10, 128, 129, 1024):
        before = (fused_topk_scores.launches, select_topk_scores.launches)
        v, i = fused_topk_scores(q, g, bias, k)
        torch.cuda.synchronize()
        assert (fused_topk_scores.launches, select_topk_scores.launches) == _counted(before, k)
        rv, ri = topk_scores_reference(q, g, bias, k)
        assert torch.equal(v, rv) and torch.equal(i, ri)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_select_kernel_matches_plain_on_card(dtype):
    """K1' on integer inputs with ties across tiles and masked rows: values
    and ids bit-equal to the plain version, one count per call, and the
    first 1024 entries equal to K1's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.integers(-3, 4, (70, 96)).astype(np.float32)).to("cuda", dtype)
    g = torch.from_numpy(rng.integers(-3, 4, (4099, 96)).astype(np.float32)).to("cuda", dtype)
    g[[5, 63, 64, 2048, 4098]] = g[3].clone()
    bias = torch.zeros(4099, device="cuda")
    bias[4000:] = float("-inf")
    k1_v, k1_i = fused_topk_scores(q, g, bias, 1024)
    for k in (1025, 2048, 4096, 4099):
        before = (select_topk_scores.launches, fused_topk_scores.launches)
        v, i = fused_topk_scores(q, g, bias, k)
        torch.cuda.synchronize()
        assert (select_topk_scores.launches, fused_topk_scores.launches) == (
            before[0] + 1, before[1])
        rv, ri = topk_scores_reference(q, g, bias, k)
        assert torch.equal(v, rv) and torch.equal(i, ri)
        assert torch.equal(v[:, :1024], k1_v) and torch.equal(i[:, :1024], k1_i)


@pytest.mark.cuda
def test_select_kernel_walks_queries_in_chunks(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from xmir_tpu_torch.ops import topk_kernels

    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((37, 64)).astype(np.float32)).cuda()
    g = torch.from_numpy(rng.standard_normal((3000, 64)).astype(np.float32)).cuda()
    bias = torch.zeros(3000, device="cuda")
    whole = fused_topk_scores(q, g, bias, 1500)
    monkeypatch.setattr(topk_kernels, "SCRATCH_BYTES", 8 * (3000 + 2048) * 5)  # five queries
    before = select_topk_scores.launches
    parts = fused_topk_scores(q, g, bias, 1500)
    assert select_topk_scores.launches == before + 1  # one count a call, whatever its chunks
    assert torch.equal(whole[0], parts[0]) and torch.equal(whole[1], parts[1])
    monkeypatch.setattr(topk_kernels, "SCRATCH_BYTES", 100)
    with pytest.raises(ValueError, match="SCRATCH_BYTES"):
        fused_topk_scores(q, g, bias, 1500)


# --- the f32 score bound (3xTF32) ---------------------------------------------


def _tf32(x):
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _tf32_read(x):
    """What a TF32 product reads of an f32 value: its 13 low bits cleared."""
    return (x.astype(np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _emulated_scores(q, g, arith):
    """q . g^T summed over depth in ascending order into one f32 accumulator,
    as IEEE f32 products or as 1, 2 or 3 TF32 products per f32 product, the
    kernel's split (big: what the product reads of x, small: rna(x - big));
    the products of TF32 values are exact in f32."""
    qb, gb = _tf32_read(q), _tf32_read(g)
    qs, gs = _tf32(q - qb), _tf32(g - gb)
    terms = {"ieee": [(q, g)], "3xtf32": [(qb, gb), (qb, gs), (qs, gb)],
             "2xtf32": [(qb, gb), (qb, gs)], "1xtf32": [(qb, gb)]}[arith]
    acc = np.zeros((q.shape[0], g.shape[0]), np.float32)
    for d in range(q.shape[1]):
        for a, b in terms:
            acc = acc + (a[:, d:d + 1] * b[None, :, d]).astype(np.float32)
    return acc


@pytest.mark.parametrize("arith,inside", [("ieee", True), ("3xtf32", True), ("2xtf32", False),
                                          ("1xtf32", False)])
def test_f32_bound_sits_between_3xtf32_and_2xtf32(arith, inside):
    """On full-mantissa rows (random normal, D = 1024) the top-10 scores of
    IEEE f32 and of 3xTF32 sums lie inside f32_score_error's bound with room
    to spare, those of 2xTF32 (small . big dropped) and 1xTF32 outside it."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((8, 1024)).astype(np.float32)
    g = rng.standard_normal((96, 1024)).astype(np.float32)
    bias = rng.standard_normal(96).astype(np.float32)
    s = _emulated_scores(q, g, arith) + bias
    ids = np.argsort(-s, axis=1, kind="stable")[:, :10]
    reading = f32_score_error(torch.from_numpy(q), torch.from_numpy(g), torch.from_numpy(bias),
                              torch.from_numpy(np.take_along_axis(s, ids, 1)),
                              torch.from_numpy(ids.astype(np.int32)))
    if inside:
        assert reading["of_bound"] <= 0.25, reading
    else:
        assert reading["of_bound"] > 2, reading


def test_f32_score_error_matches_numpy():
    """f32_score_error against the same ratio computed with numpy in float64,
    -inf slots (a masked row) counting as agreement."""
    rng = np.random.default_rng(12)
    q = rng.standard_normal((5, 40)).astype(np.float32)
    g = rng.standard_normal((30, 40)).astype(np.float32)
    bias = rng.standard_normal(30).astype(np.float32)
    bias[7] = -np.inf
    ids = rng.integers(0, 30, (5, 6)).astype(np.int32)
    ids[0, 0] = 7
    exact = np.einsum("qd,qkd->qk", q.astype(np.float64), g.astype(np.float64)[ids]) + bias[ids]
    vals = (exact + rng.standard_normal(exact.shape) * 1e-6).astype(np.float32)
    vals[0, 0] = -np.inf
    reading = f32_score_error(torch.from_numpy(q), torch.from_numpy(g), torch.from_numpy(bias),
                              torch.from_numpy(vals), torch.from_numpy(ids))
    absdot = np.einsum("qd,qkd->qk", np.abs(q.astype(np.float64)),
                       np.abs(g.astype(np.float64)[ids]))
    b = np.where(np.isinf(bias[ids]), 0.0, np.abs(bias[ids].astype(np.float64)))
    bound = 2.0 ** -22 * (F32_SCORE_C * absdot + 2 * b)
    with np.errstate(invalid="ignore"):  # -inf - -inf in the masked slot
        err = np.where(np.isneginf(vals) & np.isneginf(exact), 0.0, np.abs(vals - exact))
    np.testing.assert_allclose(reading["of_bound"], (err / bound).max(), rtol=1e-12)
    np.testing.assert_allclose(reading["max_abs_err"], err.max(), rtol=1e-12)


def test_python_constants_mirror_the_cuda_plan():
    """The wrapper's route constants are the CUDA plan's (csrc/topk_scores.cuh)."""
    import re
    from pathlib import Path

    src = (Path(_build.CSRC_DIR) / "topk_scores.cuh").read_text()
    const = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kFusedMaxK"] == FUSED_K
    routes = re.search(r"enum Route \{ kRouteFused = (\d), kRouteSelect = (\d) \}", src)
    assert (int(routes[1]), int(routes[2])) == (ROUTE_FUSED, ROUTE_SELECT)


@pytest.mark.parametrize("k", [FUSED_K, FUSED_K + 1, 1024])
def test_every_route_on_the_cpu_is_the_plain_version(k):
    """On the CPU no route launches anything: k at the fused route's edge,
    the select route's first k and a k in its range."""
    q, g = _big_inputs("int")
    before = (fused_topk_scores.launches, select_topk_scores.launches)
    v, i = fused_topk_scores(torch.from_numpy(q), torch.from_numpy(g), torch.zeros(BIG_N), k)
    rv, ri = topk_scores_reference(torch.from_numpy(q), torch.from_numpy(g), torch.zeros(BIG_N), k)
    assert torch.equal(v, rv) and torch.equal(i, ri)
    assert (fused_topk_scores.launches, select_topk_scores.launches) == before


# --- on the card ----------------------------------------------------------------


def _counted(before, k):
    """(K1, K1') launch counts after one CUDA call at k from ``before``: the
    fused route (k <= FUSED_K) counts in K1, the select route in K1'."""
    fused, select = before
    return (fused + 1, select) if k <= FUSED_K else (fused, select + 1)


def _card_inputs(rng, q_n, n, d, dtype, kind):
    if kind == "int":
        q = rng.integers(-3, 4, (q_n, d)).astype(np.float32)
        g = rng.integers(-3, 4, (n, d)).astype(np.float32)
        dup = [r for r in (3, 5, 127, 128, 255, 256, 2048, n - 1) if r < n]
        g[dup] = g[3]
        q[0] = g[3]
    else:  # unit rows, as the index holds them
        q = rng.standard_normal((q_n, d))
        g = rng.standard_normal((n, d))
        q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
        g = (g / np.linalg.norm(g, axis=1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(q).to("cuda", dtype), torch.from_numpy(g).to("cuda", dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 10, FUSED_K, FUSED_K + 1, 128, 129, 1024])
@pytest.mark.parametrize("n_queries", [1, 16, 64, 1024])
def test_every_route_matches_plain_on_card(n_queries, k, dtype):
    """Each (Q, k) at D of 32, 96, 1024 and 97 (padded for the copy engine):
    bit-equal to the plain version on integer inputs with ties at tile edges
    and masked rows; random unit rows within 1e-5 / 1e-2 and ids equal away
    from near-ties (gap 1e-5, chip_smoke.py's); one launch a call, counted by
    its route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(20 + k)
    n = 4099
    bias = torch.zeros(n, device="cuda")
    bias[4000:] = float("-inf")
    for d in (32, 96, 1024, 97):
        q, g = _card_inputs(rng, n_queries, n, d, dtype, "int")
        before = (fused_topk_scores.launches, select_topk_scores.launches)
        v, i = fused_topk_scores(q, g, bias, k)
        torch.cuda.synchronize()
        assert (fused_topk_scores.launches, select_topk_scores.launches) == _counted(before, k)
        rv, ri = topk_scores_reference(q, g, bias, k)
        assert torch.equal(v, rv) and torch.equal(i, ri), (d, "int")
        q, g = _card_inputs(rng, n_queries, n, d, dtype, "random")
        v, i = fused_topk_scores(q, g, bias, k)
        rv, ri = topk_scores_reference(q, g, bias, k + 1)
        # near-ties: ids may differ only where the exact ranking's gap is tiny
        gaps = torch.minimum(rv[:, :k] - rv[:, 1:k + 1],
                             torch.cat([torch.full_like(rv[:, :1], float("inf")),
                                        rv[:, :k - 1] - rv[:, 1:k]], dim=1))
        fin = torch.isfinite(rv[:, :k])
        atol = 1e-5 if dtype == torch.float32 else 1e-2
        assert ((v - rv[:, :k]).abs() <= atol)[fin].all(), (d, "values")
        assert ((i == ri[:, :k]) | (gaps.nan_to_num(float("inf")) <= 1e-5) | ~fin).all(), (d, "ids")


@pytest.mark.cuda
def test_full_mantissa_f32_within_the_bound_on_card():
    """Random normal f32 rows (full mantissas, not unit): every top-k score
    within f32_score_error's bound of the float64 score, at the fused route
    (k = 10), the select route (128, 500) and K1' (2048)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(30)
    q = torch.from_numpy(rng.standard_normal((200, 1024)).astype(np.float32)).cuda()
    g = torch.from_numpy(rng.standard_normal((5000, 1024)).astype(np.float32)).cuda()
    bias = torch.from_numpy(rng.standard_normal(5000).astype(np.float32)).cuda()
    for k in (10, 128, 500, 2048):
        v, i = fused_topk_scores(q, g, bias, k)
        reading = f32_score_error(q, g, bias, v, i)
        assert reading["of_bound"] <= 1, (k, reading)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_select_equals_fused_on_random_rows_on_card(dtype):
    """One score producer: K1''s first entries equal K1's at k = 10 (the
    fused route), 128 and 1024 (the select route) bit for bit, and two runs
    of each are bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(31)
    q, g = _card_inputs(rng, 300, 9000, 1024, dtype, "random")
    bias = torch.from_numpy(rng.standard_normal(9000).astype(np.float32) * 0.01).cuda()
    v, i = fused_topk_scores(q, g, bias, 2048)
    assert torch.equal(v, fused_topk_scores(q, g, bias, 2048)[0])
    for k in (10, 128, 1024):
        v1, i1 = fused_topk_scores(q, g, bias, k)
        v2, i2 = fused_topk_scores(q, g, bias, k)
        assert torch.equal(v1, v2) and torch.equal(i1, i2)
        assert torch.equal(v1, v[:, :k]) and torch.equal(i1, i[:, :k]), k
