"""ChestMIR two-stage lesion-aware retrieval evaluation
(reference ChestMIR/chestmir_eval.py:429-669; a copy of
xmir_tpu/chestmir/two_stage.py: numpy float64 on the host, so that rankings
stay bit-equal to the JAX package's).

Stage 1: global cosine ranking (sim = G @ G^T; ranks per query column).
Stage 2: rerank each query's top-K by
    w * global_cosine + (1 - w) * max-region-cosine for a chosen lesion,
with global-only fallback when the query or all candidates lack the lesion.
Lesion choice is either a specific lesion name or adaptive (the query's
most-detected target lesion, reference chestmir_eval.py:475-504).

Lesion maps: per image, {canonical lesion name: [unit region vectors]}.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .lesions import canonical_lesion_name


def similarity_to_ranks(sim: np.ndarray) -> np.ndarray:
    """(N, N) similarity -> (N, N) ranks, column i = db order for query i
    (self included; reference ranks with argsort(-sim, axis=0))."""
    return np.argsort(-sim, axis=0, kind="stable")


def build_lesion_map(regions: Sequence[dict]) -> Dict[str, List[np.ndarray]]:
    """regions: [{"label": str, "vector": (D,) array-like}, ...] -> canonical
    map of unit vectors."""
    out: Dict[str, List[np.ndarray]] = {}
    for r in regions:
        v = np.asarray(r["vector"], np.float64)
        n = np.linalg.norm(v)
        if n <= 0:
            continue
        out.setdefault(canonical_lesion_name(r["label"]), []).append(v / n)
    return out


def choose_query_lesion_vector(lesion_map, lesion_name: str):
    cands = lesion_map.get(canonical_lesion_name(lesion_name), [])
    return cands[0] if cands else None


def best_candidate_lesion_score(query_vec, candidate_lesions, lesion_name: str) -> float:
    cands = candidate_lesions.get(canonical_lesion_name(lesion_name), [])
    if not cands:
        return -1.0
    return max(float(np.dot(query_vec, c)) for c in cands)


def choose_query_adaptive_lesion_vector(lesion_map, target_lesions: Sequence[str]):
    """Most-detected target lesion for this query (reference 475-504):
    prefer the target lesion with the most regions; fall back to map order."""
    target_keys = [canonical_lesion_name(x) for x in target_lesions]
    best_name, best_vec, best_count = None, None, -1
    for key in target_keys:
        cands = lesion_map.get(key, [])
        if cands and len(cands) > best_count:
            best_count = len(cands)
            best_name, best_vec = key, cands[0]
    if best_name is not None:
        return best_name, best_vec
    tset = set(target_keys)
    for name, cands in lesion_map.items():
        if name in tset and cands:
            return name, cands[0]
    return None, None


def _rerank_one_query(
    i: int,
    base_sim: np.ndarray,
    base_rank: np.ndarray,
    lesion_maps,
    q_vec,
    lesion_name: str,
    rerank_topk: int,
    global_weight: float,
):
    n = base_sim.shape[0]
    topk = min(rerank_topk, n - 1)
    top_idx = base_rank[:topk]
    matched = 0
    combined: List[Tuple[int, float, float]] = []
    for j in top_idx:
        region_score = best_candidate_lesion_score(q_vec, lesion_maps[j], lesion_name)
        if region_score >= 0.0:
            matched += 1
        score = global_weight * float(base_sim[j, i]) + (1.0 - global_weight) * region_score
        combined.append((int(j), score, float(base_sim[j, i])))
    if matched == 0:
        return None, 0, topk
    combined.sort(key=lambda x: (x[1], x[2]), reverse=True)
    new_top = [x[0] for x in combined]
    in_top = np.zeros(n, dtype=bool)
    in_top[new_top] = True
    tail = [idx for idx in base_rank if not in_top[idx]]
    return np.asarray(new_top + tail, np.int64), matched, topk


def _region_bank(lesion_maps, key: str):
    """Pad every image's region vectors for one canonical lesion into a
    (N, L, D) tensor + per-image region counts — the batched form of the
    reference's per-candidate Python region lists."""
    counts = np.array([len(m.get(key, [])) for m in lesion_maps])
    l_max = int(counts.max(initial=0))
    if l_max == 0:
        return None
    d = next(
        len(m[key][0]) for m in lesion_maps if m.get(key)
    )
    pad = np.zeros((len(lesion_maps), l_max, d), np.float64)
    for j, m in enumerate(lesion_maps):
        for l, v in enumerate(m.get(key, [])):
            pad[j, l] = v
    return pad, counts


def _region_scores_topk(
    q_mat: np.ndarray, top_idx: np.ndarray, bank, chunk: int = 256
) -> np.ndarray:
    """max-region-cosine of query r against its own top-K candidates.

    q_mat (Nq, D), top_idx (Nq, K) gallery ids. One padded gather + einsum
    + masked max per query chunk replaces the reference's per-(query,
    candidate) Python loop over region lists (chestmir_eval.py:507-577's
    max(np.dot(...))), and only the K candidates that the rerank will look
    at are ever scored. Candidates without the lesion get the reference's
    -1.0 sentinel. Returns (Nq, K).
    """
    nq, k = top_idx.shape
    out = np.full((nq, k), -1.0)
    if bank is None:
        return out
    pad, counts = bank
    n, l_max, d = pad.shape
    # per-query flat ROW gather + one matvec: numpy's row gather is a
    # memcpy per 6KB vector, ~1000x faster than a 4-D advanced-index
    # gather of the same data (measured 0.23s vs 254s at N=3000, K=50)
    pad2 = pad.reshape(n * l_max, d)
    offs = np.arange(l_max)
    for i in range(nq):
        idx = top_idx[i]
        rows = (idx[:, None] * l_max + offs).reshape(-1)
        s = (pad2[rows] @ q_mat[i]).reshape(k, l_max)
        c = counts[idx]
        s[offs[None, :] >= c[:, None]] = -np.inf
        out[i] = np.where(c > 0, s.max(axis=1), -1.0)
    return out


def _rerank_one_query_scored(
    i: int,
    base_sim: np.ndarray,
    base_rank: np.ndarray,
    region_row: np.ndarray,
    rerank_topk: int,
    global_weight: float,
):
    """_rerank_one_query on a precomputed (topk,) region-score row aligned
    with base_rank[:topk]; identical semantics (matched counts scores >= 0;
    stable (score, base_sim) descending order; None when nothing in the
    top-K has the lesion)."""
    n = base_sim.shape[0]
    topk = min(rerank_topk, n - 1)
    top_idx = base_rank[:topk]
    rs = region_row[:topk]
    matched = int((rs >= 0.0).sum())
    if matched == 0:
        return None, 0, topk
    base = base_sim[top_idx, i].astype(np.float64)
    score = global_weight * base + (1.0 - global_weight) * rs
    # reference: stable sort desc by (score, base) — combined.sort(
    # key=..., reverse=True); lexsort on negated keys is the same order
    order = np.lexsort((-base, -score))
    new_top = top_idx[order]
    in_top = np.zeros(n, dtype=bool)
    in_top[new_top] = True
    tail = base_rank[~in_top[base_rank]]
    return np.concatenate([new_top, tail]).astype(np.int64), matched, topk


def rerank_with_specific_lesion(
    base_sim: np.ndarray,
    lesion_maps: Sequence[dict],
    lesion_name: str,
    rerank_topk: int = 50,
    global_weight: float = 0.7,
):
    """(reference chestmir_eval.py:507-577). Returns (ranks (N, N), stats)."""
    n = base_sim.shape[0]
    key = canonical_lesion_name(lesion_name)
    ranks_base = similarity_to_ranks(base_sim)
    ranks_new = np.empty_like(ranks_base)
    stats = _new_stats(lesion=lesion_name, rerank_topk=rerank_topk,
                       global_weight=global_weight, n=n)
    topk = min(rerank_topk, n - 1)
    # reuse the selection rule's result rather than re-deriving the vector
    # (keeps this path in lockstep with choose_query_lesion_vector if the
    # policy ever changes)
    q_vecs = {i: v for i in range(n)
              if (v := choose_query_lesion_vector(lesion_maps[i], key))
              is not None}
    q_rows = sorted(q_vecs)
    region = None
    if q_rows:
        q_mat = np.stack([q_vecs[i] for i in q_rows])
        region = _region_scores_topk(
            q_mat, ranks_base[:topk, q_rows].T, _region_bank(lesion_maps, key)
        )
    row_of = {i: r for r, i in enumerate(q_rows)}
    for i in range(n):
        base_rank = ranks_base[:, i]
        if i not in row_of:
            stats["queries_fallback_global"] += 1
            ranks_new[:, i] = base_rank
            continue
        new_rank, matched, topk = _rerank_one_query_scored(
            i, base_sim, base_rank, region[row_of[i]], rerank_topk,
            global_weight,
        )
        stats["total_topk_candidates"] += topk
        if new_rank is None:
            stats["queries_fallback_global"] += 1
            ranks_new[:, i] = base_rank
        else:
            stats["queries_reranked"] += 1
            stats["matched_candidates_in_topk"] += matched
            ranks_new[:, i] = new_rank
    _finalize_stats(stats)
    return ranks_new, stats


def rerank_with_adaptive_lesion(
    base_sim: np.ndarray,
    lesion_maps: Sequence[dict],
    target_lesions: Sequence[str],
    rerank_topk: int = 50,
    global_weight: float = 0.7,
):
    """(reference chestmir_eval.py:579-652)."""
    n = base_sim.shape[0]
    ranks_base = similarity_to_ranks(base_sim)
    ranks_new = np.empty_like(ranks_base)
    stats = _new_stats(mode="adaptive", rerank_topk=rerank_topk,
                       global_weight=global_weight, n=n)
    usage: Counter = Counter()
    # per-query lesion choice is cheap; the region scoring is batched per
    # chosen lesion (queries grouped, one matmul + segment-max per lesion)
    chosen = [
        choose_query_adaptive_lesion_vector(lesion_maps[i], target_lesions)
        for i in range(n)
    ]
    topk = min(rerank_topk, n - 1)
    region_rows: Dict[int, np.ndarray] = {}
    by_lesion: Dict[str, List[int]] = {}
    for i, (lesion, q_vec) in enumerate(chosen):
        if q_vec is not None:
            by_lesion.setdefault(lesion, []).append(i)
    for lesion, rows in by_lesion.items():
        q_mat = np.stack([chosen[i][1] for i in rows])
        scores = _region_scores_topk(
            q_mat, ranks_base[:topk, rows].T, _region_bank(lesion_maps, lesion)
        )
        for r, i in enumerate(rows):
            region_rows[i] = scores[r]
    for i in range(n):
        base_rank = ranks_base[:, i]
        lesion, q_vec = chosen[i]
        if q_vec is None:
            stats["queries_fallback_global"] += 1
            ranks_new[:, i] = base_rank
            continue
        new_rank, matched, topk = _rerank_one_query_scored(
            i, base_sim, base_rank, region_rows[i], rerank_topk,
            global_weight,
        )
        stats["total_topk_candidates"] += topk
        if new_rank is None:
            stats["queries_fallback_global"] += 1
            ranks_new[:, i] = base_rank
        else:
            usage[lesion] += 1
            stats["queries_reranked"] += 1
            stats["matched_candidates_in_topk"] += matched
            ranks_new[:, i] = new_rank
    stats["lesion_usage"] = dict(usage)
    _finalize_stats(stats)
    return ranks_new, stats


def _new_stats(n: int, **kw) -> Dict[str, Any]:
    return {
        **kw,
        "queries_total": n,
        "queries_reranked": 0,
        "queries_fallback_global": 0,
        "matched_candidates_in_topk": 0,
        "total_topk_candidates": 0,
    }


def _finalize_stats(stats: Dict[str, Any]):
    t = stats.pop("total_topk_candidates")
    stats["candidate_match_rate_pct"] = (
        100.0 * stats["matched_candidates_in_topk"] / t if t > 0 else 0.0
    )
    stats["region_weight"] = 1.0 - stats["global_weight"]


def evaluate_rankings(ranks: np.ndarray, labels: np.ndarray,
                      kappas=(1, 5, 10), cls_k_values=(1, 5)):
    """Full metric suite on (db, nq) ranks: R@K, trapezoid mAP, mP@K,
    majority-vote classification (reference chestmir_eval.py:132-274 notes it
    is aligned with test.py behavior; self is ranked first here since the
    diagonal is NOT -inf in ChestMIR -- replicate by dropping rank 0 when it
    is the query itself)."""
    from ..metrics import compute_ap, compute_classification_metrics

    labels = np.asarray(labels)
    nq = ranks.shape[1]
    kappas = list(kappas)
    # drop self from the ranking per query (reference uses query==gallery and
    # excludes rank of self by masking the diagonal in its metric walk)
    aps = []
    pr = np.zeros(len(kappas))
    recalls = {k: [] for k in kappas}
    for i in range(nq):
        order = [j for j in ranks[:, i] if j != i]
        rel = labels[order] == labels[i]
        pos = np.nonzero(rel)[0]
        nres = int((labels == labels[i]).sum()) - 1
        if nres <= 0:
            aps.append(0.0)
            for k in kappas:
                recalls[k].append(0.0)
            continue
        aps.append(compute_ap(pos, nres))
        pos1 = pos + 1
        for j, k in enumerate(kappas):
            kq = min(pos1.max(initial=1), k)
            pr[j] += (pos1 <= kq).sum() / kq
        for k in kappas:
            recalls[k].append(float(rel[:k].any()))
    report = {
        "mAP": float(np.mean(aps) * 100.0),
        "R@K": {k: float(np.mean(recalls[k]) * 100.0) for k in kappas},
        "mP@K": {k: float(pr[j] / nq * 100.0) for j, k in enumerate(kappas)},
    }
    # majority-vote classification on a sim matrix reconstructed from ranks
    n = ranks.shape[0]
    sims = np.empty((n, nq))
    for i in range(nq):
        sims[ranks[:, i], i] = -np.arange(n, dtype=np.float64)
        sims[i, i] = -np.inf  # exclude self from votes
    report["classification"] = compute_classification_metrics(
        labels, sims, k_values=cls_k_values
    )
    return report


def two_stage_eval(
    global_vectors: np.ndarray,
    labels: np.ndarray,
    lesion_maps: Sequence[dict],
    target_lesions: Sequence[str],
    specific_lesions: Optional[Sequence[str]] = None,
    rerank_topk: int = 50,
    global_weight: float = 0.7,
    kappas=(1, 5, 10),
):
    """Full two-stage evaluation. Returns {stage_name: {report, stats}}."""
    g = np.asarray(global_vectors, np.float64)
    g = g / np.maximum(np.linalg.norm(g, axis=1, keepdims=True), 1e-12)
    sim = g @ g.T
    out = {}
    stage1_ranks = similarity_to_ranks(sim)
    out["stage1_global"] = {
        "report": evaluate_rankings(stage1_ranks, labels, kappas), "stats": {}
    }
    ranks_a, stats_a = rerank_with_adaptive_lesion(
        sim, lesion_maps, target_lesions, rerank_topk, global_weight
    )
    out["stage2_adaptive"] = {
        "report": evaluate_rankings(ranks_a, labels, kappas), "stats": stats_a
    }
    for lesion in specific_lesions or []:
        ranks_s, stats_s = rerank_with_specific_lesion(
            sim, lesion_maps, lesion, rerank_topk, global_weight
        )
        out[f"stage2_{canonical_lesion_name(lesion)}"] = {
            "report": evaluate_rankings(ranks_s, labels, kappas),
            "stats": stats_s,
        }
    return out
