"""Insertion / deletion causal metrics with the reveal steps batched (port of
xmir_tpu/xai/causal.py).

Reference evaluation.py:46-138 runs one forward pass per step per
query-retrieval pair, serially. Here the steps (and the pairs) are batched:
the image at step i is rebuilt from the saliency rank mask (pixels of rank
< i * step come from ``finish``, the rest from ``start``), with no in-place
pixel swapping, so every step is a function of (start, finish, ranks) alone.

Semantics are the reference's:
  n_steps = ceil(hw / step); scores[i] uses the image BEFORE step i's swap;
  score = cosine(q_feat, embed(current)), negatives clipped to 0 and counted;
  AUC = normalized trapezoid (metrics/saliency.py auc).
  del: start=image, finish=substrate; ins: start=substrate(image), finish=image.

``embed_fn`` maps (N, H, W, C) images to (N, D) embeddings on their device
(``train.make_embed_fn``). ``causal_scores_batch_mesh`` and the ``mesh=``
argument of the pair runs split the pair axis over a data-parallel world
(parallel/mesh.py).
"""
from __future__ import annotations

from typing import Callable, Literal, Tuple

import numpy as np
import torch

from ..metrics.saliency import auc as _auc_np


def saliency_rank(explanation) -> torch.Tensor:
    """Per-pixel rank in decreasing saliency order (0 = most salient).
    explanation: (H, W) or (hw,) -> (hw,) int32 ranks.

    The reference's np.argsort then flip: a stable ascending sort, reversed,
    so that among ties the HIGHEST flat index ranks first."""
    flat = torch.as_tensor(explanation).reshape(-1)
    hw = flat.shape[0]
    desc = torch.sort(flat, stable=True).indices.flip(0)
    ranks = torch.empty(hw, dtype=torch.int32, device=flat.device)
    ranks[desc] = torch.arange(hw, dtype=torch.int32, device=flat.device)
    return ranks


def _unit(v):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)


def _step_chunks(n_steps: int, batch_steps: int, device):
    """The step ids 0..n_steps, padded with zeros to whole chunks of
    ``batch_steps``, as (chunks, batch_steps)."""
    ids = torch.arange(n_steps + 1, device=device)
    pad = (-(n_steps + 1)) % batch_steps
    return torch.cat([ids, ids.new_zeros(pad)]).reshape(-1, batch_steps)


def causal_scores(embed_fn, q_feat, start, finish, ranks, step: int, batch_steps: int = 16):
    """Score curve for one pair. start / finish: (H, W, C) preprocessed
    images; ranks: (hw,) from saliency_rank; q_feat: (D,). Returns the
    unclipped cosine similarities (n_steps + 1,) float32."""
    h, w, _ = start.shape
    n_steps = -(-(h * w) // step)
    rank_img = ranks.reshape(h, w).to(start.device)
    qn = _unit(q_feat)
    scores = []
    for ids in _step_chunks(n_steps, batch_steps, start.device):
        mask = rank_img[None] < (ids[:, None, None] * step)  # pixel from `finish`
        embs = embed_fn(torch.where(mask[..., None], finish[None], start[None]))
        scores.append(_unit(embs) @ qn)
    return torch.cat(scores)[:n_steps + 1]


def run_causal_metric(embed_fn, query_image, retrieved_image, explanation,
                      mode: Literal["del", "ins"], substrate_fn: Callable, step: int = 224,
                      batch_steps: int = 16) -> Tuple[float, int, np.ndarray]:
    """Full single-pair run (reference CausalMetric.single_run,
    evaluation.py:65-138). Returns (auc, zero_clip_count, clipped_scores)."""
    q_feat = embed_fn(query_image[None])[0]
    if mode == "del":
        start, finish = retrieved_image, substrate_fn(retrieved_image[None])[0]
    elif mode == "ins":
        start, finish = substrate_fn(retrieved_image[None])[0], retrieved_image
    else:
        raise ValueError("mode must be 'del' or 'ins'")
    ranks = saliency_rank(torch.as_tensor(explanation, device=retrieved_image.device))
    scores = causal_scores(embed_fn, q_feat, start, finish, ranks, step,
                           batch_steps).cpu().numpy()
    zero_cntr = int((scores < 0).sum())
    # the reference clips only negatives (min=0); a cosine above 1 cannot
    # occur, but clip(0, 1) is evaluation.py:104-106 exactly
    clipped = np.clip(scores, 0.0, 1.0)
    return _auc_np(clipped), zero_cntr, clipped


def auto_batch_steps(hw: int, step: int, p_n: int, target: int = 128) -> int:
    """Reveal steps per chunk, so that each forward embeds about ``target``
    images (p_n pairs x steps) in a batch that is a multiple of 8: the step
    count nearest target / p_n, at most the curve's n_steps + 1 slots, then
    lowered until the batch divides by 8 (p_n is the stacked pair count,
    2 x top-k on the both-curves path). The JAX package's rule."""
    n_slots = hw // step + (1 if hw % step else 0) + 1  # n_steps + 1
    p_n = max(p_n, 1)
    bs = max(1, min(round(target / p_n), n_slots))
    while bs > 1 and (bs * p_n) % 8:
        bs -= 1
    return bs


def causal_scores_batch(embed_fn, q_feat, starts, finishes, ranks, step: int,
                        batch_steps: int = 8):
    """Score curves for P pairs sharing one query, batched: each chunk embeds
    P * batch_steps images in one forward (the reference runs one forward a
    step a pair, evaluation.py:100-136). starts / finishes: (P, H, W, C);
    ranks: (P, hw); q_feat: (D,). Returns (P, n_steps + 1) float32 unclipped
    cosine scores."""
    p_n, h, w, c = starts.shape
    n_steps = -(-(h * w) // step)
    rank_img = ranks.reshape(p_n, h, w).to(starts.device)
    qn = _unit(q_feat)
    scores = []
    for ids in _step_chunks(n_steps, batch_steps, starts.device):
        mask = rank_img[None] < (ids[:, None, None, None] * step)  # (bs, P, H, W)
        imgs = torch.where(mask[..., None], finishes[None], starts[None])
        embs = embed_fn(imgs.reshape(batch_steps * p_n, h, w, c))
        scores.append((_unit(embs) @ qn).reshape(batch_steps, p_n))
    return torch.cat(scores)[:n_steps + 1].T


def causal_scores_batch_mesh(embed_fn, q_feat, starts, finishes, ranks, step: int, mesh,
                             batch_steps: int = 8):
    """``causal_scores_batch`` with the PAIR axis split over ``mesh``'s
    world: the pairs are padded with zero images to a multiple of the world,
    rank r runs the whole curve of its own pairs, and the curves are gathered
    in pair order. No sum crosses pairs, so each curve is the one-device
    path's. Returns (P, n_steps + 1) on every rank."""
    p_n = starts.shape[0]
    pad = (-p_n) % mesh.n_data
    if pad:
        zimg = starts.new_zeros((pad,) + tuple(starts.shape[1:]))
        starts, finishes = torch.cat([starts, zimg]), torch.cat([finishes, zimg])
        ranks = torch.cat([ranks, ranks.new_zeros((pad,) + tuple(ranks.shape[1:]))])
    rows = starts.shape[0] // mesh.n_data
    mine = slice(mesh.data_rank * rows, (mesh.data_rank + 1) * rows)
    local = causal_scores_batch(embed_fn, q_feat, starts[mine], finishes[mine], ranks[mine],
                                step, batch_steps)
    return mesh.all_gather(local.contiguous()).reshape(-1, local.shape[1])[:p_n]


def _curves(embed_fn, q_feat, starts, finishes, ranks, step: int, batch_steps: int,
            mesh=None):
    """(auc, zero_count) of each pair's curve; batch_steps=0 picks
    auto_batch_steps (for the pairs of one rank, under a mesh)."""
    if not batch_steps:
        p_eff = starts.shape[0] if mesh is None else -(-starts.shape[0] // mesh.n_data)
        batch_steps = auto_batch_steps(starts.shape[1] * starts.shape[2], step, p_eff)
    if mesh is not None:
        scores = causal_scores_batch_mesh(embed_fn, q_feat, starts, finishes, ranks, step,
                                          mesh, batch_steps).cpu().numpy()
    else:
        scores = causal_scores_batch(embed_fn, q_feat, starts, finishes, ranks, step,
                                     batch_steps).cpu().numpy()
    return [(_auc_np(np.clip(s, 0.0, 1.0)), int((s < 0).sum())) for s in scores]


def _ranks(explanations, device):
    return torch.stack([saliency_rank(torch.as_tensor(e, device=device)) for e in explanations])


def run_causal_metric_pairs(embed_fn, query_image, retrieved_images, explanations,
                            mode: Literal["del", "ins"], substrate_fn: Callable, step: int = 224,
                            batch_steps: int = 0, mesh=None):
    """Batched multi-pair run for one query. retrieved_images (P, H, W, C),
    explanations (P, H, W). Returns a list of (auc, zero_count) per pair.
    batch_steps=0 picks the chunking of auto_batch_steps; with ``mesh`` the
    pairs fan out over its world (causal_scores_batch_mesh)."""
    q_feat = embed_fn(query_image[None])[0]
    subs = substrate_fn(retrieved_images)
    if mode == "del":
        starts, finishes = retrieved_images, subs
    elif mode == "ins":
        starts, finishes = subs, retrieved_images
    else:
        raise ValueError("mode must be 'del' or 'ins'")
    return _curves(embed_fn, q_feat, starts, finishes,
                   _ranks(explanations, retrieved_images.device), step, batch_steps, mesh)


def run_causal_metric_pairs_both(embed_fn, query_image, retrieved_images, explanations,
                                 del_substrate_fn: Callable, ins_substrate_fn: Callable,
                                 step: int = 224, batch_steps: int = 0, mesh=None):
    """Deletion AND insertion curves for P pairs in one batched computation:
    the two modes stack along the pair axis (2P pairs), so every forward
    embeds twice the images of a single-mode call. Per-pair results are those
    of two run_causal_metric_pairs calls (an eval-mode model embeds each
    image independently of its batch). Returns (del_results, ins_results),
    each a list of (auc, zero_count)."""
    p_n = retrieved_images.shape[0]
    q_feat = embed_fn(query_image[None])[0]
    starts = torch.cat([retrieved_images, ins_substrate_fn(retrieved_images)])
    finishes = torch.cat([del_substrate_fn(retrieved_images), retrieved_images])
    ranks = _ranks(explanations, retrieved_images.device)
    out = _curves(embed_fn, q_feat, starts, finishes, torch.cat([ranks, ranks]), step,
                  batch_steps, mesh)
    return out[:p_n], out[p_n:]


def zeros_substrate(images):
    return torch.zeros_like(images)


def blur_substrate(klen: int = 51, nsig: float = 50**0.5):
    from ..ops.blur import gaussian_blur

    return lambda images: gaussian_blur(images, klen, nsig)
