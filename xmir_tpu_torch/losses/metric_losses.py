"""Deep metric-learning losses as plain functions on tensors (port of
xmir_tpu/losses/metric_losses.py).

Behavioural parity targets (reference loss.py):
  triplet batch-all / batch-hard        loss.py:60-114
  SupervisedContrastive (single/multi)  loss.py:27-57
  WeightedMultiLabelTriplet             loss.py:151-227  (vectorised)
  JaccardSupCon                         loss.py:230-284
  AsymmetricLoss (ASL)                  loss.py:311-344
  MultiLabelContrastive                 loss.py:347-384
  DualBranchMultiLabel                  loss.py:387-427
  TripletHashLoss                       ath_model.py:111-123

No function branches on a tensor's value or fetches one to the host: each
returns device tensors, so a training step can run without a sync. The
constants (-1e9 for masked logits, the 1e-16 denominators, eps = 1e-8) are
part of the result and are the JAX package's.
"""
from __future__ import annotations

import torch

_NEG_INF = -1e9


def l2_normalize(x, dim: int = -1, eps: float = 1e-12):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=eps)


def pairwise_distance(embeddings, p: float = 2.0):
    """Pairwise Lp distance matrix (matches torch.cdist for p = 2)."""
    if p == 2.0:
        sq = torch.sum(embeddings * embeddings, dim=1)
        d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (embeddings @ embeddings.T), min=0.0)
        # safe sqrt: zero distances (the diagonal, duplicate rows) get gradient
        # 0, not NaN. The input of sqrt is masked, not only its output: a
        # ``where`` after the sqrt would still back-propagate inf * 0 = NaN.
        zero = d2 <= 0.0
        d = torch.sqrt(torch.where(zero, torch.ones_like(d2), d2))
        return torch.where(zero, torch.zeros_like(d), d)
    diff = torch.abs(embeddings[:, None, :] - embeddings[None, :, :])
    return torch.pow(torch.sum(torch.pow(diff, p), dim=-1), 1.0 / p)


# ---------------------------------------------------------------------------
# triplet losses (single-label)


def _triplet_mask(labels):
    """(B, B, B) mask of valid (a, p, n) triplets: distinct indices,
    label[a] == label[p], label[a] != label[n]."""
    b = labels.shape[0]
    not_eq = ~torch.eye(b, dtype=torch.bool, device=labels.device)
    distinct = not_eq[:, :, None] & not_eq[:, None, :] & not_eq[None, :, :]
    label_eq = labels[None, :] == labels[:, None]
    valid = label_eq[:, :, None] & ~label_eq[:, None, :]
    return valid & distinct


def batch_all_triplet_loss(embeddings, labels, margin=1.0, p=2.0):
    """Mean loss over positive (loss > 0) valid triplets; aux = fraction of
    positive triplets among valid ones (reference loss.py:88-114)."""
    dist = pairwise_distance(embeddings, p)
    tl = dist[:, :, None] - dist[:, None, :] + margin
    mask = _triplet_mask(labels)
    tl = torch.where(mask, tl, torch.zeros_like(tl))
    tl = torch.clamp(tl, min=0.0)
    num_positive = torch.sum(tl > 1e-16).to(tl.dtype)
    num_valid = torch.sum(mask).to(torch.float32)
    loss = torch.sum(tl) / (num_positive + 1e-16)
    frac = num_positive / (num_valid + 1e-16)
    return loss, frac


def batch_hard_triplet_loss(embeddings, labels, margin=1.0, p=2.0):
    """Hardest positive minus hardest negative per anchor (reference
    loss.py:60-85)."""
    dist = pairwise_distance(embeddings, p)
    b = labels.shape[0]
    eye = torch.eye(b, dtype=torch.bool, device=labels.device)
    label_eq = labels[None, :] == labels[:, None]
    pos_mask = (label_eq & ~eye).to(dist.dtype)
    hardest_pos = torch.amax(pos_mask * dist, dim=1, keepdim=True)
    neg_mask = (~label_eq).to(dist.dtype)
    max_dist = torch.amax(dist, dim=1, keepdim=True)
    neg_dist = dist + max_dist * (1.0 - neg_mask)
    hardest_neg = torch.amin(neg_dist, dim=1, keepdim=True)
    loss = torch.clamp(hardest_pos - hardest_neg + margin, min=0.0)
    return torch.mean(loss), torch.tensor(-1.0, device=dist.device)


def triplet_margin_loss(embeddings, labels, margin=1.0, p=2.0, mining="batch_all"):
    if mining == "batch_all":
        return batch_all_triplet_loss(embeddings, labels, margin, p)
    if mining == "batch_hard":
        return batch_hard_triplet_loss(embeddings, labels, margin, p)
    raise ValueError(f"unknown mining mode {mining!r}")


# ---------------------------------------------------------------------------
# supervised contrastive (single- or multi-label positives)


def _masked_mean(per_anchor, valid):
    """Mean of ``per_anchor`` over the ``valid`` anchors, 0 when none is."""
    n_valid = torch.sum(valid)
    total = torch.sum(torch.where(valid, per_anchor, torch.zeros_like(per_anchor)))
    loss = total / torch.clamp(n_valid, min=1)
    return torch.where(n_valid > 0, loss, torch.zeros_like(loss))


def supcon_loss(embeddings, labels, temperature=0.07, eps=1e-8):
    """SupCon with self masked to -1e9 before logsumexp (reference
    loss.py:27-57). Multi-hot labels (2-D) define positives by a label
    intersection > 0."""
    emb = l2_normalize(embeddings, dim=1)
    logits = (emb @ emb.T) / temperature
    b = emb.shape[0]
    self_mask = torch.eye(b, dtype=torch.bool, device=emb.device)
    if labels.dim() == 1:
        positive_mask = labels[None, :] == labels[:, None]
    else:
        lf = labels.to(torch.float32)
        positive_mask = (lf @ lf.T) > 0
    positive_mask = positive_mask & ~self_mask
    logits = torch.where(self_mask, torch.full_like(logits, _NEG_INF), logits)
    log_prob = logits - torch.logsumexp(logits, dim=1, keepdim=True)
    pos_per_anchor = torch.sum(positive_mask, dim=1)
    per_anchor = -torch.sum(positive_mask * log_prob, dim=1) / (
        pos_per_anchor.to(torch.float32) + eps)
    return _masked_mean(per_anchor, pos_per_anchor > 0)


# ---------------------------------------------------------------------------
# multi-label (Jaccard) losses


def jaccard_similarity(labels, eps: float = 1e-8):
    labels = labels.to(torch.float32)
    inter = labels @ labels.T
    sums = torch.sum(labels, dim=1, keepdim=True)
    union = sums + sums.T - inter
    return inter / (union + eps)


def weighted_multilabel_triplet_loss(embeddings, labels, margin=0.3):
    """Jaccard-weighted multi-label triplet with hardest-negative mining,
    vectorised over anchors (reference loss.py:151-227 loops in Python).

    Per anchor i: positives = Jaccard > 0 (excluding self), negatives =
    Jaccard == 0; loss_i = mean over positives of
    relu(d_p - min(d_n) + margin) * w_p; total = mean over anchors with at
    least one positive and one negative."""
    emb = l2_normalize(embeddings, dim=1)
    dist = pairwise_distance(emb, 2.0)
    labels_f = labels.to(torch.float32)
    inter = labels_f @ labels_f.T
    jac = jaccard_similarity(labels_f)
    b = emb.shape[0]
    eye = torch.eye(b, dtype=torch.bool, device=emb.device)
    pos_mask = (jac > 0) & ~eye
    neg_mask = inter == 0  # exact: products of multi-hot entries sum to 0
    has_neg = torch.any(neg_mask, dim=1)
    anchor_valid = torch.any(pos_mask, dim=1) & has_neg
    hard_neg = torch.amin(torch.where(neg_mask, dist, torch.full_like(dist, float("inf"))), dim=1)
    hard_neg = torch.where(has_neg, hard_neg, torch.zeros_like(hard_neg))  # dead for invalid anchors
    per_pair = torch.clamp(dist - hard_neg[:, None] + margin, min=0.0) * jac
    pos_count = torch.sum(pos_mask, dim=1)
    per_anchor = torch.sum(torch.where(pos_mask, per_pair, torch.zeros_like(per_pair)),
                           dim=1) / torch.clamp(pos_count, min=1)
    return _masked_mean(per_anchor, anchor_valid), torch.tensor(0.0, device=emb.device)


def jaccard_supcon_loss(embeddings, labels, temperature=0.07, eps=1e-8):
    """SupCon with per-anchor Jaccard weights normalised to 1 (reference
    loss.py:230-284). NIH default loss."""
    emb = l2_normalize(embeddings, dim=1)
    sim = (emb @ emb.T) / temperature
    jac = jaccard_similarity(labels, eps)
    b = emb.shape[0]
    self_mask = torch.eye(b, dtype=torch.bool, device=emb.device)
    jac = torch.where(self_mask, torch.zeros_like(jac), jac)
    weight_sum = torch.sum(jac, dim=1, keepdim=True) + eps
    weights = jac / weight_sum
    masked = torch.where(self_mask, torch.full_like(sim, _NEG_INF), sim)
    log_prob = sim - torch.logsumexp(masked, dim=1, keepdim=True)
    per_anchor = -torch.sum(weights * log_prob, dim=1)
    return _masked_mean(per_anchor, weight_sum[:, 0] > eps)


def asymmetric_loss(logits, targets, gamma_pos=1.0, gamma_neg=4.0, clip=0.05, eps=1e-8):
    """Multi-label asymmetric focal BCE (reference loss.py:311-344)."""
    targets = targets.to(torch.float32)
    prob_pos = torch.sigmoid(logits)
    prob_neg = 1.0 - prob_pos
    if clip is not None and clip > 0:
        prob_neg = torch.clamp(prob_neg + clip, max=1.0)
    log_pos = torch.log(torch.clamp(prob_pos, min=eps))
    log_neg = torch.log(torch.clamp(prob_neg, min=eps))
    loss = targets * log_pos + (1.0 - targets) * log_neg
    if gamma_pos > 0 or gamma_neg > 0:
        pt = prob_pos * targets + prob_neg * (1.0 - targets)
        gamma = gamma_pos * targets + gamma_neg * (1.0 - targets)
        loss = loss * torch.pow(1.0 - pt, gamma)
    return -torch.mean(torch.sum(loss, dim=1))


def multilabel_contrastive_loss(embeddings, labels, temperature=0.07, use_jaccard_weight=True,
                                eps=1e-8):
    """Jaccard-weighted SupCon with per-anchor weight normalisation at loss
    time (reference loss.py:287-384)."""
    emb = l2_normalize(embeddings, dim=1)
    labels_f = labels.to(torch.float32)
    inter = labels_f @ labels_f.T
    jac = jaccard_similarity(labels_f, eps)
    b = emb.shape[0]
    self_mask = torch.eye(b, dtype=torch.bool, device=emb.device)
    positive = ((inter > 0) & ~self_mask).to(torch.float32)
    weights = jac * positive if use_jaccard_weight else positive
    logits = (emb @ emb.T) / temperature
    logits = torch.where(self_mask, torch.full_like(logits, _NEG_INF), logits)
    log_prob = logits - torch.logsumexp(logits, dim=1, keepdim=True)
    wsum = torch.sum(weights, dim=1)
    per_anchor = -torch.sum(weights * log_prob, dim=1) / torch.clamp(wsum, min=eps)
    return _masked_mean(per_anchor, wsum > 0)


def dual_branch_multilabel_loss(outputs: dict, labels, alpha=1.0, temperature=0.07,
                                use_jaccard_weight=True, gamma_pos=1.0, gamma_neg=4.0, clip=0.05):
    """contrastive(embedding) + alpha * ASL(logits) on a dual-head output dict
    (reference loss.py:387-427)."""
    contrastive = multilabel_contrastive_loss(outputs["embedding"], labels, temperature,
                                              use_jaccard_weight)
    asl = asymmetric_loss(outputs["logits"], labels, gamma_pos, gamma_neg, clip)
    total = contrastive + alpha * asl
    return total, {"contrastive": contrastive, "asl": asl}


# ---------------------------------------------------------------------------
# hashing (ATH)


def triplet_hash_loss(anchor_hash, positive_hash, negative_hash, margin=0.5):
    """MSE-based triplet on hash codes, margin scaled by code length
    (reference ath_model.py:111-123)."""
    margin_val = margin * anchor_hash.shape[1]
    pos = torch.mean((anchor_hash - positive_hash) ** 2, dim=1)
    neg = torch.mean((anchor_hash - negative_hash) ** 2, dim=1)
    return torch.mean(torch.clamp(margin_val - neg + pos, min=0.0))
