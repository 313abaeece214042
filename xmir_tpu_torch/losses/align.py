"""ConceptCLIP alignment losses: IT-Align and RC-Align (port of
xmir_tpu/losses/align.py; reference loss.py:435-639).

RC-Align takes the padded form of the JAX package: the concepts of a batch
arrive as a (B, W, D) tensor with a (B, W) validity mask, so the loss is one
einsum chain, where the reference loops over variable-length concept lists.

The clips are ``minimum(maximum(x, lo), hi)``, as ``jnp.clip`` is: at a bound
the gradient is split in half between the two sides, where ``torch.clamp``
passes all of it. The ConceptCLIP step clamps ``logit_scale`` to ln 100 after
every update, so the scale sits on that bound whenever it has reached it. No
function branches on a tensor's value or fetches one to the host.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .metric_losses import l2_normalize

LOG_SCALE_MAX = 4.6052  # ln(100), CLIP convention (reference loss.py:467)
LOGIT_CLIP = 50.0


def _clip(x, lo: float, hi: float):
    """``jnp.clip(x, lo, hi)``, its gradient at a bound included."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _finite_or_zero(loss):
    return torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss))


def _scaled(similarity, logit_scale, logit_bias):
    """exp(clip(logit_scale, 0, ln 100)) similarity (+ logit_bias), clipped
    to +-50."""
    logits = torch.exp(_clip(logit_scale, 0.0, LOG_SCALE_MAX)) * similarity
    if logit_bias is not None:
        logits = logits + logit_bias
    return _clip(logits, -LOGIT_CLIP, LOGIT_CLIP)


def it_align_loss(image_features, text_features, logit_scale, logit_bias=None):
    """SigLIP-style sigmoid contrastive loss over the (B, B) image-text pairs,
    +1 on the diagonal and -1 off it (reference loss.py:435-493). A
    non-finite loss is 0."""
    img = l2_normalize(image_features, dim=-1)
    txt = l2_normalize(text_features, dim=-1)
    logits = _scaled(img @ txt.T, logit_scale, logit_bias)
    z = 2.0 * torch.eye(img.shape[0], device=logits.device) - 1.0
    return _finite_or_zero(-torch.mean(F.logsigmoid(z * logits)))


def rc_align_loss(image_token_features, concept_text_features, concept_mask, logit_scale,
                  logit_bias=None):
    """Region-concept alignment, padded-batch form (reference
    loss.py:496-594).

    image_token_features (B, N, D) patch embeddings; concept_text_features
    (B, W, D) padded concept embeddings; concept_mask (B, W), true where a
    slot holds a concept. S(I_m, T_n) = the mean over n's concepts of the
    largest cosine between one of m's patches and that concept. Samples
    without a concept leave both the rows and the columns; the loss averages
    log-sigmoid(z t S) over the valid (V, V) block, z = +1 on the diagonal."""
    patches = l2_normalize(image_token_features, dim=-1)
    concepts = l2_normalize(concept_text_features, dim=-1)
    cmask = concept_mask.to(torch.float32)
    w_total = torch.sum(cmask, dim=1)
    valid = w_total > 0
    # a[m, n, i, w] = cos(patch i of image m, concept w of sample n)
    a = torch.einsum("mid,nwd->mniw", patches, concepts)
    max_per_concept = torch.amax(a, dim=2)  # (B, B, W)
    s = torch.sum(max_per_concept * cmask[None], dim=2) / torch.clamp(w_total, min=1.0)[None]
    logits = _scaled(s, logit_scale, logit_bias)
    b = patches.shape[0]
    z = 2.0 * torch.eye(b, device=logits.device) - 1.0
    pair_valid = (valid[:, None] & valid[None, :]).to(torch.float32)
    n_pairs = torch.sum(pair_valid)
    loss = -torch.sum(F.logsigmoid(z * logits) * pair_valid) / torch.clamp(n_pairs, min=1.0)
    loss = torch.where(n_pairs > 0, loss, torch.zeros_like(loss))
    return _finite_or_zero(loss)


def conceptclip_loss(image_features, text_features, image_token_features, concept_text_features,
                     concept_mask, logit_scale, logit_bias=None, alpha: float = 0.5):
    """IT-Align + alpha RC-Align (reference loss.py:597-639). Returns (total,
    it, rc)."""
    it = it_align_loss(image_features, text_features, logit_scale, logit_bias)
    rc = rc_align_loss(image_token_features, concept_text_features, concept_mask, logit_scale,
                       logit_bias)
    return it + alpha * rc, it, rc
