"""Zero-shot classification and text-aware retrieval variants (port of
xmir_tpu/analysis/zeroshot.py; reference test.py:237-849).

  - zero-shot classification from class-prompt text embeddings
    (test.py:237-347 BiomedCLIP path, test_conceptclip.py)
  - concept-profile retrieval: sigmoid(exp(logit_scale) img . concept +
    logit_bias) score vectors used AS the retrieval embedding
    (test.py:350-509)
  - two-model text reranking: backbone retrieval, then the top-k rescored by
    alpha * img_sim + (1 - alpha) * text_score where text_score is the
    retrieved image's similarity to the QUERY's class prompt
    (test.py:512-674)

The first two run where their inputs lie (``metrics.on_device``): a tensor's
device, or ``device`` for arrays; arrays alone with no device raise, since
there is no default device.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..metrics import on_device
from ..ops.distance import l2_normalize


def _cosines(a, b, device=None):
    """(cos(a_i, b_j)) on ``device``, else on whichever input is a tensor."""
    if device is None:
        device = next((t.device for t in (a, b) if torch.is_tensor(t)), None)
    a, b = on_device(a, device), on_device(b, device)
    return l2_normalize(a, dim=-1) @ l2_normalize(b, dim=-1).T


def _logits(cos, logit_scale, logit_bias):
    scale = torch.as_tensor(logit_scale, dtype=torch.float32, device=cos.device)
    return torch.exp(scale) * cos + logit_bias


def zero_shot_classify(image_feats, class_text_feats, logit_scale=1.0, logit_bias=0.0,
                       device=None):
    """Predicted class per image + probability matrix. image_feats (N, D),
    class_text_feats (C, D); both normalised here. Returns (preds (N,),
    probs (N, C) sigmoid scores) as numpy arrays."""
    logits = _logits(_cosines(image_feats, class_text_feats, device), logit_scale, logit_bias)
    return torch.argmax(logits, dim=1).cpu().numpy(), torch.sigmoid(logits).cpu().numpy()


def concept_profile_embeddings(image_feats, concept_feats, logit_scale=1.0, logit_bias=0.0,
                               device=None):
    """Each image as its concept-confidence vector sigmoid(exp(t) cos(img,
    concept) + b): retrieval then runs on these profiles (reference
    test.py:350-509). Returns (N, K) numpy."""
    logits = _logits(_cosines(image_feats, concept_feats, device), logit_scale, logit_bias)
    return torch.sigmoid(logits).cpu().numpy()


def text_rerank_scores(
    image_embeds: np.ndarray,
    labels: np.ndarray,
    image_text_sim: np.ndarray,
    rerank_k: int = 20,
    image_weight: float = 0.7,
) -> np.ndarray:
    """Two-model reranking (reference test.py:603-622), numpy in float64 as in
    the JAX package: start from the image cosine matrix (diag -inf); per
    query i rescore its top-k entries j as image_weight * img_sim[i, j] +
    (1 - image_weight) * image_text_sim[j, label_i].

    image_text_sim: (N, C) similarity of each image to each class prompt.
    Returns the reranked (N, N) score matrix.
    """
    e = np.asarray(image_embeds, np.float64)
    e = e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)
    img_sim = e @ e.T
    np.fill_diagonal(img_sim, -np.inf)
    labels = np.asarray(labels).astype(int)
    its = np.asarray(image_text_sim, np.float64)
    n = len(labels)
    out = img_sim.copy()
    alpha, beta = image_weight, 1.0 - image_weight
    k = min(rerank_k, n)
    for i in range(n):
        top = np.argpartition(-img_sim[i], k - 1)[:k]
        out[i, top] = alpha * img_sim[i, top] + beta * its[top, labels[i]]
    return out


def build_class_prompts(label_names: Sequence[str], template: str = "a medical image showing {}"):
    return [template.format(name) for name in label_names]
