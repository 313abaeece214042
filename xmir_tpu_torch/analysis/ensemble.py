"""Embedding ensembling (port of xmir_tpu/analysis/ensemble.py; reference
postprocess.py:9-41): average / concatenate / weighted combination with
renormalisation, on ``device``."""
from __future__ import annotations

from typing import Sequence

import torch

from ..metrics import on_device
from ..ops.distance import l2_normalize


def ensemble_embeddings(embeddings_list: Sequence, method: str = "average", *, device):
    """(N, D_i) embeddings (arrays or tensors) -> one (N, D) f32 tensor on
    ``device``, L2-normalised."""
    embs = [on_device(e, device) for e in embeddings_list]
    if method == "average":
        combined = torch.mean(torch.stack(embs, dim=0), dim=0)
    elif method == "concatenate":
        combined = torch.cat(embs, dim=1)
    elif method == "weighted":
        w = 1.0 / len(embs)
        combined = sum(w * e for e in embs)
    else:
        raise ValueError(f"Unknown ensemble method: {method}")
    return l2_normalize(combined, dim=1)
