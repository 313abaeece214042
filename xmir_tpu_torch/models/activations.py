"""Precision-adaptive activations (port of xmir_tpu/models/activations.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def adaptive_gelu(x):
    """Exact (erf) GELU in f32, the tanh form in bf16, where its error
    (~1e-3 relative) is below bf16's rounding step."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")
