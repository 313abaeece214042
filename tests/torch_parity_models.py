"""The narrow DenseNet, ConvNeXtV2 and SwinV2 embedders that the tests/test_torch_*.py
files run in both packages (JAX side and weight randomisation)."""
from __future__ import annotations

from typing import Optional

import flax.linen as fnn
import jax
import numpy as np

from xmir_tpu.losses.metric_losses import l2_normalize
from xmir_tpu.models.convnext import ConvNeXtV2Backbone
from xmir_tpu.models.densenet import DenseNetBackbone
from xmir_tpu.models.heads import PCAMPool, SRA

# the narrow DenseNet the CPU tests run in both packages
NARROW = dict(growth_rate=8, block_config=(2, 2, 2, 2), num_init_features=16)


class JaxNarrowEmbedder(fnn.Module):
    """xmir_tpu's DenseNet121Embedder with the narrow backbone."""

    embedding_dim: int = 12
    num_labels: int = 3

    @fnn.compact
    def __call__(self, x, train: bool = False):
        out = DenseNetBackbone(**NARROW, name="backbone")(x, train)
        feat = fnn.Dense(self.embedding_dim, name="fc")(out["pooled"])
        return {
            "embedding": l2_normalize(feat, axis=1),
            "features": out["features"],
            "logits": fnn.Dense(self.num_labels, name="classification_head")(feat),
        }


def randomized(variables, seed):
    """Random params and BatchNorm statistics (var > 0) so every tensor of
    the conversion matters."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        if names[-1] == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if names[-1] == "mean" or names[-1].endswith("bias"):
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if names[-1] == "scale":
            return rng.uniform(0.8, 1.2, leaf.shape).astype(np.float32)
        if names[-1] in ("gamma", "beta"):  # GRN: zero at init
            return (0.2 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return np.asarray(leaf)  # conv / dense kernels keep their init

    return jax.tree_util.tree_map_with_path(fill, jax.device_get(variables))


# the narrow ConvNeXtV2 the CPU tests run in both packages
NARROW_CONVNEXT = dict(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64))


class JaxNarrowConvNeXt(fnn.Module):
    """xmir_tpu's ConvNeXtV2Embedder ("plain"), ConvNeXtV2SRAEmbedder ("sra")
    or ConvNeXtV2PCAMEmbedder ("pcam") with the narrow backbone: the same
    __call__ bodies (PCAM's class logits and CAM maps with train=True)."""

    kind: str = "plain"
    embedding_dim: Optional[int] = None
    num_heads: int = 8
    lam: float = 0.1
    num_classes: int = 3

    @fnn.compact
    def __call__(self, x, train: bool = False):
        out = ConvNeXtV2Backbone(**NARROW_CONVNEXT, name="backbone")(x, train)
        if self.kind == "plain":
            feat = out["pooled_norm"]
            if self.embedding_dim:
                feat = fnn.Dense(self.embedding_dim, name="fc")(feat)
            return {"embedding": l2_normalize(feat, axis=1), "features": out["features"]}
        if self.kind == "sra":
            feat = SRA(1024, self.num_heads, self.lam, name="sra")(
                out["features"], out["head_norm"])
            return {"embedding": l2_normalize(feat, axis=1), "features": out["features"]}
        embedding, class_logits, pcam_probs = PCAMPool(
            1024, self.num_classes, self.lam, self.embedding_dim, name="pcam")(
            out["features"], out["head_norm"])
        result = {"embedding": embedding, "features": out["features"]}
        if train:
            result.update({"class_logits": class_logits, "pcam_maps": pcam_probs})
        return result


# the narrow SwinV2 the CPU tests run in both packages: at 32 px the stages'
# maps are 8 x 8 (four 4 x 4 windows, the second block shifted), 4 x 4 (one
# window, never shifted) and 2 x 2 (the window cut to the map); at 64 px 16 x
# 16, 8 x 8 (both with shifted blocks) and 4 x 4
NARROW_SWIN = dict(embed_dim=16, depths=(2, 2, 2), num_heads=(2, 4, 8), window=4,
                   pretrained_window=(4, 4, 2))


class JaxNarrowSwin(fnn.Module):
    """xmir_tpu's SwinV2Embedder with the narrow backbone: the same __call__
    body."""

    embedding_dim: Optional[int] = None

    @fnn.compact
    def __call__(self, x, train: bool = False):
        from xmir_tpu.models.swin import SwinV2Backbone

        out = SwinV2Backbone(**NARROW_SWIN, name="backbone")(x, train)
        feat = out["pooled"]
        if self.embedding_dim:
            feat = fnn.Dense(self.embedding_dim, name="fc")(feat)
        return {"embedding": l2_normalize(feat, axis=1), "features": out["features"]}
