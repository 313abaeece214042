"""Step functions (port of xmir_tpu/train/steps.py): the metric-learning
train step, the NIH dual-branch and the distillation steps, the ConceptCLIP
IT + RC step with its host-side concept dedupe, the MedSigLIP IT-Align and
the ATH hashing steps (inline in the JAX package's cli/train_medsiglip.py and
cli/train_ath.py), gradient accumulation and the inference embedding step.

Mixed precision (``compute_dtype=bfloat16``) is not ``torch.autocast``, but
the JAX package's scheme: master parameters stay f32 in the optimiser, a bf16
copy is made INSIDE the differentiated function (``p.to(bfloat16)``, whose
backward hands f32 gradients back) and the model runs on the copies through
``torch.func.functional_call``; the images are cast to bf16 and the embedding
to f32 before the loss. Buffers (BatchNorm statistics) are not cast. No loss
scaling: bf16 carries f32's exponent range.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..losses import (
    LOG_SCALE_MAX,
    asymmetric_loss,
    conceptclip_loss,
    it_align_loss,
    jaccard_supcon_loss,
    multilabel_contrastive_loss,
    supcon_loss,
    triplet_hash_loss,
    triplet_margin_loss,
    weighted_multilabel_triplet_loss,
)


def _no_aux(loss_fn):
    def fn(e, l, **kw):
        loss = loss_fn(e, l, **kw)
        return loss, torch.zeros((), device=loss.device)
    return fn


LOSS_FNS = {
    "triplet": triplet_margin_loss,
    "triplet_hard": lambda e, l, **kw: triplet_margin_loss(e, l, mining="batch_hard", **kw),
    "supcon": _no_aux(supcon_loss),
    "jaccard_supcon": _no_aux(jaccard_supcon_loss),
    "weighted_multilabel_triplet": weighted_multilabel_triplet_loss,
    "multilabel_contrastive": _no_aux(multilabel_contrastive_loss),
}


class _Bound(nn.Module):
    """``fn(model, *args)`` as a module's forward, so that
    ``functional_call`` can run any of ``model``'s methods on swapped
    tensors."""

    def __init__(self, model, fn):
        super().__init__()
        self.model, self.fn = model, fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def _train_call(model, compute_dtype, fn, *args):
    """fn(model, *args) in training: directly in f32, else on
    ``compute_dtype`` copies of the floating parameters made inside autograd
    (buffers uncast), whichever of the model's methods fn calls."""
    if compute_dtype == torch.float32:
        return fn(model, *args)
    tensors = {f"model.{name}": p.to(compute_dtype) if p.is_floating_point() else p
               for name, p in model.named_parameters()}
    tensors.update((f"model.{name}", b) for name, b in model.named_buffers())
    return functional_call(_Bound(model, fn), tensors, args)


def _train_forward(model, images, compute_dtype, **kwargs):
    """``model``'s output in training on ``images`` (already in
    ``compute_dtype``), by ``_train_call``."""
    return _train_call(model, compute_dtype, lambda m, x: m(x, **kwargs), images)


def _backward_and_apply(state, loss):
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.apply_gradients()


def _gather_batch(mesh, *tensors):
    """Under a data-parallel ``mesh`` each rank's rows of each tensor joined
    into the global batch, in rank order (autograd reaches each rank's own
    rows only: parallel/mesh.py::Mesh.gather_rows); without one, the tensors
    as they are. A loss on the global batch sees what the world-1 loss sees
    (triplet mining and PK structure over the whole batch)."""
    if mesh is None:
        return tensors
    return tuple(mesh.gather_rows(t) if t.requires_grad else
                 mesh.all_gather(t).reshape((-1,) + tuple(t.shape[1:])) for t in tensors)


def make_embedding_train_step(model, loss_name: str = "triplet",
                              loss_kwargs: Optional[dict] = None,
                              compute_dtype=torch.float32, remat: bool = False, mesh=None):
    """Generic metric-learning step (reference train_epoch, train.py:47-148):
    step(state, images, labels) runs ``model`` in training mode on the
    images, takes the loss of its embeddings, back-propagates and calls
    ``state.apply_gradients()``. Returns {"loss", "aux"} as device tensors:
    nothing here waits for the device.

    remat=True recomputes the forward pass during the backward
    (``torch.utils.checkpoint``): activation memory drops to the model's
    inputs and outputs at the cost of one more forward. BatchNorm buffers
    move once a step all the same. ``step.loss_and_aux(images, labels)`` is
    the differentiated function alone (forward and loss), for measurements.

    With a data-parallel ``mesh`` the images and labels are this rank's rows
    of the global batch; the loss is taken on the gathered global batch
    (_gather_batch), and the state reduces the gradients across ranks."""
    loss_kwargs = loss_kwargs or {}
    loss_fn = LOSS_FNS[loss_name]

    def forward(images):
        out = _train_forward(model, images, compute_dtype)
        emb = out["embedding"] if isinstance(out, dict) else out
        return emb.float()

    def loss_and_aux(images, labels):
        images = images.to(compute_dtype)
        emb = checkpoint(forward, images, use_reentrant=False) if remat else forward(images)
        emb, labels = _gather_batch(mesh, emb, labels)
        return loss_fn(emb, labels, **loss_kwargs)

    def step(state, images, labels):
        state.gather_params()
        loss, aux = loss_and_aux(images, labels)
        # under remat the recomputation in the backward moves the buffers again
        buffers = [(b, b.clone()) for b in model.buffers()] if remat else []
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        with torch.no_grad():
            for b, saved in buffers:
                b.copy_(saved)
        state.apply_gradients()
        return {"loss": loss.detach(), "aux": aux.detach()}

    step.loss_and_aux = loss_and_aux
    return step


def make_dual_branch_train_step(model, contrastive_weight: float = 1.0, asl_alpha: float = 1.0,
                                temperature: float = 0.07, gamma_pos: float = 1.0,
                                gamma_neg: float = 4.0, clip: float = 0.05,
                                compute_dtype=torch.float32, mesh=None):
    """NIH dual-head step (reference nih_multilabel_retrieval.py:308-348):
    the Jaccard-weighted multi-label contrastive loss of the f32 embedding
    plus ``asl_alpha`` times the asymmetric loss of the f32 logits, on a
    model whose output holds "embedding" and "logits". Returns {"loss",
    "contrastive", "asl"} as device tensors. ``step.losses(images, labels)``
    is the differentiated function alone. A ``mesh`` as in
    make_embedding_train_step: both terms are taken on the global batch."""

    def losses(images, labels):
        out = _train_forward(model, images.to(compute_dtype), compute_dtype)
        emb, logits, labels = _gather_batch(mesh, out["embedding"].float(),
                                            out["logits"].float(), labels)
        contrastive = multilabel_contrastive_loss(emb, labels, temperature)
        asl = asymmetric_loss(logits, labels, gamma_pos, gamma_neg, clip)
        return contrastive_weight * contrastive + asl_alpha * asl, contrastive, asl

    def step(state, images, labels):
        state.gather_params()
        loss, contrastive, asl = losses(images, labels)
        _backward_and_apply(state, loss)
        return {"loss": loss.detach(), "contrastive": contrastive.detach(), "asl": asl.detach()}

    step.losses = losses
    return step


def make_distill_train_step(model, loss_name: str = "triplet", distill_weight: float = 1.0,
                            loss_kwargs: Optional[dict] = None, compute_dtype=torch.float32):
    """Student metric loss + cosine distillation to the teacher's embedding,
    on a model that takes ``with_teacher=True`` (models/embedders.py::
    DistillEmbedder): loss = metric(e) + distill_weight mean(1 - <e, t>).
    The teacher runs under ``torch.no_grad()`` unless trainable, so no
    backward reaches it; its parameters keep a zero gradient in the
    optimiser, as the JAX package's do. Returns {"loss", "aux", "distill"}
    as device tensors. ``step.losses(images, labels)`` is the differentiated
    function alone."""
    loss_kwargs = loss_kwargs or {}
    loss_fn = LOSS_FNS[loss_name]

    def losses(images, labels):
        out = _train_forward(model, images.to(compute_dtype), compute_dtype, with_teacher=True)
        emb = out["embedding"].float()
        metric_loss, aux = loss_fn(emb, labels, **loss_kwargs)
        t = out["teacher_embedding"].float()
        if t.shape != emb.shape:
            raise ValueError(
                f"the student's embedding {tuple(emb.shape)} and the teacher's "
                f"{tuple(t.shape)} differ in width: give the student an embedding_dim "
                f"(--embedding-dim) of {t.shape[1]}, the teacher's")
        # the embeddings are unit vectors: 1 - cosine == 0.5 ||e - t||^2
        distill = torch.mean(1.0 - torch.sum(emb * t, dim=1))
        return metric_loss + distill_weight * distill, aux, distill

    def step(state, images, labels):
        loss, aux, distill = losses(images, labels)
        _backward_and_apply(state, loss)
        return {"loss": loss.detach(), "aux": aux.detach(), "distill": distill.detach()}

    step.losses = losses
    return step


def make_it_align_train_step(model, compute_dtype=torch.float32):
    """The MedSigLIP fine-tuning step of the JAX package's
    cli/train_medsiglip.py (there inline): the SigLIP sigmoid loss
    (IT-Align) of a ``MedSigLIPDualEncoder``'s f32 image and text features,
    with its learned logit scale and bias. Only the pixels are cast to
    ``compute_dtype``: the parameters stay f32, so every layer promotes back
    to f32 (flax's ``nn.Dense`` / ``nn.Conv`` promotion, kept by the port's
    layers) and the attention takes K2 / K3 in f32, under
    ``XMIR_FLASH_ATTN=1`` only. No post-step clamp of the logit scale.
    step(state, pixel_values, input_ids) -> {"loss"} as a device tensor;
    ``step.losses`` is the differentiated function alone."""

    def losses(pixel_values, input_ids):
        out = model(pixel_values.to(compute_dtype), input_ids)
        return it_align_loss(out["image_features"].float(), out["text_features"].float(),
                             out["logit_scale"], out["logit_bias"])

    def step(state, pixel_values, input_ids):
        loss = losses(pixel_values, input_ids)
        _backward_and_apply(state, loss)
        return {"loss": loss.detach()}

    step.losses = losses
    return step


def make_ath_train_step(model, batch: int, margin: float = 0.5, ce_weight: float = 1.0):
    """The ATH hashing step of the JAX package's cli/train_ath.py (there
    inline): one training forward of an ``ATHEmbedder`` over the 3B images
    (anchors, positives, negatives), so that the BatchNorm statistics move
    over all of them; ``triplet_hash_loss`` of the three code blocks plus
    ``ce_weight`` x the cross entropy of the anchors' type logits.
    step(state, images (3B, S, S, 3), type_labels (B,)) -> {"loss", "hash",
    "ce"} as device tensors; ``step.losses`` is the differentiated function
    alone."""

    def losses(images, type_labels):
        out = model(images)
        codes, logits = out["hash_codes"], out["logits"]
        hash_loss = triplet_hash_loss(codes[:batch], codes[batch:2 * batch],
                                      codes[2 * batch:], margin)
        ce = F.cross_entropy(logits[:batch], type_labels)
        return hash_loss + ce_weight * ce, hash_loss, ce

    def step(state, images, type_labels):
        loss, hash_loss, ce = losses(images, type_labels)
        _backward_and_apply(state, loss)
        return {"loss": loss.detach(), "hash": hash_loss.detach(), "ce": ce.detach()}

    step.losses = losses
    return step


def dedupe_concept_batch(concept_ids, concept_token_mask=None, bucket: int = 8):
    """Host-side unique-ing of per-sample concept token rows (a copy of the
    JAX package's, numpy only).

    The reference encodes every (b, w) concept string through the text tower
    each step (train.py:175-218), though VinDr's concepts come from a fixed
    vocabulary of 22 names. Returns (unique_ids (U, Lc), unique_token_mask
    (U, Lc), inverse (B, W) int32) with U padded up to a multiple of
    ``bucket``. Padded rows are all [PAD], referenced by no slot of
    ``inverse``, so their gradient is zero. Feed them to a step made with
    ``make_conceptclip_train_step(..., dedupe_concepts=True)``."""
    concept_ids = np.asarray(concept_ids)
    b, w, lc = concept_ids.shape
    flat = concept_ids.reshape(b * w, lc)
    uniq, first, inverse = np.unique(flat, axis=0, return_index=True, return_inverse=True)
    u = uniq.shape[0]
    cap = -(-u // bucket) * bucket
    unique_ids = np.zeros((cap, lc), flat.dtype)
    unique_ids[:u] = uniq
    if concept_token_mask is not None:
        flat_mask = np.asarray(concept_token_mask).reshape(b * w, lc)
        unique_mask = np.zeros((cap, lc), flat_mask.dtype)
        unique_mask[:u] = flat_mask[first]
    else:
        unique_mask = unique_ids != 0
    return unique_ids, unique_mask, inverse.reshape(b, w).astype(np.int32)


class ConceptGather(torch.autograd.Function):
    """unique_feats (U, D), inverse (B, W) int -> (B, W, D) rows of
    unique_feats (``jnp.take(unique_feats, inverse, axis=0)``). The backward
    adds the cotangents of the slots that share a row as one reduction over
    a one-hot (U, B W, D) product, in f32, rounded once to the features'
    dtype: a fixed order, where indexing's own backward adds them with
    atomics on CUDA and two runs of a step would differ in their last
    bits."""

    @staticmethod
    def forward(ctx, unique_feats, inverse):
        ctx.save_for_backward(inverse)
        ctx.rows = unique_feats.shape[0]
        return unique_feats[inverse.long()]

    @staticmethod
    def backward(ctx, g):
        (inverse,) = ctx.saved_tensors
        flat = inverse.reshape(-1).long()
        onehot = (flat[None, :] == torch.arange(ctx.rows, device=g.device)[:, None]).float()
        rows = torch.sum(onehot[:, :, None] * g.reshape(flat.shape[0], -1).float()[None], dim=1)
        return rows.to(g.dtype), None


def make_conceptclip_train_step(model, alpha: float = 0.5, compute_dtype=torch.float32,
                                dedupe_concepts: bool = False):
    """IT-Align + alpha RC-Align on a ``ConceptCLIPModel`` (reference
    train.py:221-397): the image and caption features and the image's patch
    tokens from ``forward_clip``, each concept's features from the text
    tower (``encode_text``), every floating parameter cast to
    ``compute_dtype`` inside autograd (``_train_call``), the loss in f32.
    After the update ``logit_scale`` is clamped to [0, ln 100] in place
    (train.py:361-367).

    step(state, pixel_values, input_ids, attention_mask, concept_ids,
    concept_mask, concept_token_mask=None, concept_inverse=None): the
    concepts are padded (B, W, Lc) token rows, or with
    ``dedupe_concepts=True`` the (U, Lc) rows of ``dedupe_concept_batch``
    with its (U, Lc) token mask and (B, W) inverse: the text tower then
    encodes each distinct concept once and ``ConceptGather`` spreads the
    features over the slots. Without a token mask a concept's [PAD] tokens
    (id 0) are masked. Returns {"loss", "it_loss", "rc_loss"} as device
    tensors; ``step.losses`` is the differentiated function alone."""

    def forward(m, pixel_values, input_ids, attention_mask, concept_ids, concept_token_mask,
                concept_inverse):
        out = m.forward_clip(pixel_values, input_ids, attention_mask)
        if concept_token_mask is None:
            concept_token_mask = concept_ids != 0
        if dedupe_concepts:
            feats = ConceptGather.apply(m.encode_text(concept_ids, concept_token_mask),
                                        concept_inverse)
        else:
            b, w, lc = concept_ids.shape
            feats = m.encode_text(concept_ids.reshape(b * w, lc),
                                  concept_token_mask.reshape(b * w, lc)).reshape(b, w, -1)
        return out, feats

    def losses(pixel_values, input_ids, attention_mask, concept_ids, concept_mask,
               concept_token_mask=None, concept_inverse=None):
        out, feats = _train_call(model, compute_dtype, forward, pixel_values.to(compute_dtype),
                                 input_ids, attention_mask, concept_ids, concept_token_mask,
                                 concept_inverse)
        return conceptclip_loss(out["image_features"].float(), out["text_features"].float(),
                                out["image_token_features"].float(), feats.float(),
                                concept_mask, out["logit_scale"], out["logit_bias"], alpha=alpha)

    def step(state, *batch):
        loss, it, rc = losses(*batch)
        _backward_and_apply(state, loss)
        with torch.no_grad():
            model.logit_scale.clamp_(0.0, LOG_SCALE_MAX)
        return {"loss": loss.detach(), "it_loss": it.detach(), "rc_loss": rc.detach()}

    step.losses = losses
    return step


def with_grad_accumulation(state, accum_steps: int):
    """Make every step call a micro-batch (``optax.MultiSteps``): gradients
    are averaged over ``accum_steps`` calls and parameters and Adam's moments
    move on the last of them. Works with any step that routes its update
    through ``state.apply_gradients``. Returns the state."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps={accum_steps} must be at least 1")
    state.optimizer.accum_steps = accum_steps
    state.optimizer.mini_step = 0
    return state


def make_embed_fn(model, compute_dtype=torch.float32):
    """Inference embedding extractor (the test.py/ingest hot loop):
    images (B, H, W, 3) float -> embeddings (B, D) float32.

    Runs under ``torch.inference_mode()``; with ``compute_dtype=bfloat16`` the
    forward runs under bf16 autocast on the images' device."""

    def embed(images):
        with torch.inference_mode():
            ctx = (torch.autocast(images.device.type, dtype=compute_dtype)
                   if compute_dtype != torch.float32 else contextlib.nullcontext())
            with ctx:
                out = model(images)
            emb = out["embedding"] if isinstance(out, dict) else out
            return emb.float()

    return embed
