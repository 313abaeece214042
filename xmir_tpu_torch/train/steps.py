"""Step functions (port of xmir_tpu/train/steps.py): the metric-learning
train step, the NIH dual-branch and the distillation steps, gradient
accumulation and the inference embedding step. The ConceptCLIP step waits
for its model.

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

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..losses import (
    asymmetric_loss,
    jaccard_supcon_loss,
    multilabel_contrastive_loss,
    supcon_loss,
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


def _train_forward(model, images, compute_dtype, **kwargs):
    """``model``'s output in training on ``images`` (already in
    ``compute_dtype``): directly in f32, else on ``compute_dtype`` copies of
    the floating parameters made inside autograd (buffers uncast)."""
    if compute_dtype == torch.float32:
        return model(images, **kwargs)
    tensors = {name: p.to(compute_dtype) if p.is_floating_point() else p
               for name, p in model.named_parameters()}
    tensors.update(model.named_buffers())
    return functional_call(model, tensors, (images,), kwargs)


def _backward_and_apply(state, loss):
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.apply_gradients()


def make_embedding_train_step(model, loss_name: str = "triplet",
                              loss_kwargs: Optional[dict] = None,
                              compute_dtype=torch.float32, remat: bool = False):
    """Generic metric-learning step (reference train_epoch, train.py:47-148):
    step(state, images, labels) runs ``model`` in training mode on the
    images, takes the loss of its embeddings, back-propagates and calls
    ``state.apply_gradients()``. Returns {"loss", "aux"} as device tensors:
    nothing here waits for the device.

    remat=True recomputes the forward pass during the backward
    (``torch.utils.checkpoint``): activation memory drops to the model's
    inputs and outputs at the cost of one more forward. BatchNorm buffers
    move once a step all the same. ``step.loss_and_aux(images, labels)`` is
    the differentiated function alone (forward and loss), for measurements."""
    loss_kwargs = loss_kwargs or {}
    loss_fn = LOSS_FNS[loss_name]

    def forward(images):
        out = _train_forward(model, images, compute_dtype)
        emb = out["embedding"] if isinstance(out, dict) else out
        return emb.float()

    def loss_and_aux(images, labels):
        images = images.to(compute_dtype)
        emb = checkpoint(forward, images, use_reentrant=False) if remat else forward(images)
        return loss_fn(emb, labels, **loss_kwargs)

    def step(state, images, labels):
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
                                compute_dtype=torch.float32):
    """NIH dual-head step (reference nih_multilabel_retrieval.py:308-348):
    the Jaccard-weighted multi-label contrastive loss of the f32 embedding
    plus ``asl_alpha`` times the asymmetric loss of the f32 logits, on a
    model whose output holds "embedding" and "logits". Returns {"loss",
    "contrastive", "asl"} as device tensors. ``step.losses(images, labels)``
    is the differentiated function alone."""

    def losses(images, labels):
        out = _train_forward(model, images.to(compute_dtype), compute_dtype)
        contrastive = multilabel_contrastive_loss(out["embedding"].float(), labels, temperature)
        asl = asymmetric_loss(out["logits"].float(), labels, gamma_pos, gamma_neg, clip)
        return contrastive_weight * contrastive + asl_alpha * asl, contrastive, asl

    def step(state, images, labels):
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
