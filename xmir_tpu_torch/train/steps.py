"""Step functions (port of xmir_tpu/train/steps.py): the metric-learning
train step, gradient accumulation and the inference embedding step. The
dual-branch, distillation and ConceptCLIP steps wait for their models.

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
        if compute_dtype == torch.float32:
            out = model(images)
        else:
            tensors = {name: p.to(compute_dtype) if p.is_floating_point() else p
                       for name, p in model.named_parameters()}
            tensors.update(model.named_buffers())
            out = functional_call(model, tensors, (images,))
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
