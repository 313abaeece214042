"""Optimiser construction: per-part learning rates, frozen leaves, gradient
clipping (port of xmir_tpu/train/optim.py).

The JAX package builds ``optax.multi_transform`` over three labels, each with
its own chain ``clip_by_global_norm -> adam(w)``; ``GroupedAdam`` is that
transformation as one ``torch.optim.Optimizer``:

  - every parameter is "backbone" (its dotted name starts with a backbone
    prefix), "head", or "frozen" (the predicate says so);
  - the clip sits inside each group's chain: "backbone" and "head" are each
    clipped by their OWN global norm, by min(1, clip / norm) with no epsilon
    (``torch.nn.utils.clip_grad_norm_`` over the model is a different
    result: one norm, and 1e-6 added to it);
  - frozen parameters get no update and take no part in any norm: they are
    left out of the optimiser and stop requiring grad, so the backward does
    not reach them;
  - Adam is optax's: m_hat / (sqrt(v_hat) + 1e-8) with b1 = 0.9, b2 = 0.999;
    with ``weight_decay`` it is decoupled, -lr (adam + wd p);
  - ``mu_dtype`` keeps the first moment in that dtype (the second stays f32);
  - with ``accum_steps`` = k (``optax.MultiSteps``) every call adds the
    gradients into a running mean and parameters and moments move on the
    k-th call only;
  - under FSDP (parallel/data_parallel.py) some of a group's tensors are a
    rank's shards of a parameter (``sharded``): their squared sums are added
    across the ranks (``mesh``) before the clip, and a replicated tensor
    counts once, so the clip is the world-1 group's own global norm.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def label_params(names: Sequence[str], classify: Callable[[str], str]) -> Dict[str, str]:
    """Label each parameter by classify(dotted name)."""
    return {name: classify(name) for name in names}


def backbone_head_labels(names: Sequence[str], backbone_prefixes: Sequence[str] = ("backbone",)):
    return label_params(names, lambda name: "backbone" if name.startswith(
        tuple(backbone_prefixes)) else "head")


class GroupedAdam(torch.optim.Optimizer):
    """Adam(W) over named groups, each clipped by its own global norm (module
    docstring). ``groups``: {label: (parameters, learning rate)}. Nothing in
    ``step`` waits for the device."""

    def __init__(self, groups, clip_norm: float = 5.0, weight_decay: float = 0.0,
                 mu_dtype: Optional[torch.dtype] = None, accum_steps: int = 1):
        if accum_steps < 1:
            raise ValueError(f"accum_steps={accum_steps} must be at least 1")
        param_groups = [{"params": list(params), "name": label, "lr": lr}
                        for label, (params, lr) in groups.items() if params]
        defaults = {"clip_norm": clip_norm, "weight_decay": weight_decay, "count": 0}
        super().__init__(param_groups, defaults)
        self.mu_dtype = mu_dtype
        self.accum_steps = accum_steps
        self.mini_step = 0
        self.mesh = None
        self.sharded = set()  # ids of the tensors that are one rank's shard

    def _state_lists(self, params):
        """(first moments, second moments) of ``params``, made at first use."""
        for p in params:
            state = self.state[p]
            if "mu" not in state:
                state["mu"] = torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                state["nu"] = torch.zeros_like(p)
        return [self.state[p]["mu"] for p in params], [self.state[p]["nu"] for p in params]

    @torch.no_grad()
    def step(self):
        """One call of the transformation on the parameters' ``.grad``. A
        parameter without a gradient counts as a zero gradient, as a leaf the
        loss does not reach does in the JAX package. The update runs as
        ``torch._foreach`` calls over a group's tensors: a few dozen launches
        a group, not a dozen a tensor."""
        groups = [(group, group["params"]) for group in self.param_groups]
        for _, params in groups:
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        accumulated = self.accum_steps > 1
        if accumulated:
            for _, params in groups:
                for p in params:
                    if "acc" not in self.state[p]:
                        self.state[p]["acc"] = torch.zeros_like(p)
                accs = [self.state[p]["acc"] for p in params]
                # the running mean of optax.MultiSteps
                diff = torch._foreach_sub([p.grad for p in params], accs)
                torch._foreach_div_(diff, self.mini_step + 1)
                torch._foreach_add_(accs, diff)
            self.mini_step += 1
            if self.mini_step < self.accum_steps:
                return
            self.mini_step = 0
        b1, b2 = BETAS
        # b1 mu is a product in mu's own dtype, b1 itself rounded to it (JAX's
        # weak typing), before the f32 gradient is added
        decay = torch.tensor(b1, dtype=self.mu_dtype or torch.float32).item()
        for group, params in groups:
            grads = [self.state[p]["acc"] if accumulated else p.grad for p in params]
            norm = self._global_norm(params, grads)
            clip = group["clip_norm"]
            factor = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
            grads = torch._foreach_mul(grads, factor)
            group["count"] += 1
            c1, c2 = 1 - b1 ** group["count"], 1 - b2 ** group["count"]
            mus, nus = self._state_lists(params)
            torch._foreach_mul_(mus, decay)
            mu32 = [mu.to(g.dtype) for mu, g in zip(mus, grads)]  # mus themselves when f32
            torch._foreach_add_(mu32, grads, alpha=1 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1 - b2)
            denom = torch._foreach_div(nus, c2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, ADAM_EPS)
            update = torch._foreach_div(mu32, c1)
            torch._foreach_div_(update, denom)
            if group["weight_decay"]:
                torch._foreach_add_(update, params, alpha=group["weight_decay"])
            torch._foreach_add_(params, update, alpha=-group["lr"])
            if self.mu_dtype not in (None, torch.float32):
                torch._foreach_copy_(mus, mu32)
            if accumulated:
                torch._foreach_zero_([self.state[p]["acc"] for p in params])

    def _global_norm(self, params, grads):
        norms = torch.stack(torch._foreach_norm(grads))
        shard = [id(p) in self.sharded for p in params]
        if not any(shard):
            return torch.linalg.vector_norm(norms)
        sq = norms * norms
        mask = torch.tensor(shard, device=sq.device)
        sharded = self.mesh.all_reduce_(torch.where(mask, sq, 0.0).sum())
        return torch.sqrt(sharded + torch.where(mask, 0.0, sq).sum())

    def state_dict(self):
        out = super().state_dict()
        out["mini_step"] = self.mini_step
        return out

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.mini_step = int(state_dict.pop("mini_step", 0))
        super().load_state_dict(state_dict)
        # torch casts loaded state to the parameter's dtype: a first moment
        # kept in ``mu_dtype`` goes back to it (exactly: its values came from it)
        if self.mu_dtype is not None:
            for state in self.state.values():
                if "mu" in state:
                    state["mu"] = state["mu"].to(self.mu_dtype)


def build_optimizer(model: torch.nn.Module, lr: float = 1e-4, backbone_lr_scale: float = 0.1,
                    clip_norm: float = 5.0, weight_decay: float = 0.0,
                    backbone_prefixes: Sequence[str] = ("backbone",),
                    frozen_predicate: Optional[Callable[[str], bool]] = None,
                    mu_dtype: Optional[torch.dtype] = None) -> GroupedAdam:
    """Adam(W) with gradient clipping, per-part learning rates and optional
    frozen leaves over ``model``'s parameters, labelled by their dotted names
    (``backbone.blocks.11.attn.qkv.weight``).

    frozen_predicate(name) -> True freezes that parameter: it is left out of
    the optimiser and ``requires_grad`` is turned off on it (the JAX package
    zeroes its update instead; the result is the same and the backward is
    shorter). mu_dtype: dtype of Adam's FIRST moment (optax's ``mu_dtype``);
    None keeps the parameter's."""
    groups = {"backbone": [], "head": []}
    for name, p in model.named_parameters():
        if frozen_predicate is not None and frozen_predicate(name):
            p.requires_grad_(False)
        elif name.startswith(tuple(backbone_prefixes)):
            groups["backbone"].append(p)
        else:
            groups["head"].append(p)
    return GroupedAdam({"backbone": (groups["backbone"], lr * backbone_lr_scale),
                        "head": (groups["head"], lr)},
                       clip_norm=clip_norm, weight_decay=weight_decay, mu_dtype=mu_dtype)


def unfreeze_last_blocks_predicate(
    num_blocks_total: int,
    unfreeze_blocks: int,
    block_prefix: str = "backbone.blocks.",
    always_trainable: Sequence[str] = ("backbone.norm.", "fc.", "head.", "projection."),
):
    """Freeze everything in the backbone except the last N transformer blocks
    and the final norm (reference DinoV2 policy, model.py:465-482). Names are
    the port's dotted ones; a block's prefix ends in a dot, so ``blocks.1.``
    does not match ``blocks.11.``."""
    trainable_blocks = tuple(f"{block_prefix}{i}." for i in
                             range(num_blocks_total - unfreeze_blocks, num_blocks_total))

    def frozen(name: str) -> bool:
        if name.startswith(tuple(always_trainable)) or name.startswith(trainable_blocks):
            return False
        return name.startswith("backbone")

    return frozen
