"""Train state (port of xmir_tpu/train/state.py): the model, whose
parameters and BatchNorm buffers are the state, its optimiser and a step
count."""
from __future__ import annotations

import dataclasses

import torch

from .optim import GroupedAdam


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: GroupedAdam
    step: int = 0  # every call of apply_gradients, micro-batches included

    def gather_params(self):
        """Make every parameter whole on this device before a forward: a
        no-op here; an FSDP state (parallel/data_parallel.py) gathers its
        shards."""

    def apply_gradients(self):
        """One optimiser call on the parameters' gradients."""
        self.optimizer.step()
        self.step += 1

    def load_optimizer_state(self, state: dict):
        self.optimizer.load_state_dict(state)

    def state_dict(self) -> dict:
        return {"state_dict": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: dict):
        self.model.load_state_dict(state["state_dict"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
