"""Data-parallel and FSDP training over a mesh (the port of what the JAX
package gets from jit over a sharded batch and ``fsdp_state_shardings``).

A step runs as in JAX's mesh: every rank embeds its rows of the global
batch, the loss is taken on the gathered global batch (train/steps.py), and
BatchNorm normalises by the global batch's statistics (sync_batch_norm).
``MeshTrainState.apply_gradients`` then sums the ranks' gradients, so the
update is the world-1 update.

With ``fsdp`` each optimised leaf that the JAX rule shards
(mesh.fsdp_shard_axis: floating, at least 65,536 elements) is held between
steps as this rank's 1/world piece of the flat leaf (padded to equal
pieces): its f32 master weights and both Adam moments. The whole leaf is
gathered into the model before a forward (``gather_params``) and freed after
the update; its gradient is summed across ranks and this rank's piece taken.
Replicated leaves stay whole on every rank. A checkpoint (``state_dict``) is
whole, in the world-1 layout, and ``load_optimizer_state`` reads one's
optimiser state (the model loads its parameters before the state is made).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..models.densenet import BatchNorm2d
from ..train.state import TrainState
from .mesh import Mesh, fsdp_shard_axis, replicate_tree


def sync_batch_norm(model: torch.nn.Module, mesh: Optional[Mesh]):
    """Point every BatchNorm2d of ``model`` at ``mesh``: in training their
    statistics become the global batch's (models/densenet.py)."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.mesh = mesh
    return model


@dataclasses.dataclass
class _Shard:
    param: torch.nn.Parameter  # the model's leaf, whole only between gather and update
    master: torch.Tensor  # this rank's f32 piece of the flat leaf
    shape: torch.Size
    numel: int


@dataclasses.dataclass
class MeshTrainState(TrainState):
    """A TrainState over a data-parallel mesh. Every rank starts from rank
    0's parameters and buffers."""

    mesh: Optional[Mesh] = None
    fsdp: bool = False

    def __post_init__(self):
        if self.mesh is None:
            raise ValueError("MeshTrainState needs a mesh")
        replicate_tree(self.model, self.mesh)
        self._shards: List[Optional[_Shard]] = []  # per optimiser tensor, in state order
        self._gathered = True
        for group in self.optimizer.param_groups:
            for i, p in enumerate(group["params"]):
                if not self.fsdp or fsdp_shard_axis(p.shape, p.dtype, self.mesh.n_data) is None:
                    self._shards.append(None)
                    continue
                shard = _Shard(p, self._piece(p.detach()), p.shape, p.numel())
                group["params"][i] = shard.master
                self.optimizer.sharded.add(id(shard.master))
                self._shards.append(shard)
        self.optimizer.mesh = self.mesh
        self._release()

    # ----------------------------------------------------------- pieces
    def _piece(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of ``full``'s flat elements, zero-padded to
        equal pieces."""
        world, rank = self.mesh.n_data, self.mesh.data_rank
        chunk = -(-full.numel() // world)
        flat = full.reshape(-1)
        flat = torch.cat([flat, flat.new_zeros(chunk * world - flat.numel())])
        return flat[rank * chunk:(rank + 1) * chunk].clone()

    def _whole(self, piece: torch.Tensor, shard: _Shard) -> torch.Tensor:
        return self.mesh.all_gather(piece).reshape(-1)[:shard.numel].reshape(shard.shape)

    def sharded(self) -> List[_Shard]:
        return [s for s in self._shards if s is not None]

    def _release(self):
        for s in self.sharded():
            s.param.data = s.param.data.new_empty(0)
        self._gathered = not self.sharded()

    def gather_params(self):
        if self._gathered:
            return
        with torch.no_grad():
            for s in self.sharded():
                s.param.data = self._whole(s.master, s)
        self._gathered = True

    # ----------------------------------------------------------- the step
    def apply_gradients(self):
        """Sum the ranks' gradients (a sharded leaf's into its piece), one
        optimiser call, then free the sharded leaves until the next
        forward."""
        shards = {id(s.param): s for s in self.sharded()}
        with torch.no_grad():
            for p in self.model.parameters():
                if p.grad is None:
                    continue
                self.mesh.all_reduce_(p.grad)
                s = shards.get(id(p))
                if s is not None:
                    s.master.grad = self._piece(p.grad)
                    p.grad = None
        self.optimizer.step()
        self.step += 1
        self._release()

    def sharded_state_bytes(self) -> int:
        """Bytes this rank holds for the sharded leaves between steps: their
        master pieces, both moments' pieces, and what is left of the leaves
        in the model."""
        total = 0
        for s in self.sharded():
            state = self.optimizer.state.get(s.master, {})
            total += s.master.numel() * s.master.element_size()
            total += s.param.data.numel() * s.param.data.element_size()
            total += sum(state[k].numel() * state[k].element_size()
                         for k in ("mu", "nu") if k in state)
        return total

    # ----------------------------------------------------------- checkpoints
    def state_dict(self) -> dict:
        """The whole state in the world-1 layout (a collective: every rank
        calls it; rank 0 writes it)."""
        self.gather_params()
        opt = self.optimizer.state_dict()
        for i, s in enumerate(self._shards):
            if s is None or i not in opt["state"]:
                continue
            opt["state"][i] = {k: (self._whole(v, s) if torch.is_tensor(v) and v.dim() else v)
                               for k, v in opt["state"][i].items()}
        return {"state_dict": self.model.state_dict(), "optimizer": opt, "step": self.step}

    def load_optimizer_state(self, state: dict):
        """Load a world-1 optimiser state: each sharded leaf's moments are
        cut to this rank's piece."""
        state = dict(state, state=dict(state["state"]))
        for i, s in enumerate(self._shards):
            if s is None or i not in state["state"]:
                continue
            state["state"][i] = {k: (self._piece(v.to(s.master.device))
                                     if torch.is_tensor(v) and v.dim() else v)
                                 for k, v in state["state"][i].items()}
        self.optimizer.load_state_dict(state)
