"""The data-parallel world: ``--use-mesh`` on torch.distributed (port of
xmir_tpu/parallel/mesh.py).

In the JAX package ``--use-mesh`` builds a one-axis ``data`` mesh over the
devices of one process, and XLA inserts the collectives. Here the axis is a
torch.distributed world of processes, one card each:

  - under ``torchrun`` the world is read from RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR and MASTER_PORT;
  - without them the world is 1, on an in-process ``HashStore`` (no port, no
    network);
  - a caller that has already initialised the default process group (a test
    on a ``FileStore``) keeps it, and the mesh neither re-creates nor
    destroys it.

The backend follows the device: NCCL on ``cuda`` (rank r on
``cuda:LOCAL_RANK``), gloo on ``cpu``. Nothing picks the CPU on its own. A
``Mesh`` is closed (its process group destroyed, where it made one) by
``close()`` or by leaving its ``with`` block, so that several CLIs can run in
one process.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

FSDP_MIN_SIZE = 65536  # the JAX rule's min_size: smaller leaves replicate


@dataclasses.dataclass
class Mesh:
    """One process's view of the data-parallel world."""

    world: int
    rank: int
    device: torch.device
    owns_group: bool = False

    def close(self):
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ----------------------------------------------------------- collectives
    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(world, *x.shape): every rank's ``x`` in rank order. Every rank
        passes a tensor of the same shape and dtype."""
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(out, x)
        return torch.stack(out)

    def all_reduce_(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        dist.all_reduce(x, op=op)
        return x

    def broadcast_(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        dist.broadcast(x, src=src)
        return x

    def barrier(self):
        if self.device.type == "cuda":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``x``, in rank order, with a gradient: the
        backward hands each rank the gradient of its own rows only, so a loss
        that every rank computes alike on the gathered batch gives each rank
        its rows' share of the world-1 gradient (summed across ranks by the
        gradient reduction, never ``world`` times)."""
        return _GatherRows.apply(x, self)

    def all_reduce_with_grad(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of ``x``, whose backward is the sum over ranks of
        the gradient (each rank's statistic feeds every rank's loss)."""
        return _AllReduce.apply(x, self)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return mesh.all_gather(x).reshape((mesh.world * x.shape[0],) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.rank * ctx.rows
        return g[lo:lo + ctx.rows], None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.contiguous().clone()), None


def _env_world() -> Optional[Tuple[int, int, int]]:
    """(rank, world, local rank) from torchrun's variables, or None."""
    if "WORLD_SIZE" not in os.environ:
        return None
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ.get("RANK", "0"))
    return rank, world, int(os.environ.get("LOCAL_RANK", str(rank)))


def make_mesh(device) -> Mesh:
    """The world for ``device`` ('cuda', 'cuda:N' or 'cpu'): torchrun's, an
    already initialised default group, or a world of 1. With CUDA, rank r runs
    on cuda:LOCAL_RANK; a world larger than the visible card count raises."""
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        local = int(os.environ.get("LOCAL_RANK", str(rank)))
        owns = False
    else:
        env = _env_world()
        rank, world, local = env if env else (0, 1, device.index or 0)
        owns = True
    if device.type == "cuda":
        visible = torch.cuda.device_count()
        if world > visible:
            raise ValueError(f"a world of {world} ranks needs {world} cards; "
                             f"{visible} are visible")
        device = torch.device("cuda", local if world > 1 or device.index is None
                              else device.index)
        torch.cuda.set_device(device)
    if owns:
        if world == 1 and _env_world() is None:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        else:
            dist.init_process_group(backend, init_method="env://", rank=rank,
                                    world_size=world)
    return Mesh(world=world, rank=rank, device=device, owns_group=owns)


def shard_batch(x: torch.Tensor, mesh: Mesh):
    """Pad the batch with zero rows to a multiple of the world and return
    (this rank's rows, the real batch size). Inference only: the caller
    slices the gathered outputs back to the real size, and a training loss
    must never see the zero rows."""
    b = x.shape[0]
    pad = (-b) % mesh.world
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    rows = x.shape[0] // mesh.world
    return x[mesh.rank * rows:(mesh.rank + 1) * rows], b


def replicate_tree(tree, mesh: Mesh):
    """Broadcast every tensor of ``tree`` (a module, a dict or a list of
    tensors) from rank 0, in place, so that every rank starts alike."""
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.state_dict().values())
    elif isinstance(tree, dict):
        tensors = list(tree.values())
    else:
        tensors = list(tree)
    with torch.no_grad():
        for t in tensors:
            if torch.is_tensor(t):
                mesh.broadcast_(t)
    return tree


def fsdp_shard_axis(shape, dtype: torch.dtype, world: int,
                    min_size: int = FSDP_MIN_SIZE) -> Optional[int]:
    """The JAX ``fsdp_state_shardings`` rule for one leaf: a floating leaf
    of at least ``min_size`` elements shards its largest axis that the world
    divides (the first such in the order of decreasing size); any other
    leaf, and every leaf at a world of 1, replicates (None)."""
    shape = tuple(int(s) for s in shape)
    numel = 1
    for s in shape:
        numel *= s
    if world <= 1 or not shape or numel < min_size or not dtype.is_floating_point:
        return None
    for ax in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[ax] % world == 0:
            return ax
    return None


def fsdp_state_shardings(tree: Dict[str, torch.Tensor], world: int,
                         min_size: int = FSDP_MIN_SIZE) -> Dict[str, Optional[int]]:
    """``fsdp_shard_axis`` of every tensor of a name -> tensor mapping (a
    state dict): name -> the sharded axis, or None where it replicates."""
    return {name: fsdp_shard_axis(t.shape, t.dtype, world, min_size)
            for name, t in tree.items()}
