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

A world may be laid out as the JAX package's two-axis ``(data, model)``
mesh (``make_mesh(device, shape)``): rank r sits at (r // model, r %
model), as ``np.asarray(devices).reshape(shape)`` places devices. Each data
row (the ranks of one batch shard) gets a process group for the model axis,
each model column one for the data axis. The default shape is (world, 1):
then the data axis is the world itself, on the default group, and no group
is made. Batches, gallery rows, gradient sums and the FSDP pieces follow the
data axis (``n_data``, ``data_rank`` and the collectives without a prefix);
``auto_param_shardings`` splits weights over the model axis
(parallel/tensor_parallel.py computes with them).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

FSDP_MIN_SIZE = 65536  # the JAX rule's min_size: smaller leaves replicate
TP_MIN_DIM = 256  # auto_param_shardings' min_dim: narrower axes replicate


@dataclasses.dataclass
class Mesh:
    """One process's view of the (data, model) mesh. ``shape`` None is
    (world, 1); ``data_group`` None is the default group, ``model_group``
    None a model axis of one rank."""

    world: int
    rank: int
    device: torch.device
    owns_group: bool = False
    shape: Optional[Tuple[int, int]] = None
    data_group: Optional[object] = None
    model_group: Optional[object] = None
    made_groups: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.shape = (self.world, 1) if self.shape is None else tuple(int(s) for s in self.shape)
        if len(self.shape) != 2 or self.shape[0] * self.shape[1] != self.world:
            raise ValueError(f"mesh shape {self.shape} != a (data, model) layout of "
                             f"{self.world} ranks")

    @property
    def n_data(self) -> int:
        return self.shape[0]

    @property
    def n_model(self) -> int:
        return self.shape[1]

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model

    def close(self):
        if dist.is_initialized():
            for group in self.made_groups:
                dist.destroy_process_group(group)
        self.made_groups = []
        self.data_group = self.model_group = None
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ----------------------------------------------------------- collectives
    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(n_data, *x.shape): every data rank's ``x`` in rank order (the
        ranks of this rank's model column). Every rank passes a tensor of the
        same shape and dtype."""
        return self._all_gather(x, self.n_data, self.data_group)

    def all_reduce_(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``x`` reduced in place over the data axis."""
        return self._all_reduce_(x, op, self.n_data, self.data_group)

    def model_all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(n_model, *x.shape): every model rank's ``x`` in rank order (the
        ranks of this rank's data row)."""
        return self._all_gather(x, self.n_model, self.model_group)

    def model_all_reduce_(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``x`` reduced in place over the model axis."""
        return self._all_reduce_(x, op, self.n_model, self.model_group)

    # An axis of one rank in a larger world has no group (None would be the
    # whole world): its collectives are the identity. A world of 1 runs them
    # on the default group, as it always has.
    def _all_gather(self, x, n: int, group) -> torch.Tensor:
        x = x.contiguous()
        if n == 1 and self.world > 1:
            return x[None]
        out = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(out, x, group=group)
        return torch.stack(out)

    def _all_reduce_(self, x, op, n: int, group) -> torch.Tensor:
        if n > 1 or self.world == 1:
            dist.all_reduce(x, op=op, group=group)
        return x

    def broadcast_(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``x`` from global rank ``src`` to the whole world, in place."""
        dist.broadcast(x, src=src)
        return x

    def barrier(self):
        if self.device.type == "cuda":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows of ``x``, in rank order, with a gradient:
        the backward hands each rank the gradient of its own rows only, so a
        loss that every rank computes alike on the gathered batch gives each
        rank its rows' share of the world-1 gradient (summed across ranks by
        the gradient reduction, never ``n_data`` times)."""
        return _GatherRows.apply(x, self)

    def all_reduce_with_grad(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over data ranks of ``x``, whose backward is the sum over
        data ranks of the gradient (each rank's statistic feeds every rank's
        loss)."""
        return _AllReduce.apply(x, self)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return mesh.all_gather(x).reshape((mesh.n_data * x.shape[0],) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.data_rank * ctx.rows
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


def make_mesh(device, shape: Optional[Sequence[int]] = None) -> Mesh:
    """The world for ``device`` ('cuda', 'cuda:N' or 'cpu'): torchrun's, an
    already initialised default group, or a world of 1. With CUDA, rank r runs
    on cuda:LOCAL_RANK; a world larger than the visible card count raises.
    ``shape`` is the JAX package's (data, model) mesh shape, (world, 1) when
    None; with a model axis wider than 1 every rank makes the row and column
    groups, all in the same order."""
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
    mesh = Mesh(world=world, rank=rank, device=device, shape=shape)  # checks the shape
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
    mesh.device, mesh.owns_group = device, owns
    n_data, n_model = mesh.shape
    if n_model > 1:
        # one group per data row (the model axis), then one per model column
        # (the data axis); dist.new_group is collective, so every rank makes all
        for d in range(n_data):
            group = dist.new_group(list(range(d * n_model, (d + 1) * n_model)))
            mesh.made_groups.append(group)
            if d == mesh.data_rank:
                mesh.model_group = group
        for m in range(n_model):
            group = dist.new_group(list(range(m, world, n_model)))
            mesh.made_groups.append(group)
            if m == mesh.model_rank:
                mesh.data_group = group
    return mesh


def shard_batch(x: torch.Tensor, mesh: Mesh):
    """Pad the batch with zero rows to a multiple of the data axis and return
    (this rank's rows, the real batch size); the ranks of one data row get
    the same rows. Inference only: the caller slices the gathered outputs
    back to the real size, and a training loss must never see the zero
    rows."""
    b = x.shape[0]
    pad = (-b) % mesh.n_data
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    rows = x.shape[0] // mesh.n_data
    return x[mesh.data_rank * rows:(mesh.data_rank + 1) * rows], b


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


def fsdp_state_shardings(tree: Dict[str, torch.Tensor], world: Union[int, Mesh],
                         min_size: int = FSDP_MIN_SIZE) -> Dict[str, Optional[int]]:
    """``fsdp_shard_axis`` of every tensor of a name -> tensor mapping (a
    state dict): name -> the sharded axis, or None where it replicates.
    ``world`` is the data axis's size, or a mesh, whose data axis it reads
    (the JAX rule's ``mesh.shape[DATA_AXIS]``)."""
    if isinstance(world, Mesh):
        world = world.n_data
    return {name: fsdp_shard_axis(t.shape, t.dtype, world, min_size)
            for name, t in tree.items()}


# Where a JAX axis lands in the torch layout, for each kind of leaf: flax's
# Dense kernel is (in, out) where nn.Linear's weight is (out, in); a flax
# conv kernel is HWIO where nn.Conv2d's is OIHW; every other leaf keeps its
# layout (``_TORCH_AXIS[kind][jax axis] = torch axis``).
_TORCH_AXIS = {"linear": (1, 0), "conv": (2, 3, 1, 0)}
# nn.MultiheadAttention's name for its packed in-projection (3D, D): three
# (D, D) Linear weights, q | k | v along torch axis 0, where the JAX modules
# hold three Dense kernels (SigLIP's pooling head: attn_q / attn_k / attn_v)
PACKED_IN_PROJ = "in_proj_weight"


def tp_shard_axis(shape, kind: str, n_model: int, min_dim: int = TP_MIN_DIM) -> Optional[int]:
    """The JAX ``auto_param_shardings`` rule for one leaf of torch shape
    ``shape``: decided in the JAX layout (the widest axis, ties to the first
    as ``np.argmax`` takes them, sharded where it is at least ``min_dim``
    wide and ``n_model`` divides it), and returned as the torch axis. Leaves
    of fewer than 2 axes, and every leaf at a model axis of 1, replicate
    (None). ``kind``: "linear", "conv", "same" (the layouts agree) or
    "packed_in_proj" (a (3D, D) ``in_proj_weight``): a packed in-projection
    is decided on one of its (D, D) Linear blocks, as the JAX rule decides
    each of the three Dense kernels; the rule's axis there is the block's
    input (its tie goes to the first JAX axis), torch axis 1, and a split of
    the packed leaf along axis 1 is each block's split."""
    shape = tuple(int(s) for s in shape)
    if kind == "packed_in_proj":
        if len(shape) != 2 or shape[0] != 3 * shape[1]:
            raise ValueError(f"a packed in-projection must be (3D, D), got {shape}")
        shape, kind = (shape[1], shape[1]), "linear"
    if len(shape) < 2 or n_model <= 1:
        return None
    to_torch = _TORCH_AXIS.get(kind, tuple(range(len(shape))))
    if len(to_torch) != len(shape):
        raise ValueError(f"a {kind} leaf of shape {shape}")
    jax_shape = [shape[t] for t in to_torch]
    widest = max(range(len(jax_shape)), key=lambda j: (jax_shape[j], -j))
    if jax_shape[widest] >= min_dim and jax_shape[widest] % n_model == 0:
        return to_torch[widest]
    return None


def _leaf_kinds(module_or_state_dict) -> Dict[str, Tuple[torch.Tensor, str]]:
    """name -> (tensor, kind) of every parameter of a module (the JAX
    rule's ``params``), or of every tensor of a state dict. A module's kinds
    come from its layers' types (an ``nn.Linear``'s or ``nn.Conv2d``'s
    weight); a bare state dict's from the names: a 2-axis ``*weight`` is a
    Linear's, a 4-axis one a convolution's. In both, a leaf named
    ``in_proj_weight`` (``PACKED_IN_PROJ``: nn.MultiheadAttention's layout,
    which SigLIP's pooling head keeps) is a packed in-projection."""
    if isinstance(module_or_state_dict, nn.Module):
        out = {}
        for prefix, mod in module_or_state_dict.named_modules():
            kind = ("linear" if isinstance(mod, nn.Linear)
                    else "conv" if isinstance(mod, nn.Conv2d) else "same")
            for name, t in mod.named_parameters(recurse=False):
                key = f"{prefix}.{name}" if prefix else name
                out[key] = (t, "packed_in_proj" if name == PACKED_IN_PROJ
                            else kind if name == "weight" else "same")
        return out
    out = {}
    for key, t in module_or_state_dict.items():
        kind = "same"
        if key.endswith(PACKED_IN_PROJ):
            kind = "packed_in_proj"
        elif key.endswith("weight"):
            kind = {2: "linear", 4: "conv"}.get(t.dim(), "same")
        out[key] = (t, kind)
    return out


def auto_param_shardings(module_or_state_dict, mesh: Mesh,
                         min_dim: int = TP_MIN_DIM) -> Dict[str, Optional[int]]:
    """The JAX package's tensor-parallel rule (xmir_tpu/parallel/mesh.py
    ``auto_param_shardings``) on a module or a name -> tensor mapping: name
    -> the torch axis split over ``mesh``'s model axis, or None where the
    leaf replicates (``tp_shard_axis``)."""
    return {name: tp_shard_axis(t.shape, kind, mesh.n_model, min_dim)
            for name, (t, kind) in _leaf_kinds(module_or_state_dict).items()}
