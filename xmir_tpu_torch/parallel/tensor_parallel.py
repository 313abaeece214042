"""Tensor parallelism over the mesh's model axis: the port of what the JAX
package gets from ``auto_param_shardings`` and GSPMD.

In JAX the rule annotates each large kernel's widest axis with ``model`` and
XLA partitions the products and places the collectives. Here
``tensor_parallel(model, mesh)`` applies the same rule
(mesh.auto_param_shardings) and rewrites the model in place, keeping each
rank's piece of every sharded leaf and freeing the whole tensor:

  - an ``nn.Linear`` or ``nn.Conv2d`` split by its output
    (``ShardedLinear`` / ``ShardedConv2d``, column-parallel) computes the
    rank's output features or channels from the whole input and all-gathers
    them;
  - one split by its input (row-parallel) takes the rank's slice of the
    input, computes a partial product, all-reduces it in f32, rounds once to
    the activation's dtype and adds the bias once, after the sum;
  - any other sharded leaf (the ViT's ``pos_embed`` and ``cls_token``) is
    held as its pieces and read back whole through a parametrization
    (``GatheredWhole``), and a split layer's weight that a caller reads whole
    (a kernel that takes the weight, such as K9's depthwise convolution, or
    K7 in a ViT block whose heads do not split evenly) is gathered likewise:
    gathered where it is used, as GSPMD gathers around an opaque custom
    call. ``GATHERS`` counts these by leaf name;
  - a ViT block whose heads split evenly over the axis becomes a
    ``ShardedViTBlock``, Megatron's layout: qkv's rows cut head-major
    (``head_major_rows``, a permutation of the rule's pieces along the same
    axis), so that K8 on a rank's piece gives its heads' q, k and v and K2
    runs on them with no collective; proj's rows of those heads; then fc1's
    columns and fc2's rows with no collective between them. A block sums
    twice over the axis and gathers nothing.

Every collective is an ``autograd.Function`` whose backward is right when
every rank of a data row computes the same loss, so each rank ends with the
whole gradient of every replicated leaf and its piece's of every sharded
one: the gather's backward takes the rank's slice, the sum's backward is the
identity, and every replicated tensor that enters a rank's piece of work
goes through ``copy``, whose backward sums the ranks' partial gradients.
(A sum whose backward sums again hands each rank tp times the gradient.)

The collectives are kept apart from the arithmetic: a layer is written as a
function of (rank, inputs) that reads the rank's pieces, and a ``ModelAxis``
runs it and combines. ``DistributedAxis`` runs this process's rank and
combines over the mesh's model group; ``LocalAxis`` runs every rank's piece
in one process and combines with ``torch.cat`` and an f32 sum in rank order,
which checks the pieces' arithmetic on one card (chip_smoke.py phase 55).
"""
from __future__ import annotations

import collections
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize

from ..models.activations import adaptive_gelu
from ..models.vit import ViTBlock
from ..ops.convnext_block import linear_f32
from ..ops.ln_dense import ln_dense_fused
from ..ops.plain_attn import flash_attention_plain, plain_flash_enabled
from .mesh import TP_MIN_DIM, Mesh, auto_param_shardings

GATHERS: collections.Counter = collections.Counter()  # gathers at use, by leaf name


# --------------------------------------------------------------- collectives
class _Copy(torch.autograd.Function):
    """Identity; the backward sums the model ranks' gradients (in f32)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        total = ctx.mesh.model_all_reduce_(g.float().contiguous().clone())
        return total.to(g.dtype), None


class _Gather(torch.autograd.Function):
    """The model ranks' pieces concatenated along ``dim`` in rank order; the
    backward takes this rank's slice."""

    @staticmethod
    def forward(ctx, piece, dim, mesh):
        ctx.dim, ctx.size, ctx.rank = dim, piece.shape[dim], mesh.model_rank
        return torch.cat(list(mesh.model_all_gather(piece).unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size).contiguous(), None, None


class _Sum(torch.autograd.Function):
    """The f32 sum of the model ranks' partials; the backward is the
    identity."""

    @staticmethod
    def forward(ctx, partial, mesh):
        ctx.mesh = mesh
        return mesh.model_all_reduce_(partial.float().contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class ModelAxis:
    """The model axis as a layer sees it: ``tp`` ranks, the ones whose pieces
    this process holds (``ranks``), and how their results combine."""

    tp: int
    ranks: tuple

    def copy(self, t):
        raise NotImplementedError

    def gather(self, pieces, dim: int):
        raise NotImplementedError

    def sum(self, partials):
        raise NotImplementedError

    def column(self, fn, *inputs, dim: int = -1):
        """``fn(r, *inputs)`` of every rank, concatenated along ``dim`` in
        rank order."""
        inputs = [None if t is None else self.copy(t) for t in inputs]
        return self.gather([fn(r, *inputs) for r in self.ranks], dim)

    def row(self, fn, *inputs):
        """The f32 sum over ranks of ``fn(r, *inputs)``."""
        inputs = [None if t is None else self.copy(t) for t in inputs]
        return self.sum([fn(r, *inputs).float() for r in self.ranks])

    def row_with_bias(self, fn, bias, dtype, *inputs):
        """A row-parallel layer's output: ``row``'s f32 sum, plus the bias
        (once, after the sum) in f32, rounded once to ``dtype``."""
        out = self.row(fn, *inputs)
        if bias is not None:
            out = out + bias.float()
        return out.to(dtype)


class DistributedAxis(ModelAxis):
    """This process's rank of the mesh's model axis; the collectives run
    over its model group."""

    def __init__(self, mesh: Mesh):
        self.mesh, self.tp, self.ranks = mesh, mesh.n_model, (mesh.model_rank,)

    def copy(self, t):
        return _Copy.apply(t, self.mesh)

    def gather(self, pieces, dim: int):
        (piece,) = pieces
        return _Gather.apply(piece, dim % piece.dim(), self.mesh)

    def sum(self, partials):
        (partial,) = partials
        return _Sum.apply(partial, self.mesh)


class LocalAxis(ModelAxis):
    """Every rank of a model axis of ``tp`` in this process: the pieces'
    results joined by ``torch.cat`` and summed in f32 in rank order."""

    def __init__(self, tp: int):
        self.tp, self.ranks = tp, tuple(range(tp))

    def copy(self, t):
        return t

    def gather(self, pieces, dim: int):
        return torch.cat(pieces, dim=dim)

    def sum(self, partials):
        out = partials[0].float()
        for p in partials[1:]:
            out = out + p.float()
        return out


# --------------------------------------------------------------- sharded leaves
class ShardedLeaf(nn.Module):
    """The pieces of one leaf split along ``dim``: rank r holds
    [r size, (r + 1) size) of it, taken after ``order`` (a permutation of
    the axis, or None) where one is given, for each rank of ``axis`` this
    process holds. ``whole()`` gathers it where it is used (counted in
    GATHERS), in the leaf's own order."""

    def __init__(self, full: torch.Tensor, dim: int, axis: ModelAxis, name: str,
                 order: Optional[torch.Tensor] = None):
        super().__init__()
        if full.shape[dim] % axis.tp:
            raise ValueError(f"{name}: axis {dim} of {tuple(full.shape)} does not split "
                             f"into {axis.tp}")
        self.dim, self.axis, self.name = dim, axis, name
        self.size = full.shape[dim] // axis.tp
        grad, full = full.requires_grad, full.detach()
        if order is not None:
            full = full.index_select(dim, order.to(full.device))
            order = order.to(full.device)
        self.register_buffer("order", order, persistent=False)
        self.pieces = nn.ParameterDict({
            str(r): nn.Parameter(full.narrow(dim, r * self.size, self.size).clone(),
                                 requires_grad=grad)
            for r in axis.ranks})

    def piece(self, r: int) -> torch.Tensor:
        return self.pieces[str(r)]

    def bounds(self, r: int):
        return r * self.size, (r + 1) * self.size

    def rows(self, r: int) -> torch.Tensor:
        """The indices along ``dim`` of the whole leaf that rank r's piece
        holds."""
        if self.order is None:
            return torch.arange(*self.bounds(r), device=self.piece(r).device)
        return self.order[slice(*self.bounds(r))]

    def in_order(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """``t``, laid out along ``dim`` as the pieces are, put back in the
        leaf's own order."""
        return t if self.order is None else t.index_select(dim, torch.argsort(self.order))

    def whole(self) -> torch.Tensor:
        GATHERS[self.name] += 1
        return self.in_order(self.axis.gather([self.piece(r) for r in self.axis.ranks],
                                               self.dim), self.dim)


class GatheredWhole(nn.Module):
    """A parametrization (torch.nn.utils.parametrize) of a leaf split along
    ``dim``: stored as the pieces of the ranks of ``axis`` this process
    holds, stacked on a new first axis, and read as the gathered whole
    (counted in GATHERS)."""

    def __init__(self, dim: int, axis: ModelAxis, name: str):
        super().__init__()
        self.dim, self.axis, self.name = dim, axis, name

    def right_inverse(self, full: torch.Tensor) -> torch.Tensor:
        if full.shape[self.dim] % self.axis.tp:
            raise ValueError(f"{self.name}: axis {self.dim} of {tuple(full.shape)} does not "
                             f"split into {self.axis.tp}")
        size = full.shape[self.dim] // self.axis.tp
        return torch.stack([full.narrow(self.dim, r * size, size) for r in self.axis.ranks])

    def forward(self, pieces: torch.Tensor) -> torch.Tensor:
        GATHERS[self.name] += 1
        return self.axis.gather(list(pieces.unbind(0)), self.dim)


class ShardedLinear(nn.Module):
    """An ``nn.Linear`` whose weight (out, in) is split over the model axis:
    by its output (``dim`` 0, column-parallel; ``order`` permutes the output
    features before the cut) or by its input (``dim`` 1, row-parallel). The
    bias is replicated. Called, it computes in x's dtype promoted with the
    weight's (flax's ``nn.Dense``); ``weight`` reads the gathered whole."""

    def __init__(self, linear: nn.Linear, dim: int, axis: ModelAxis, name: str,
                 order: Optional[torch.Tensor] = None):
        super().__init__()
        self.dim, self.axis = dim, axis
        self.shards = ShardedLeaf(linear.weight, dim, axis, f"{name}.weight", order)
        self.bias = linear.bias

    @property
    def dtype(self):
        return next(iter(self.shards.pieces.values())).dtype

    @property
    def weight(self):
        return self.shards.whole()

    def piece(self, r: int) -> torch.Tensor:
        return self.shards.piece(r)

    def bounds(self, r: int):
        return self.shards.bounds(r)

    def bias_piece(self, bias, r: int):
        """The bias of rank r's output features (column-parallel)."""
        if bias is None:
            return None
        if self.shards.order is None:
            return bias[slice(*self.bounds(r))]
        return bias.index_select(0, self.shards.rows(r))

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.dtype)
        x = x.to(dt)
        if self.dim == 0:
            return self.shards.in_order(self.axis.column(
                lambda r, x, b: F.linear(x, self.piece(r).to(dt),
                                         None if b is None else self.bias_piece(b, r).to(dt)),
                x, self.bias), -1)
        return self.axis.row_with_bias(
            lambda r, x: linear_f32(x[..., slice(*self.bounds(r))], self.piece(r).to(dt)),
            self.bias, dt, x)


class ShardedConv2d(nn.Module):
    """An ``nn.Conv2d`` (zero padding) whose weight (O, I / groups, kh, kw)
    is split over the model axis by its output channels (column-parallel:
    a grouped convolution takes the input channels of the rank's groups) or,
    ungrouped, by its input channels (row-parallel, the f32 sum and the bias
    once as for ``ShardedLinear``). NCHW in and out, as ``nn.Conv2d``. A
    split that cuts a group computes with the gathered whole."""

    def __init__(self, conv: nn.Conv2d, dim: int, axis: ModelAxis, name: str):
        super().__init__()
        if conv.padding_mode != "zeros" or isinstance(conv.padding, str):
            raise ValueError(f"{name}: only numeric zero padding is split")
        self.dim, self.axis = dim, axis
        self.in_channels, self.out_channels = conv.in_channels, conv.out_channels
        self.stride, self.padding, self.dilation = conv.stride, conv.padding, conv.dilation
        self.groups = conv.groups
        self.shards = ShardedLeaf(conv.weight, dim, axis, f"{name}.weight")
        self.bias = conv.bias
        per_group = conv.out_channels // conv.groups
        self.split = conv.groups == 1 or (dim == 0 and self.shards.size % per_group == 0)

    @property
    def dtype(self):
        return next(iter(self.shards.pieces.values())).dtype

    @property
    def weight(self):
        return self.shards.whole()

    def _conv(self, x, w, b, groups):
        return F.conv2d(x, w, b, self.stride, self.padding, self.dilation, groups)

    def forward(self, x):
        if not self.split:
            return self._conv(x, self.weight, self.bias, self.groups)
        if self.dim == 0:
            per_group = self.out_channels // self.groups
            in_per_group = self.in_channels // self.groups

            def piece(r, x, b):
                lo, hi = self.shards.bounds(r)
                b = None if b is None else b[lo:hi]
                if self.groups == 1:
                    return self._conv(x, self.shards.piece(r), b, 1)
                g0, g1 = lo // per_group, hi // per_group
                return self._conv(x[:, g0 * in_per_group:g1 * in_per_group],
                                  self.shards.piece(r), b, g1 - g0)

            return self.axis.column(piece, x, self.bias, dim=1)
        return self.axis.row_with_bias(
            lambda r, x: self._conv(x[:, slice(*self.shards.bounds(r))].float(),
                                    self.shards.piece(r).float(), None, 1),
            None if self.bias is None else self.bias[:, None, None],
            torch.promote_types(x.dtype, self.dtype), x)


# --------------------------------------------------------------- the ViT block
_MEGATRON = (("attn.qkv", 0), ("attn.proj", 1), ("mlp.fc1", 0), ("mlp.fc2", 1))


def head_major_rows(heads: int, hd: int, tp: int) -> torch.Tensor:
    """qkv's output features (q | k | v, the heads inside each) reordered so
    that rank r's contiguous tp-th is its H / tp heads' q, then k, then v:
    the rule's axis and piece size, each piece a permutation of the rule's
    (whose rank 0 at tp = 2 holds all of q and half of k)."""
    c, local = heads * hd, heads // tp
    return torch.cat([torch.arange(i * c + r * local * hd, i * c + (r + 1) * local * hd)
                      for r in range(tp) for i in range(3)])


class ShardedViTBlock(ViTBlock):
    """A ViT block in Megatron's layout over a model axis, on ViTBlock's
    paths: each rank's qkv piece (K8 with norm1 folded in where ViTBlock
    takes K7, else the product) is its heads' q | k | v (``head_major_rows``);
    attention on the rank's H / tp heads (K2 where ViTBlock takes it); proj's
    rows of those heads; then fc1's columns (K8 with the GELU where ViTBlock
    fuses the MLP) and fc2's rows with no collective between them. The two
    row products sum in f32 over the axis, round once and add their bias
    once. Attention maps (``output_attentions``) take ViTBlock's path on the
    gathered weights."""

    def __init__(self, block: ViTBlock, axis: ModelAxis):
        nn.Module.__init__(self)
        self.dim, self.num_heads, self.hidden = block.dim, block.num_heads, block.hidden
        for name, child in block.named_children():
            self.add_module(name, child)
        self.axis = axis

    @staticmethod
    def aligned(block: ViTBlock, shardings, prefix: str, tp: int) -> bool:
        """Whether the rule splits ``block`` (named ``prefix``) in Megatron's
        layout with whole heads on each rank of a model axis of ``tp``."""
        return block.num_heads % tp == 0 and all(
            shardings.get(f"{prefix}.{name}.weight") == dim for name, dim in _MEGATRON)

    def forward(self, x, output_attentions: bool = False):
        if output_attentions:
            return super().forward(x, True)
        fuse_qkv, fuse_mlp = self.fused_paths(x)
        axis, qkv, proj = self.axis, self.attn.qkv, self.attn.proj
        fc1, fc2 = self.mlp.fc1, self.mlp.fc2
        b, n, c = x.shape
        local, hd = self.num_heads // axis.tp, self.dim // self.num_heads
        y = x if fuse_qkv else self.norm1(x)
        dt = torch.promote_types(y.dtype, qkv.dtype)
        dt_proj = torch.promote_types(dt, proj.dtype)
        flash = fuse_qkv or plain_flash_enabled(dt, n, x.device)

        def attn_partial(r, y, lns, lnb, bias):
            w, bias = qkv.piece(r).to(dt), qkv.bias_piece(bias, r)
            if fuse_qkv:
                h = ln_dense_fused(y.reshape(b * n, c), lns, lnb, w, bias, 1e-6, "")
            else:
                h = F.linear(y, w, None if bias is None else bias.to(dt))
            q, k, v = (t.transpose(1, 2).contiguous()
                       for t in h.reshape(b, n, 3, local, hd).unbind(2))
            if flash:
                out = flash_attention_plain(q, k, v, hd ** -0.5)
            else:  # eager: f32 scores and softmax, the probabilities in v's dtype
                s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
                out = torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)
            out = out.transpose(1, 2).reshape(b, n, local * hd)
            return linear_f32(out.to(dt_proj), proj.piece(r).to(dt_proj))

        ln = (self.norm1.weight, self.norm1.bias) if fuse_qkv else (None, None)
        x = x + self.ls1(axis.row_with_bias(attn_partial, proj.bias, dt_proj, y.to(dt), *ln,
                                            qkv.bias))

        if fuse_mlp:
            y, ln, dt_mlp = x, (self.norm2.weight, self.norm2.bias), x.dtype
        else:
            y, ln = self.norm2(x), (None, None)
            dt_mlp = torch.promote_types(y.dtype, fc1.dtype)
        dt_fc2 = torch.promote_types(dt_mlp, fc2.dtype)

        def mlp_partial(r, y, lns, lnb, bias):
            w, bias = fc1.piece(r).to(dt_mlp), fc1.bias_piece(bias, r)
            if fuse_mlp:
                h = ln_dense_fused(y.reshape(b * n, c), lns, lnb, w, bias, 1e-6, "gelu")
            else:
                h = adaptive_gelu(F.linear(y.to(dt_mlp), w,
                                           None if bias is None else bias.to(dt_mlp)))
            return linear_f32(h.reshape(b, n, -1).to(dt_fc2), fc2.piece(r).to(dt_fc2))

        return x + self.ls2(axis.row_with_bias(mlp_partial, fc2.bias, dt_fc2, y, *ln,
                                               fc1.bias)), None


# --------------------------------------------------------------- the transform
def _parent(model: nn.Module, name: str):
    parent, _, child = name.rpartition(".")
    return (model.get_submodule(parent) if parent else model), child


def tensor_parallel(model: nn.Module, mesh: Optional[Mesh] = None, *, tp: Optional[int] = None,
                    min_dim: int = TP_MIN_DIM) -> nn.Module:
    """Split ``model``'s leaves over a model axis by ``auto_param_shardings``,
    in place, and return it.

    With ``mesh`` the axis is the mesh's model axis (this process holds its
    rank's pieces; the collectives run over the model group). With ``tp``
    instead, every rank's pieces of an axis of ``tp`` are held here and
    combined in-process (``LocalAxis``). Where nothing shards (a model axis
    of 1) the model is returned untouched."""
    if (mesh is None) == (tp is None):
        raise ValueError("give a mesh or tp, not both")
    n_model = mesh.n_model if mesh is not None else tp
    shardings = auto_param_shardings(model, Mesh(world=n_model, rank=0,
                                                 device=torch.device("cpu"),
                                                 shape=(1, n_model)), min_dim)
    if all(d is None for d in shardings.values()):
        return model
    axis = DistributedAxis(mesh) if mesh is not None else LocalAxis(tp)
    blocks = {name: m for name, m in model.named_modules()
              if isinstance(m, ViTBlock) and ShardedViTBlock.aligned(m, shardings, name, axis.tp)}
    orders = {f"{name}.attn.qkv": head_major_rows(m.num_heads, m.dim // m.num_heads, axis.tp)
              for name, m in blocks.items()}
    for mod_name, module in list(model.named_modules()):
        for leaf, _ in list(module.named_parameters(recurse=False)):
            full_name = f"{mod_name}.{leaf}" if mod_name else leaf
            dim = shardings.get(full_name)
            if dim is None:
                continue
            if leaf == "weight" and type(module) is nn.Linear:
                layer = ShardedLinear(module, dim, axis, mod_name, orders.get(mod_name))
            elif leaf == "weight" and type(module) is nn.Conv2d:
                layer = ShardedConv2d(module, dim, axis, mod_name)
            else:
                parametrize.register_parametrization(
                    module, leaf, GatheredWhole(dim, axis, full_name), unsafe=True)
                continue
            parent, child = _parent(model, mod_name)
            setattr(parent, child, layer)
            break
    for name, block in blocks.items():
        parent, child = _parent(model, name)
        setattr(parent, child, ShardedViTBlock(block, axis))
    return model
