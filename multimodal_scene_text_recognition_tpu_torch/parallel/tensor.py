"""Tensor parallelism over a mesh's model axis: Megatron's column- and
row-parallel linear layers and the vocabulary-parallel embedding, and
:func:`parallelize`, which puts a model's split matrices in their place
(JAX counterpart: the ``param_shardings`` of parallel/mesh.py, which XLA's
SPMD partitioner turns into the same products and collectives).

The four collectives over the model group, each an autograd function:

* ``copy`` (Megatron's f): identity forward, all-reduce of the gradient;
* ``reduce`` (g): all-reduce forward, identity backward;
* ``scatter``: this rank's piece forward, all-gather of the gradient;
* ``gather``: all-gather forward, this rank's piece of the gradient.

Outside the split products every rank of a model group computes the same
values, so a replicated parameter gets the same gradient on each.

A column-parallel weight right before a row-parallel one (the FF pairs,
``models.layers.feed_forward``) keeps the hidden activation split between
the two: no all-gather in between, one all-reduce after.  Its dropout draws
the whole hidden width and keeps this rank's columns.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import BatchNorm2d, MultiHeadAttention
from ..ops.attention import attend
from .mesh import GroupSum, Mesh, all_gather, all_reduce, chunk, split_dims


def _piece(t: torch.Tensor, size: int, rank: int, dim: int) -> torch.Tensor:
    return t.detach().chunk(size, dim)[rank].clone()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return chunk(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.group, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x.contiguous(), group, dim)

    @staticmethod
    def backward(ctx, g):
        return chunk(g, ctx.group, ctx.dim).contiguous(), None, None


def copy_to_model(x, group):
    return _Copy.apply(x, group)


def reduce_from_model(x, group):
    return _Reduce.apply(x, group)


def scatter_to_model(x, group, dim: int = -1):
    return _Scatter.apply(x, group, dim)


def gather_from_model(x, group, dim: int = -1):
    return _Gather.apply(x, group, dim)


class ColumnParallelLinear(nn.Module):
    """``nn.Linear`` with this rank's rows of the weight (the output
    columns of JAX's kernel): ``weight`` [out / M, in]; ``bias`` [out] whole
    (JAX replicates 1-D leaves), of which this rank adds its piece.  Its
    forward gives the whole output, gathered."""

    def __init__(self, linear: nn.Linear, mesh: Mesh):
        super().__init__()
        self.group, self.rank, self.size = mesh.model_group, mesh.model_rank, mesh.model
        self.out_features = linear.out_features
        self.weight = nn.Parameter(_piece(linear.weight, self.size, self.rank, 0))
        self.bias = None if linear.bias is None else nn.Parameter(linear.bias.detach().clone())

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's columns of the output."""
        b = None if self.bias is None else scatter_to_model(self.bias, self.group, 0)
        return F.linear(copy_to_model(x, self.group), self.weight, b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gather_from_model(self.local(x), self.group)

    def parallel_pair(self, lin2: nn.Module, act: Callable, x: torch.Tensor,
                      drop: Optional[Callable]) -> torch.Tensor:
        """``lin2(drop(act(self(x))))`` with the hidden activation left
        split where ``lin2`` is row-parallel (Megatron's f/g pair)."""
        if not isinstance(lin2, RowParallelLinear):
            h = act(self(x))
            return lin2(h if drop is None else drop(h))
        h = act(self.local(x))
        if drop is not None:
            h = drop(h, columns=(self.rank * h.shape[-1], self.out_features))
        return lin2.from_split(h)


class RowParallelLinear(nn.Module):
    """``nn.Linear`` with this rank's columns of the weight (the input rows
    of JAX's kernel): ``weight`` [out, in / M]; ``bias`` [out] whole, added
    once after the partial products are summed."""

    def __init__(self, linear: nn.Linear, mesh: Mesh):
        super().__init__()
        self.group, self.rank, self.size = mesh.model_group, mesh.model_rank, mesh.model
        self.weight = nn.Parameter(_piece(linear.weight, self.size, self.rank, 1))
        self.bias = None if linear.bias is None else nn.Parameter(linear.bias.detach().clone())

    def from_split(self, h: torch.Tensor) -> torch.Tensor:
        """The output from this rank's columns of the input."""
        y = reduce_from_model(F.linear(h, self.weight), self.group)
        return y if self.bias is None else y + self.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.from_split(scatter_to_model(x, self.group))


class VocabParallelEmbedding(nn.Module):
    """``nn.Embedding`` with this rank's rows of the table (``weight``
    [V / M, E]): each rank looks up the ids in its rows, zeros the others,
    and the model group sums."""

    def __init__(self, emb: nn.Embedding, mesh: Mesh):
        super().__init__()
        self.group, self.size = mesh.model_group, mesh.model
        rows = emb.num_embeddings // self.size
        self.lo, self.rows = mesh.model_rank * rows, rows
        self.weight = nn.Parameter(emb.weight.detach()[self.lo:self.lo + rows].clone())

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        local = ids - self.lo
        mine = (local >= 0) & (local < self.rows)
        out = F.embedding(torch.where(mine, local, 0), self.weight)
        return reduce_from_model(torch.where(mine[..., None], out, 0.0), self.group)


class ParallelMultiHeadAttention(MultiHeadAttention):
    """``MultiHeadAttention`` whose packed in-projection is split by
    columns (``in_proj_weight`` [3E / M, E], rows across q, k and v whatever
    the head boundaries, as JAX splits ``w_qkv``): each rank projects its
    columns and the model group gathers q, k and v whole; the attention and
    ``out_proj`` run replicated."""

    def __init__(self, mha: MultiHeadAttention, mesh: Mesh):
        nn.Module.__init__(self)
        self.num_heads = mha.num_heads
        self.group, self.size = mesh.model_group, mesh.model
        self.in_proj_weight = nn.Parameter(
            _piece(mha.in_proj_weight, self.size, mesh.model_rank, 0))
        self.in_proj_bias = nn.Parameter(mha.in_proj_bias.detach().clone())
        self.out_proj = mha.out_proj

    def _project(self, x: torch.Tensor) -> torch.Tensor:
        b = scatter_to_model(self.in_proj_bias, self.group, 0)
        return gather_from_model(
            F.linear(copy_to_model(x, self.group), self.in_proj_weight, b), self.group)

    def forward(self, query, key, mask=None, int8: bool = False):
        if int8:
            raise ValueError("the int8 route takes whole weights: serve it without a model axis")
        E = query.shape[-1]
        qkv = self._project(query)
        kv = qkv if key is query else self._project(key)
        out = attend(qkv[..., :E], kv[..., E:2 * E], kv[..., 2 * E:], self.num_heads, mask)
        return self.out_proj(out)


def _refusal(name: str, module: nn.Module) -> str:
    if isinstance(module, nn.LSTM):
        return (f"{name} is a leaf of a cuDNN LSTM, which cannot be split by columns: "
                f"train and serve the BiLSTM encoder with model_axis=1")
    return (f"{name} is split by the model axis, and {type(module).__name__} has no "
            f"tensor-parallel form: use model_axis=1")


def parallelize(model: nn.Module, mesh: Mesh, whole: Iterable[str] = ()) -> nn.Module:
    """Put ``model`` (whole weights, the same on every rank) on this rank
    of ``mesh``, in place: each leaf that JAX's rule splits over the model
    axis (``mesh.split_dims``) becomes this rank's piece inside its
    tensor-parallel module (a linear layer by columns or rows, an embedding
    table by rows, an attention's packed in-projection by columns), and
    every BatchNorm takes its statistics over the data group (the two-pass
    K3 on the card).  Submodules named in ``whole`` (e.g. ``"decoder"``,
    whose fused kernels take whole weights) keep their weights whole.
    Raises ValueError, before changing anything, where a split leaf has no
    tensor-parallel form: the cuDNN LSTM's gates (BiLSTM encoder) and the
    LSTM decoder's.  Returns ``model``."""
    whole = tuple(whole)
    params = dict(model.named_parameters())
    dims = split_dims(params, mesh.model)
    dims = {n: d for n, d in dims.items() if not n.startswith(tuple(w + "." for w in whole))}
    swaps = []
    for name, mod in model.named_modules():
        own = {f"{name}.{p}" if name else p: d for p, _ in mod.named_parameters(recurse=False)
               for d in [dims.get(f"{name}.{p}" if name else p)] if d is not None}
        if not own:
            continue
        if isinstance(mod, nn.Linear) and len(own) == 1:
            swaps.append((name, ColumnParallelLinear if next(iter(own.values())) == 0
                          else RowParallelLinear))
        elif isinstance(mod, nn.Embedding) and list(own.values()) == [0]:
            swaps.append((name, VocabParallelEmbedding))
        elif isinstance(mod, MultiHeadAttention) and own == {f"{name}.in_proj_weight": 0}:
            swaps.append((name, ParallelMultiHeadAttention))
        else:
            raise ValueError(_refusal(next(iter(own)), mod))
    for name, cls in swaps:
        parent_name, _, attr = name.rpartition(".")
        parent = model.get_submodule(parent_name)
        setattr(parent, attr, cls(getattr(parent, attr), mesh))
    data_sum = GroupSum(mesh.data_group)
    for mod in model.modules():
        if isinstance(mod, BatchNorm2d):
            mod.reducer = data_sum
    return model


def model_split(model: nn.Module) -> list:
    """Per parameter of ``model`` (in ``parameters()`` order), whether it
    is a piece of a leaf split over the model axis."""
    split = set()
    for mod in model.modules():
        if isinstance(mod, (ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)):
            split.add(id(mod.weight))
        elif isinstance(mod, ParallelMultiHeadAttention):
            split.add(id(mod.in_proj_weight))
    return [id(p) in split for p in model.parameters()]
