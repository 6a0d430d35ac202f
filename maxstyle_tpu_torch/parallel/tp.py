"""Megatron tensor parallelism over UNETR's ViT, with ``torch.distributed``.

Counterpart of ``maxstyle_tpu/parallel/tp.py``, which shards the ViT over a
'model' mesh axis and lets XLA insert the collectives. Here the ranks of a
2-D (data x model) grid of process groups hold the shards, and the
collectives are explicit, as the Megatron f/g pair of autograd functions:

* ``qkv`` and ``linear1`` are column-parallel: their output features (the
  rows of the torch weight, and the bias) are split over 'model'; their
  input passes through ``f`` (identity forward, all-reduce of the gradient
  over 'model' backward);
* ``out_proj`` and ``linear2`` are row-parallel: their input features (the
  weight's columns) are split; the partial products pass through ``g``
  (all-reduce over 'model' forward, identity backward) and the bias, kept
  whole, is added once after it;
* everything else (patch embedding, position embedding, LayerNorms) is
  replicated.

``qkv``'s output features are head-major, (head, q/k/v, head_dim)
(``models/unetr.SelfAttention``), so an even split keeps whole heads, with
their q, k and v, on one rank when ``num_heads % model_parallel == 0``; the
attention then runs on the rank's heads with no collective. Anything else
raises.

:func:`vit_tp_splits` gives each parameter's split dimension (None:
replicated), :func:`shard_vit_state` cuts a full ViT state dict into one
rank's shard, :func:`parallelize_vit` swaps a ViT's four linears a block for
their parallel shards, and :func:`tp_train_step` is one optimizer step over
the grid: the batch split over 'data', the gradients of each data rank's
loss share summed over 'data', the optimizer's moments sharded with their parameters because
each rank's optimizer holds its shards only.

The caller starts the process group (``torch.distributed.init_process_group``
with its own address, world size and rank). :func:`tp_train_step` runs its
loss inside ``parallel/mesh.sharded``, so a dropout mask is drawn at the
global batch shape and each data rank takes its rows (``models/layers``'s
``FixableDropout``): the replicated sites' masks agree over 'model' and
equal the single process's rows, those on the split attention weights and
GELU output are each model rank's own draw of its shard's shape.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


# parameter-name suffix -> the dimension split over 'model' (torch layouts)
_RULES = (
    ("attn.qkv.weight", 0), ("attn.qkv.bias", 0),
    ("attn.out_proj.weight", 1), ("attn.out_proj.bias", None),
    ("linear1.weight", 0), ("linear1.bias", 0),
    ("linear2.weight", 1), ("linear2.bias", None),
)
COLUMN_PARALLEL = ("attn.qkv", "linear1")
ROW_PARALLEL = ("attn.out_proj", "linear2")


def _split_dim(name: str) -> Optional[int]:
    for suffix, dim in _RULES:
        if name == suffix or name.endswith("." + suffix):
            return dim
    return None


def vit_tp_splits(names) -> Dict[str, Optional[int]]:
    """{parameter name: the dimension split over 'model', or None} for the
    names of a ViT's (or a UNETR encoder's) parameters or state dict."""
    return {name: _split_dim(name) for name in names}


def check_heads(num_heads: int, model_parallel: int) -> None:
    if num_heads % model_parallel:
        raise ValueError(f"num_heads {num_heads} is not a multiple of model_parallel "
                         f"{model_parallel}: a rank would hold part of a head")


def shard_vit_state(state: Mapping[str, torch.Tensor], model_rank: int, model_parallel: int,
                    num_heads: int) -> Dict[str, torch.Tensor]:
    """The shard of a full ViT state dict that model rank ``model_rank`` of
    ``model_parallel`` holds: split tensors cut into even contiguous chunks,
    the rest whole."""
    check_heads(num_heads, model_parallel)
    out = {}
    for name, t in state.items():
        dim = _split_dim(name)
        if dim is not None:
            if t.shape[dim] % model_parallel:
                raise ValueError(f"{name}: dimension {dim} of {tuple(t.shape)} does not split "
                                 f"into {model_parallel}")
            t = t.chunk(model_parallel, dim)[model_rank]
        out[name] = t.clone()
    return out


@dataclasses.dataclass
class Grid:
    """A rank's place in the (data x model) grid: rank = data_rank *
    model_parallel + model_rank."""

    world: int
    model_parallel: int
    rank: int
    data_group: object
    model_group: object

    @property
    def data_parallel(self) -> int:
        return self.world // self.model_parallel

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_parallel

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_parallel


def make_grid(model_parallel: int) -> Grid:
    """The process groups of the started world's (data x model) grid; every
    rank creates every group, in one order."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % model_parallel:
        raise ValueError(f"world size {world} is not a multiple of model_parallel "
                         f"{model_parallel}")
    dp = world // model_parallel
    model_group = data_group = None
    for d in range(dp):
        g = dist.new_group([d * model_parallel + m for m in range(model_parallel)])
        if d == rank // model_parallel:
            model_group = g
    for m in range(model_parallel):
        g = dist.new_group([d * model_parallel + m for d in range(dp)])
        if m == rank % model_parallel:
            data_group = g
    return Grid(world, model_parallel, rank, data_group, model_group)


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class ColumnParallelLinear(nn.Module):
    """A shard of nn.Linear's output features: f(x) @ weight.T + bias."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor], group):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias) if bias is not None else None
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(_CopyToModel.apply(x, self.group), self.weight, self.bias)


class RowParallelLinear(nn.Module):
    """A shard of nn.Linear's input features: g(x @ weight.T) + bias, the
    bias whole and added once."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor], group):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias) if bias is not None else None
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = _ReduceFromModel.apply(F.linear(x, self.weight), self.group)
        return out if self.bias is None else out + self.bias


def parallelize_vit(vit: nn.Module, grid: Grid, num_heads: int) -> nn.Module:
    """Swap, in place, each block's qkv/linear1 for column-parallel and
    out_proj/linear2 for row-parallel shards of their current weights (the
    rank's, by :func:`shard_vit_state`'s cut); returns ``vit``. Its state
    dict then has the full one's names with the rank's shards."""
    check_heads(num_heads, grid.model_parallel)
    for block_name, block in vit.named_children():
        if not block_name.startswith("block"):
            continue
        for path in COLUMN_PARALLEL + ROW_PARALLEL:
            parent = block.get_submodule(path.rpartition(".")[0]) if "." in path else block
            attr = path.rpartition(".")[2]
            full = getattr(parent, attr)
            sd = shard_vit_state({f"{path}.{k}": v.detach() for k, v in full.state_dict().items()},
                                 grid.model_rank, grid.model_parallel, num_heads)
            cls = ColumnParallelLinear if path in COLUMN_PARALLEL else RowParallelLinear
            setattr(parent, attr, cls(sd[f"{path}.weight"], sd.get(f"{path}.bias"),
                                      grid.model_group))
    return vit


def tp_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                  loss_fn: Callable[[nn.Module, Dict[str, torch.Tensor]], torch.Tensor],
                  grid: Grid):
    """``step(batch) -> loss``: ``batch`` is this data rank's shard (the same
    on every model rank of its group) and ``loss_fn`` the mean loss over
    its rows. Each data rank's share of the global mean (its mean over
    ``data_parallel``) is differentiated, the gradients are summed over
    'data', then ``optimizer`` steps the rank's parameters (shards and
    replicas). Returns the global mean loss. The loss runs inside
    ``parallel/mesh.sharded(grid)`` (module docstring)."""
    from maxstyle_tpu_torch.parallel import mesh

    def step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        with mesh.sharded(grid):
            loss = mesh.share(loss_fn(model, batch))
            loss.backward()
            for p in model.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            mesh.reduce_gradients(model.parameters())
            loss = mesh.sum_metrics({"loss": loss})["loss"]
        optimizer.step()
        return loss

    return step
