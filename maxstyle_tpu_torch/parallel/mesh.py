"""Data parallelism with the JAX step's global-batch semantics.

Counterpart of ``maxstyle_tpu/parallel/mesh.py``. There, the data-parallel
step is GSPMD: ``shard_train_step`` jits the unchanged step with the batch
split over 'data', so the sharded step computes the single-device step on
the global batch. A plain ``DistributedDataParallel`` wrapper would not:
its BatchNorm would normalize with each rank's statistics, MaxStyle and
MixStyle would pick partners and spreads within a rank, and the loss would
be the mean of per-rank means. Here the ranks of the data group compute the
step on the global batch with explicit collectives instead:

* BatchNorm in "train" and "frozen" mode sums Σx, Σx² and the count over
  the group (``models/layers.BatchNorm``); the backward pass carries the
  cross-rank terms because :func:`all_sum` is autograd-aware;
* the style ops gather the instance statistics [B, C] of every rank
  (:func:`gather_rows`), so a permutation indexes global rows and a spread
  is taken over the global batch or style group;
* every loss is the rank's share of the global mean, its local sum over the
  global count (:func:`share`), so the shares of the group add up to the
  single-device loss, and the weight gradients are summed over the group
  once before the optimizer steps (:func:`reduce_gradients`);
* every random draw of the step is made at the global shape from a
  generator that every rank seeds alike, and each rank takes its rows
  (:func:`local_rows`). The augmentation is the exception: as the JAX
  step folds the data-axis index into its key, each rank augments its
  shard from a stream of its own (``data/augment.augment_batch_sharded``).

The global batch is rank-major: rank r holds rows [r*b, (r+1)*b) of it.
With ``keep_orig`` a rank's batch is [aug_r | orig_r], so the global order
is [aug_0 | orig_0 | aug_1 | orig_1 | ...], where the single-device fused
step orders [aug | orig]. The two orders hold the same rows; a draw that
refers to a row (a permutation, a per-sample style tensor) refers to the
row's place in the order of the batch it is given with.

Every collective is an ``all_reduce`` or a ``broadcast``: gloo carries CUDA
tensors for those two and not for ``all_gather``, so a gather is an
``all_reduce`` of a zeroed global buffer into which each rank writes its
rows. Nothing here is active unless :func:`sharded` is entered with a group
of more than one rank: a world of one runs the single-device step itself.

The caller starts the process group: :func:`init_from_env` does it from the
environment that ``python -m torch.distributed.run`` sets (NCCL on a CUDA
device, gloo on the CPU).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, Iterable, List, Mapping, Optional

import torch
import torch.distributed as dist

from maxstyle_tpu_torch.parallel.tp import Grid, make_grid


@dataclasses.dataclass(frozen=True)
class Shard:
    """A rank's place in a data group of ``world`` > 1 ranks."""

    group: object
    world: int
    rank: int
    # the global rank of data rank 0 of this group: the source of a broadcast
    src: int = 0


_ACTIVE: Optional[Shard] = None


def make_mesh(model_parallel: int = 1) -> Grid:
    """The (data x model) grid of the started process group."""
    return make_grid(model_parallel)


def shard_of(grid: Optional[Grid]) -> Optional[Shard]:
    """The data shard of ``grid``, or None for a data group of one rank."""
    if grid is None or grid.data_parallel == 1:
        return None
    return Shard(grid.data_group, grid.data_parallel, grid.data_rank, src=grid.model_rank)


def active() -> Optional[Shard]:
    return _ACTIVE


@contextlib.contextmanager
def sharded(grid: Optional[Grid]):
    """Inside, the step's batch-wide operations run over ``grid``'s data
    group; with a data group of one rank nothing changes."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, shard_of(grid)
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev


def init_from_env(device: Optional[str] = None) -> Optional[Grid]:
    """Start the process group that ``torch.distributed.run`` describes in
    the environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT): NCCL on ``cuda:LOCAL_RANK``, which becomes the current
    device, unless ``device`` is "cpu", which takes gloo. Returns the grid,
    or None outside such a launch (a world of one, run as a single
    process)."""
    if "WORLD_SIZE" not in os.environ:
        return None
    if not dist.is_initialized():
        cpu = device is not None and torch.device(device).type == "cpu"
        if not cpu:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("gloo" if cpu else "nccl", init_method="env://")
    return make_mesh()


def device_of(grid: Optional[Grid], device: Optional[str]) -> Optional[str]:
    """The device a rank of ``grid`` runs on: ``device``, or under a
    launch on the GPU the rank's own card."""
    if grid is None or device is not None:
        return device
    return f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"


def is_writer(grid: Optional[Grid]) -> bool:
    """Whether this rank writes files (checkpoints, logs, reports): rank 0."""
    return grid is None or grid.rank == 0


def barrier(grid: Optional[Grid]) -> None:
    if grid is not None and grid.world > 1:
        dist.barrier()


# ---------------------------------------------------------------------------
# rows of the global batch
# ---------------------------------------------------------------------------


def global_batch(n: int) -> int:
    """The global batch of which this rank holds ``n`` rows."""
    return n if _ACTIVE is None else n * _ACTIVE.world


def global_shape(shape) -> tuple:
    """``shape`` with its leading (batch) dimension made global."""
    shape = tuple(shape)
    return (global_batch(shape[0]),) + shape[1:]


def local_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a tensor of the global batch (the tensor itself
    outside a data group)."""
    if _ACTIVE is None:
        return t
    n = t.shape[0] // _ACTIVE.world
    if n * _ACTIVE.world != t.shape[0]:
        raise ValueError(f"a batch of {t.shape[0]} does not split over {_ACTIVE.world} ranks")
    return t[_ACTIVE.rank * n:(_ACTIVE.rank + 1) * n]


def row_offset(n: int) -> int:
    """The global row of this rank's first of ``n`` rows."""
    return 0 if _ACTIVE is None else _ACTIVE.rank * n


def shard_batch(batch: Mapping[str, object], grid: Optional[Grid]) -> Dict[str, object]:
    """This data rank's contiguous rows of every array of a global batch."""
    if grid is None or grid.data_parallel == 1:
        return dict(batch)
    out = {}
    for k, v in batch.items():
        n = v.shape[0] // grid.data_parallel
        if n * grid.data_parallel != v.shape[0]:
            raise ValueError(f"batch[{k!r}] of {v.shape[0]} rows does not split over "
                             f"{grid.data_parallel} ranks")
        out[k] = v[grid.data_rank * n:(grid.data_rank + 1) * n]
    return out


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


class _AllSum(torch.autograd.Function):
    """Sum over the data group; the gradient of every rank's input is the
    sum of the gradients of the result over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over the data group of ``x``, differentiable."""
    if _ACTIVE is None:
        return x
    return _AllSum.apply(x, _ACTIVE.group)


def all_extreme(x: torch.Tensor, op: str) -> torch.Tensor:
    """The "min" or "max" of ``x`` over the data group (no gradient)."""
    if _ACTIVE is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MIN if op == "min" else dist.ReduceOp.MAX,
                    group=_ACTIVE.group)
    return x


class _GatherRows(torch.autograd.Function):
    """The global batch from every rank's rows: a zeroed global buffer with
    the rank's rows written, summed over the group. Backward: the summed
    gradient's rows of this rank."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        n = x.shape[0]
        buf = x.new_zeros((n * shard.world,) + tuple(x.shape[1:]))
        buf[shard.rank * n:(shard.rank + 1) * n] = x
        dist.all_reduce(buf, group=shard.group)
        return buf

    @staticmethod
    def backward(ctx, grad):
        s = ctx.shard
        grad = grad.clone()
        dist.all_reduce(grad, group=s.group)
        n = grad.shape[0] // s.world
        return grad[s.rank * n:(s.rank + 1) * n], None


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch of which ``x`` holds this rank's rows."""
    if _ACTIVE is None:
        return x
    return _GatherRows.apply(x, _ACTIVE)


def share(loss):
    """This rank's share of a mean over the global batch, given the mean
    over its rows: the local sum over the global count, so the shares of
    the group add up to the global mean."""
    if _ACTIVE is None:
        return loss
    return loss / _ACTIVE.world


def _flat_sum(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


def reduce_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum the gradients of ``params`` over the data group in one flattened
    bucket, in place (each rank's gradient is that of its loss share)."""
    if _ACTIVE is None:
        return
    params = [p for p in params if p.grad is not None]
    for dtype in {p.grad.dtype for p in params}:
        group = [p for p in params if p.grad.dtype == dtype]
        for p, g in zip(group, _flat_sum([p.grad for p in group], _ACTIVE.group)):
            p.grad.copy_(g)


def sum_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every metric (a rank's share) summed over the data group in one
    all-reduce, so every rank holds the global values."""
    if _ACTIVE is None:
        return metrics
    keys = sorted(metrics)
    vals = _flat_sum([metrics[k].detach().float().reshape(1) for k in keys], _ACTIVE.group)
    return {k: v.reshape(()) for k, v in zip(keys, vals)}


def replicate(state, grid: Optional[Grid]):
    """Broadcast the modules' parameters and buffers and the optimizers'
    state of a TrainState (or an ``nn.Module``) from data rank 0 over the
    data group; returns it."""
    shard = shard_of(grid)
    if shard is None:
        return state
    modules = getattr(state, "modules", state)
    tensors = [t for t in list(modules.parameters()) + list(modules.buffers())]
    for opt in getattr(state, "optimizers", {}).values():
        for st in opt.state.values():
            # the step counters (0-d, on the host) agree on every rank already
            tensors.extend(v for v in st.values() if torch.is_tensor(v) and v.dim() > 0)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=shard.src, group=shard.group)
    return state


def shard_train_step(step_fn, grid: Optional[Grid]):
    """``step_fn`` (a step of ``train_step``) in its data-parallel form: each
    rank calls it with its shard of the batch and the generator that every
    rank seeds alike, and it runs over the data group with the global-batch
    semantics of the module docstring. A data group of one rank gets
    ``step_fn`` itself."""
    shard = shard_of(grid)
    if shard is None:
        return step_fn

    def step(*args, **kwargs):
        with sharded(grid):
            return step_fn(*args, **kwargs)

    return step
