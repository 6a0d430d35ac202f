"""BatchNorm with the batch's own statistics on the CUDA kernels of
``csrc/batchnorm.cu``.

``models/layers.BatchNorm`` sends its "train" and "frozen" passes of a CUDA
tensor here (outside a data group, the live-statistics route and the
running-update experiment); CPU tensors keep ``F.batch_norm``. Two kernels
carry the op, one launch a direction:

* :func:`batch_norm_fwd` — y = (x - mean) / sqrt(var + eps) * weight + bias
  with the biased batch variance over every dim but the channels'; returns
  y and stats [2, C] = (mean, 1 / sqrt(var + eps)), and with running
  buffers updates them as ``F.batch_norm`` does (momentum, the
  Bessel-corrected variance);
* :func:`batch_norm_bwd` — dx, and where asked dweight and dbias, from dy,
  x and the forward's stats.

:class:`_BatchNorm` ties them into one autograd node, as ``F.batch_norm``
is one. Its backward is not differentiable again (no path of the port
differentiates a gradient); asked to be, it raises.

Each wrapper takes the plain PyTorch version of its kernel for a tensor on
the CPU only; for a CUDA tensor it launches the kernel or raises. The
kernels take float32 [N, C, *spatial] tensors with any number of spatial
dims, in either of two memory orders: NCHW-contiguous (the pair
``bn_fwd``/``bn_bwd``: one thread-block cluster a channel, tiled by
:func:`plan`) or channels-last (``bn_fwd_rows``/``bn_bwd_rows``: rows of C
values over one cooperative grid), each output in its input's order, as
``F.batch_norm`` keeps it. UNETR's image decoder runs channels-last (its
token maps are channels-last views) and the STN's shape path too.
:func:`batch_norm` copies any other order to NCHW first. The note in the
CUDA source says what bounds the kernels and why they split the work so.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from maxstyle_tpu_torch import kernels

MAX_CLUSTER = 16         # Hopper's largest (non-portable) thread-block cluster
MIN_RANK_VALUES = 2048   # a channel is split only into shares of at least this


def plan(channels: int, per_channel: int, capacity: Sequence[int]) -> Tuple[int, int]:
    """(k, per_rank): each channel's ``per_channel`` values are one cluster
    of k blocks, and rank r reduces values [r * per_rank, min(per_channel,
    (r + 1) * per_rank)) of the channel's flat run. ``capacity[k - 1]`` is
    how many clusters of k blocks the card runs at once
    (:func:`cluster_capacity`).

    k is the largest cluster size at which every channel's cluster runs in
    the one wave and each rank keeps at least MIN_RANK_VALUES values, or 1:
    on an H100 [20, 16, 192^2] gets 16 x 12 blocks, [20, 32, 96^2] 32 x 7,
    [20, 64, 48^2] 64 x 3, [20, 128, 24^2] 128 x 2, [20, 128, 12^2] and 768
    channels one block a channel. per_rank is a multiple of 4, so every
    rank starts on a float4."""
    k = 1
    for size in range(2, min(MAX_CLUSTER, len(capacity)) + 1):
        if channels <= capacity[size - 1] and per_channel >= size * MIN_RANK_VALUES:
            k = size
    per_rank = -(-per_channel // k)
    return k, -(-per_rank // 4) * 4


@functools.lru_cache(maxsize=None)
def cluster_capacity(device_index: int) -> Tuple[int, ...]:
    """How many clusters of k = 1 .. MAX_CLUSTER blocks CUDA device
    ``device_index`` runs at once, by CUDA's occupancy calculator at the
    kernels' block size and shared memory: clusters of a GPC's SMs leave
    some SMs of a GPC idle, so this is less than twice the SMs over k."""
    out = ctypes.c_int()
    caps = []
    with torch.cuda.device(device_index):
        for k in range(1, MAX_CLUSTER + 1):
            kernels.query("bn_max_clusters", k, ctypes.addressof(out))
            caps.append(out.value)
    return tuple(caps)


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------


def _dims(x: torch.Tensor) -> Tuple[int, ...]:
    return (0,) + tuple(range(2, x.dim()))


def _bc(t: torch.Tensor, ndim: int) -> torch.Tensor:
    return t.reshape((1, -1) + (1,) * (ndim - 2))


def batch_norm_fwd_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         running_mean: Optional[torch.Tensor],
                         running_var: Optional[torch.Tensor], momentum: float, eps: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, stats [2, C]); see :func:`batch_norm_fwd`."""
    var, mean = torch.var_mean(x, dim=_dims(x), unbiased=False)
    invstd = torch.rsqrt(var + eps)
    scale = weight * invstd
    y = torch.addcmul(_bc(bias - mean * scale, x.dim()), x, _bc(scale, x.dim()))
    if running_mean is not None:
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            running_mean.mul_(1.0 - momentum).add_(momentum * mean)
            running_var.mul_(1.0 - momentum).add_(momentum * n / (n - 1) * var)
    return y, torch.stack([mean, invstd])


def batch_norm_bwd_plain(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                         stats: torch.Tensor, need_dx: bool = True, need_affine: bool = True):
    """(dx, dweight, dbias), each None where not asked for; see
    :func:`batch_norm_bwd`."""
    nd = x.dim()
    n = x.numel() // x.shape[1]
    mean, invstd = stats
    xhat = (x - _bc(mean, nd)) * _bc(invstd, nd)
    s_dy = dy.sum(dim=_dims(x))
    s_dy_xhat = (dy * xhat).sum(dim=_dims(x))
    dx = None
    if need_dx:
        dx = _bc(weight * invstd, nd) * (dy - _bc(s_dy / n, nd) - xhat * _bc(s_dy_xhat / n, nd))
    return (dx, s_dy_xhat, s_dy) if need_affine else (dx, None, None)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def rows_max_blocks(device_index: int) -> int:
    """The most blocks a channels-last launch on CUDA device
    ``device_index`` takes: its scratch holds that many partials a
    channel."""
    out = ctypes.c_int()
    with torch.cuda.device(device_index):
        kernels.query("bn_rows_max_blocks", ctypes.addressof(out))
    return out.value


def _layout(x: torch.Tensor) -> Optional[torch.memory_format]:
    """``torch.contiguous_format`` for an NCHW-contiguous x, the
    channels-last format whose memory order x has, or None."""
    if x.is_contiguous():
        return torch.contiguous_format
    fmt = {4: torch.channels_last, 5: torch.channels_last_3d}.get(x.dim())
    return fmt if fmt is not None and x.is_contiguous(memory_format=fmt) else None


def _check(name: str, x: torch.Tensor, *vectors: Optional[torch.Tensor]
           ) -> torch.memory_format:
    """Raise on what the kernels do not take (float32 on one CUDA device,
    per-channel vectors contiguous and [C], x NCHW or channels-last);
    returns x's memory order. ``None`` vectors are skipped. Tensor
    properties only, no device objects: this runs once a BatchNorm pass,
    on the host-bound step's critical path."""
    dev = x.get_device()
    c = x.shape[1] if x.dim() >= 2 else -1
    for v in vectors:
        if v is not None and (v.get_device() != dev or v.dtype is not torch.float32
                              or not v.is_contiguous() or v.shape != (c,)):
            kernels.check_cuda_f32(name, x.new_empty(0), v)
            raise ValueError(f"{name}: expected [N, C, *spatial] and [C] vectors, got "
                             f"{tuple(x.shape)} and {tuple(v.shape)}")
    if dev < 0 or x.dtype is not torch.float32 or c < 0:
        raise ValueError(f"{name}: x must be a float32 CUDA tensor [N, C, *spatial], got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    fmt = _layout(x)
    if fmt is None:
        raise ValueError(f"{name}: expected an NCHW-contiguous or channels-last tensor")
    return fmt


@functools.lru_cache(maxsize=None)
def _launch_shape(shape: torch.Size, device_index: int) -> Tuple[int, int, int, int, int]:
    """(N, C, spatial size, k, per_rank) of a kernel call on a tensor of
    ``shape`` on CUDA device ``device_index``; raises on a shape the
    kernels do not take. Cached: the training step repeats a few shapes."""
    if len(shape) < 2:
        raise ValueError(f"batch_norm: expected [N, C, *spatial], got {tuple(shape)}")
    n, c = shape[:2]
    numel = shape.numel()
    if numel == 0 or numel > 2 ** 31 - 1:
        raise ValueError(f"batch_norm: {numel} values; the kernels take 1 to 2^31 - 1")
    if numel == c:
        raise ValueError(f"batch_norm: expected more than 1 value per channel when training, "
                         f"got input size {list(shape)}")
    s = numel // (n * c)
    return (n, c, s) + plan(c, n * s, cluster_capacity(device_index))


def _forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             running_mean: Optional[torch.Tensor], running_var: Optional[torch.Tensor],
             momentum: float, eps: float
             ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.memory_format]]:
    """:func:`batch_norm_fwd`'s (y, stats) and x's memory order, None on
    the CPU."""
    if x.is_cpu:
        return batch_norm_fwd_plain(x, weight, bias, running_mean, running_var, momentum,
                                    eps) + (None,)
    if (running_mean is None) != (running_var is None):
        raise ValueError("batch_norm_fwd: give both running buffers or neither")
    fmt = _check("batch_norm_fwd", x, weight, bias, running_mean, running_var)
    dev = x.get_device()
    n, c, s, k, per_rank = _launch_shape(x.shape, dev)
    y = torch.empty_like(x)
    stats = x.new_empty((2, c))
    if fmt is torch.contiguous_format:
        kernels.launch("bn_fwd", x, y, weight, bias, stats, running_mean, running_var, n, c, s,
                       k, per_rank, momentum, eps)
    else:
        groups = rows_max_blocks(dev)
        kernels.launch("bn_fwd_rows", x, y, weight, bias, stats, running_mean, running_var,
                       x.new_empty((groups, c, 3)), groups, n * s, c, momentum, eps)
    kernels.LAUNCHES["batchnorm_fwd"] += 1
    return y, stats, fmt


def batch_norm_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   running_mean: Optional[torch.Tensor], running_var: Optional[torch.Tensor],
                   momentum: float, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [N, C, *spatial] normalised with its batch statistics -> (y in x's
    memory order, stats [2, C] = (mean, 1 / sqrt(biased var + eps))). With
    running buffers ([C], both or neither) they become (1 - momentum) *
    running + momentum * (mean, unbiased var), in place."""
    y, stats, _ = _forward(x, weight, bias, running_mean, running_var, momentum, eps)
    return y, stats


def _backward(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor, stats: torch.Tensor,
              fmt: torch.memory_format, need_dx: bool, need_affine: bool):
    """:func:`batch_norm_bwd` on CUDA inputs that passed its checks, x and
    dy in memory order ``fmt``."""
    dev = x.get_device()
    n, c, s, k, per_rank = _launch_shape(x.shape, dev)
    dx = torch.empty_like(x) if need_dx else None
    dw = db = None
    if need_affine:
        dw, db = x.new_empty((2, c))
    if fmt is torch.contiguous_format:
        kernels.launch("bn_bwd", dy, x, weight, stats, dx, dw, db, n, c, s, k, per_rank)
    else:
        groups = rows_max_blocks(dev)
        kernels.launch("bn_bwd_rows", dy, x, weight, stats, dx, dw, db,
                       x.new_empty((groups, c, 2)), groups, n * s, c)
    kernels.LAUNCHES["batchnorm_bwd"] += 1
    return dx, dw, db


def batch_norm_bwd(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                   stats: torch.Tensor, need_dx: bool = True, need_affine: bool = True):
    """(dx, dweight, dbias) of :func:`batch_norm_fwd`'s y given its gradient
    dy (in x's memory order), each None where not asked for."""
    if x.is_cpu:
        return batch_norm_bwd_plain(dy, x, weight, stats, need_dx, need_affine)
    fmt = _check("batch_norm_bwd", x, weight)
    dev, c = x.get_device(), x.shape[1]
    if dy.shape != x.shape or not dy.is_contiguous(memory_format=fmt) \
            or dy.dtype is not torch.float32 or dy.get_device() != dev \
            or stats.shape != (2, c) or stats.dtype is not torch.float32 \
            or stats.get_device() != dev or not stats.is_contiguous():
        raise ValueError("batch_norm_bwd: dy must match x in shape, memory order and dtype, "
                         "and stats must be [2, C]")
    return _backward(dy, x, weight, stats, fmt, need_dx, need_affine)


class _BatchNorm(torch.autograd.Function):
    """y = batch_norm_fwd(...)'s y; gradients reach x, weight and bias. The
    forward checks its inputs once and passes x's memory order on to the
    backward, which launches without checking again."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps):
        y, stats, ctx.fmt = _forward(x, weight, bias, running_mean, running_var, momentum, eps)
        ctx.save_for_backward(x, weight, stats)
        return y

    @staticmethod
    def backward(ctx, dy):
        if torch.is_grad_enabled():
            raise RuntimeError("the BatchNorm kernels' backward is not differentiable "
                               "(create_graph=True)")
        x, weight, stats = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        if ctx.fmt is None:
            dx, dw, db = batch_norm_bwd_plain(dy, x, weight, stats, need_x, need_w or need_b)
        else:
            # autograd hands dy in y's shape, dtype and device; only its
            # memory order can differ from x's
            if not dy.is_contiguous(memory_format=ctx.fmt):
                dy = dy.contiguous(memory_format=ctx.fmt)
            dx, dw, db = _backward(dy, x, weight, stats, ctx.fmt, need_x, need_w or need_b)
        return dx, dw if need_w else None, db if need_b else None, None, None, None, None


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               running_mean: Optional[torch.Tensor], running_var: Optional[torch.Tensor],
               momentum: float, eps: float) -> torch.Tensor:
    """``F.batch_norm(x, running_mean, running_var, weight, bias, True,
    momentum, eps)`` on the kernels, differentiable in x, weight and bias;
    without running buffers nothing is written (the "frozen" pass). An x
    neither NCHW-contiguous nor channels-last is copied to NCHW first."""
    if _layout(x) is None:
        x = x.contiguous()
    return _BatchNorm.apply(x, weight, bias, running_mean, running_var, momentum, eps)
