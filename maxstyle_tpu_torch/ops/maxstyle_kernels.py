"""The MaxStyle op on the fused CUDA kernels of ``csrc/maxstyle.cu``.

Counterpart of ``maxstyle_tpu/ops/maxstyle_pallas.py``. Three kernels carry
the op:

* :func:`channel_moments` — per (b, c) plane, the mean and
  sqrt(unbiased variance + eps) (replaces ``_stats_kernel``,
  ``maxstyle_pallas.py:47``, and the finishing lines ``:266-270``);
* :func:`style_apply` — the per-plane (scale, shift) of the MaxStyle chain,
  folded in the kernel as :func:`_coefficients` folds it, and
  out = scale[b,c] * x + shift[b,c] (replaces ``_coefficients``, ``:178``,
  and ``_apply_kernel``, ``:57``);
* :func:`plane_affine_bwd` — dx = g * scale[b,c] and, in the same pass,
  per-plane sums of g and g*x (replaces ``_bwd_kernel``, ``:62``).

The whole normalize / mix / noise / gate chain folds into one affine map per
plane (:func:`_coefficients`, which the apply kernel repeats), and
:class:`_FusedStyle` is its autograd Function, the counterpart of
``_fused_core``'s custom VJP. All three kernels
are bound by device-memory bytes; the note in the CUDA source says how their
design meets that bound. The two reductions run one thread-block cluster
per plane, tiled by :func:`_plane_tiling`.

Inside a data group (``parallel/mesh.sharded``) x holds the rank's rows of
the global batch: the moments of every rank are gathered into the global
[B, C] statistics (one all-reduce a call), the spreads are cached from
them, and :func:`style_apply` reads a row's own statistics and its
partner's from the global ones at the rank's first global row ``row0``.
The moments and backward kernels are per plane and run on the rank's rows.

Each wrapper takes the plain PyTorch version of its kernel for a tensor on
the CPU only; for a CUDA tensor it launches the kernel or raises. The CPU
tests therefore run this module's autograd algebra on the plain versions.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from maxstyle_tpu_torch import kernels
from maxstyle_tpu_torch.config import MaxStyleConfig
from maxstyle_tpu_torch.ops.maxstyle import (MaxStyleParams, MaxStyleState,
                                             _group_size, _styling_float, cached_spreads,
                                             is_noop)
from maxstyle_tpu_torch.parallel import mesh


def _on_cpu(*tensors: torch.Tensor) -> bool:
    if all(t.device.type == "cpu" for t in tensors):
        return True
    kernels.check_cuda_f32("maxstyle", *tensors)
    return False


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------


def channel_moments_plain(x: torch.Tensor, eps: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,C,H,W] -> (mu, sig), each [B,C]: the mean of each plane and
    sqrt(unbiased variance + eps), the variance in one pass and clamped at
    0, as at maxstyle_pallas.py:266-270."""
    hw = x.shape[2] * x.shape[3]
    s, sq = x.sum(dim=(2, 3)), (x * x).sum(dim=(2, 3))
    mu = s / hw
    var = torch.clamp_min(sq / hw - mu * mu, 0.0) * (hw / max(hw - 1, 1))
    return mu, torch.sqrt(var + eps)


def plane_affine_plain(x: torch.Tensor, scale: torch.Tensor,
                       shift: torch.Tensor) -> torch.Tensor:
    return x * scale[:, :, None, None] + shift[:, :, None, None]


def style_apply_plain(cfg: MaxStyleConfig, x, lmda, gn, bn, mu, sig, perm, gstd, bstd,
                      gate, row0: int = 0) -> Tuple[torch.Tensor, ...]:
    """The MaxStyle map of x [b,C,H,W], rows [row0, row0 + b) of a global
    batch of G rows -> (out, scale, shift, mu2, sig2): a row's own
    statistics are mu[row0 + i], sig[row0 + i], its partner's mu2, sig2 =
    mu[perm[row0 + i]], sig[perm[row0 + i]], (scale, shift) from
    :func:`_coefficients` and out = x * scale + shift. lmda [b,1]; gn, bn
    [b,C]; mu, sig [G,C]; perm [G]; spreads [1,C] or [G,C]; gate [1,1]."""
    rows = slice(row0, row0 + x.shape[0])
    p = perm[rows]
    mu2, sig2 = mu[p], sig[p]
    if gstd.shape[0] > 1:
        gstd, bstd = gstd[rows], bstd[rows]
    scale, shift = _coefficients(cfg, lmda, gn, bn, mu[rows], sig[rows], mu2, sig2, gstd,
                                 bstd, gate)
    return plane_affine_plain(x, scale, shift), scale, shift, mu2, sig2


def plane_affine_bwd_plain(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    dx = g * scale[:, :, None, None]
    sums = torch.stack([g.sum(dim=(2, 3)), (g * x).sum(dim=(2, 3))], dim=1)
    return dx, sums


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


MAX_CLUSTER = 8            # the portable thread-block cluster size
MIN_RANK_VALUES = 2048     # a plane is split only into shares of at least this


def _plane_tiling(b: int, c: int, hw: int, sm_count: int) -> Tuple[int, int]:
    """(k, per_rank) for the moments and bwd kernels: each of the b*c planes
    is one cluster of k blocks, and rank r covers values
    [r * per_rank, min(hw, (r + 1) * per_rank)) of it.

    k doubles (up to 8) while the grid has fewer blocks than the card has
    SMs and each rank keeps at least MIN_RANK_VALUES values: the 20-plane
    hook gets 160 blocks, the 320-plane hooks one block a plane, all in one
    wave. per_rank is a multiple of 4, so every rank starts on a float4."""
    planes = b * c
    k = 1
    while k < MAX_CLUSTER and planes * k < sm_count and hw >= 2 * k * MIN_RANK_VALUES:
        k *= 2
    per_rank = -(-hw // k)
    return k, -(-per_rank // 4) * 4


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _tiling(x: torch.Tensor) -> Tuple[int, int]:
    """_plane_tiling of x [B,C,H,W] on the card that holds it."""
    b, c, h, w = x.shape
    return _plane_tiling(b, c, h * w, _sm_count(x.device.index))


def channel_moments(x: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,C,H,W] -> (mu, sig), each [B,C]; see :func:`channel_moments_plain`."""
    if _on_cpu(x):
        return channel_moments_plain(x, eps)
    b, c, h, w = x.shape
    mu = torch.empty((b, c), device=x.device, dtype=torch.float32)
    sig = torch.empty_like(mu)
    kernels.launch("ms_moments", x, mu, sig, b * c, h * w, *_tiling(x), eps)
    kernels.LAUNCHES["maxstyle_stats"] += 1
    return mu, sig


def style_apply(cfg: MaxStyleConfig, x, lmda, gn, bn, mu, sig, perm, gstd, bstd, gate,
                row0: int = 0) -> Tuple[torch.Tensor, ...]:
    """The MaxStyle map in one kernel launch; same contract as
    :func:`style_apply_plain` (mu2, sig2 and shift come back for the
    backward pass and the checks)."""
    if _on_cpu(x, lmda, gn, bn, mu, sig, gstd, bstd, gate):
        return style_apply_plain(cfg, x, lmda, gn, bn, mu, sig, perm, gstd, bstd, gate, row0)
    b, c, h, w = x.shape
    g = mu.shape[0]
    if lmda.shape != (b, 1) or any(t.shape != (b, c) for t in (gn, bn)) \
            or any(t.shape != (g, c) for t in (mu, sig)) or not 0 <= row0 <= g - b \
            or gstd.shape != bstd.shape or gstd.shape not in ((1, c), (g, c)) \
            or gate.numel() != 1:
        raise ValueError("style_apply: lmda [b,1], gn/bn [b,C], mu/sig [G,C] with rows "
                         "[row0, row0 + b) in [0, G), spreads [1,C] or [G,C], gate one value")
    if perm.shape != (g,) or perm.dtype != torch.int64 or perm.device != x.device \
            or not perm.is_contiguous():
        raise ValueError("style_apply: perm must be a contiguous int64 [G] on x's device")
    out = torch.empty_like(x)
    coefs = torch.empty((4, b, c), device=x.device, dtype=torch.float32)
    kernels.launch("ms_style_apply", x, out, lmda, gn, bn, mu, sig, perm, gstd, bstd,
                   c if gstd.shape[0] > 1 else 0, gate, coefs, b * c, h * w, c, row0,
                   int(cfg.mix_style), int(cfg.no_noise))
    kernels.LAUNCHES["maxstyle_apply"] += 1
    return (out, *coefs.unbind(0))


def plane_affine_bwd(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    if _on_cpu(g, x, scale):
        return plane_affine_bwd_plain(g, x, scale)
    b, c, h, w = x.shape
    if g.shape != x.shape or scale.shape != (b, c):
        raise ValueError("g must match x and scale must be [B, C]")
    dx = torch.empty_like(x)
    sums = torch.empty((b, 2, c), device=x.device, dtype=torch.float32)
    kernels.launch("ms_bwd", g, x, scale, dx, sums, b * c, h * w, c, *_tiling(x))
    kernels.LAUNCHES["maxstyle_bwd"] += 1
    return dx, sums


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------


def _coefficients(cfg: MaxStyleConfig, lmda, gn, bn, mu, sig, mu2, sig2,
                  gstd, bstd, gate):
    """Fold the MaxStyle chain into per-(b, c) (scale, shift); all inputs are
    [B, C] (lmda [B, 1]; spreads [1, C] or [B, C]; gate [1, 1])."""
    if cfg.mix_style:
        lm = lmda.clamp(0.0, 1.0)
        sig_mix = sig * (1.0 - lm) + sig2 * lm
        mu_mix = mu * (1.0 - lm) + mu2 * lm
    else:
        sig_mix, mu_mix = sig, mu
    if cfg.no_noise:
        scale = sig_mix / sig
        shift = mu_mix - mu * scale
    else:
        scale = (sig_mix + gn * gstd) / sig
        shift = (mu_mix + bn * bstd) - mu * scale
    # the gate folds into the map: off -> identity
    return gate * scale + (1.0 - gate), gate * shift


class _FusedStyle(torch.autograd.Function):
    """out = style_apply(...)'s out: x * scale + shift with (scale, shift)
    from :func:`_coefficients`. Gradients reach x, lmda (inside the clamp,
    inclusive) and the two noise tensors; mu, sig, perm, the spreads and
    the gate are constants, and every input that needs no gradient gets
    None (the custom VJP's zeros, which autograd drops). mu, sig, perm and
    the spreads are those of the global batch, x, lmda and the noise
    tensors the rows [row0, row0 + b) of it."""

    @staticmethod
    def forward(ctx, cfg, x, lmda, gn, bn, mu, sig, perm, gstd, bstd, gate, row0=0):
        out, scale, _, mu2, sig2 = style_apply(cfg, x, lmda, gn, bn, mu, sig, perm,
                                               gstd, bstd, gate, row0)
        rows = slice(row0, row0 + x.shape[0])
        if gstd.shape[0] > 1:
            gstd, bstd = gstd[rows], bstd[rows]
        ctx.cfg = cfg
        ctx.save_for_backward(x, lmda, scale, mu[rows], sig[rows], mu2, sig2, gstd, bstd, gate)
        return out

    @staticmethod
    def backward(ctx, g):
        cfg = ctx.cfg
        need_x, need_lmda, need_gn, need_bn = ctx.needs_input_grad[1:5]
        x, lmda, scale, mu, sig, mu2, sig2, gstd, bstd, gate = ctx.saved_tensors
        dx, sums = plane_affine_bwd(g.contiguous(), x, scale)
        s_g = sums[:, 0, :]             # sum_hw g          [B, C]
        s_gxn = (sums[:, 1, :] - mu * s_g) / sig  # sum_hw g * x_normed
        d_lmda = d_gn = d_bn = None
        if not cfg.no_noise:
            d_gn = gate * gstd * s_gxn if need_gn else None
            d_bn = gate * bstd * s_g if need_bn else None
        if cfg.mix_style and need_lmda:
            interior = ((lmda >= 0.0) & (lmda <= 1.0)).float()
            d_lm_full = (sig2 - sig) * s_gxn + (mu2 - mu) * s_g
            d_lmda = gate * interior * d_lm_full.sum(dim=1, keepdim=True)
        # None for mu, sig, perm, the spreads, the gate (and row0 when given)
        return ((None, dx if need_x else None, d_lmda, d_gn, d_bn)
                + (None,) * (len(ctx.needs_input_grad) - 5))


def apply_maxstyle_kernels(x: torch.Tensor, params: MaxStyleParams,
                           state: MaxStyleState, cfg: MaxStyleConfig
                           ) -> Tuple[torch.Tensor, MaxStyleState]:
    """Drop-in for ``ops.maxstyle.apply_maxstyle`` on the fused kernels, with
    the same (out, state') contract, first-application spread caching
    included. x: [B,C,H,W], the rank's rows of the global batch in a data
    group, with ``params`` of those rows and ``state`` of the global batch.
    The kernels take float32: half-precision
    activations are cast to it before them and back after."""
    if is_noop(x, cfg):
        return x, state
    in_dtype = x.dtype
    x = _styling_float(x).contiguous()
    b, c = x.shape[:2]
    # stats of a detached input: no gradient ever reaches this kernel
    mu, sig = channel_moments(x.detach(), cfg.eps)
    if mesh.active() is not None:
        mu, sig = mesh.gather_rows(torch.stack([mu, sig], 1)).unbind(1)

    new_state = cached_spreads(state, sig[:, :, None, None], mu[:, :, None, None],
                               _group_size(cfg, mu.shape[0]))
    out = _FusedStyle.apply(
        cfg, x,
        params.lmda.reshape(b, 1),
        params.gamma_noise.reshape(b, c),
        params.beta_noise.reshape(b, c),
        mu.contiguous(), sig.contiguous(), state.perm,
        new_state.gamma_std[:, :, 0, 0], new_state.beta_std[:, :, 0, 0],
        state.gate.reshape(1, 1), mesh.row_offset(b))
    return out.to(in_dtype), new_state
