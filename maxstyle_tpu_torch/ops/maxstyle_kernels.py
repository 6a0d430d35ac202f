"""The MaxStyle op on the fused CUDA kernels of ``csrc/maxstyle.cu``.

Counterpart of ``maxstyle_tpu/ops/maxstyle_pallas.py``. Three kernels carry
the op:

* :func:`channel_sums` — per (b, c) plane, sum and sum of squares
  (replaces ``_stats_kernel``, ``maxstyle_pallas.py:47``);
* :func:`plane_affine` — out = scale[b,c] * x + shift[b,c]
  (replaces ``_apply_kernel``, ``:57``);
* :func:`plane_affine_bwd` — dx = g * scale[b,c] and, in the same pass,
  per-plane sums of g and g*x (replaces ``_bwd_kernel``, ``:62``).

The whole normalize / mix / noise / gate chain folds into one affine map per
plane (:func:`_coefficients`), and :class:`_FusedStyle` is its autograd
Function, the counterpart of ``_fused_core``'s custom VJP. All three kernels
are bound by device-memory bytes; the note in the CUDA source says how their
design meets that bound.

Each wrapper takes the plain PyTorch version of its kernel for a tensor on
the CPU only; for a CUDA tensor it launches the kernel or raises. The CPU
tests therefore run this module's autograd algebra on the plain versions.
"""

from __future__ import annotations

from typing import Tuple

import torch

from maxstyle_tpu_torch import kernels
from maxstyle_tpu_torch.config import MaxStyleConfig
from maxstyle_tpu_torch.ops.maxstyle import (MaxStyleParams, MaxStyleState,
                                             _group_size, cached_spreads, is_noop)


def _on_cpu(*tensors: torch.Tensor) -> bool:
    if all(t.device.type == "cpu" for t in tensors):
        return True
    kernels.check_cuda_f32("maxstyle", *tensors)
    return False


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------


def channel_sums_plain(x: torch.Tensor) -> torch.Tensor:
    """x [B,C,H,W] -> [B,2,C] = (sum, sum of squares) over each plane."""
    return torch.stack([x.sum(dim=(2, 3)), (x * x).sum(dim=(2, 3))], dim=1)


def plane_affine_plain(x: torch.Tensor, scale: torch.Tensor,
                       shift: torch.Tensor) -> torch.Tensor:
    return x * scale[:, :, None, None] + shift[:, :, None, None]


def plane_affine_bwd_plain(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    dx = g * scale[:, :, None, None]
    sums = torch.stack([g.sum(dim=(2, 3)), (g * x).sum(dim=(2, 3))], dim=1)
    return dx, sums


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def channel_sums(x: torch.Tensor) -> torch.Tensor:
    if _on_cpu(x):
        return channel_sums_plain(x)
    b, c, h, w = x.shape
    sums = torch.zeros((b, 2, c), device=x.device, dtype=torch.float32)
    kernels.launch("ms_stats", x, sums, b * c, h * w, c)
    kernels.LAUNCHES["maxstyle_stats"] += 1
    return sums


def plane_affine(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    if _on_cpu(x, scale, shift):
        return plane_affine_plain(x, scale, shift)
    b, c, h, w = x.shape
    if scale.shape != (b, c) or shift.shape != (b, c):
        raise ValueError(f"scale/shift must be [{b}, {c}]")
    out = torch.empty_like(x)
    kernels.launch("ms_apply", x, scale, shift, out, b * c, h * w)
    kernels.LAUNCHES["maxstyle_apply"] += 1
    return out


def plane_affine_bwd(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    if _on_cpu(g, x, scale):
        return plane_affine_bwd_plain(g, x, scale)
    b, c, h, w = x.shape
    if g.shape != x.shape or scale.shape != (b, c):
        raise ValueError("g must match x and scale must be [B, C]")
    dx = torch.empty_like(x)
    sums = torch.zeros((b, 2, c), device=x.device, dtype=torch.float32)
    kernels.launch("ms_bwd", g, x, scale, dx, sums, b * c, h * w, c)
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
    """out = plane_affine(x, scale, shift) with (scale, shift) from
    :func:`_coefficients`. Gradients reach x, lmda (inside the clamp,
    inclusive) and the two noise tensors; mu, sig, the spreads and the gate
    are constants and get zero."""

    @staticmethod
    def forward(ctx, cfg, x, lmda, gn, bn, mu, sig, mu2, sig2, gstd, bstd, gate):
        scale, shift = _coefficients(cfg, lmda, gn, bn, mu, sig, mu2, sig2,
                                     gstd, bstd, gate)
        ctx.cfg = cfg
        ctx.save_for_backward(x, lmda, scale, mu, sig, mu2, sig2, gstd, bstd, gate)
        return plane_affine(x, scale.contiguous(), shift.contiguous())

    @staticmethod
    def backward(ctx, g):
        cfg = ctx.cfg
        x, lmda, scale, mu, sig, mu2, sig2, gstd, bstd, gate = ctx.saved_tensors
        dx, sums = plane_affine_bwd(g.contiguous(), x, scale.contiguous())
        s_g = sums[:, 0, :]             # sum_hw g          [B, C]
        s_gxn = (sums[:, 1, :] - mu * s_g) / sig  # sum_hw g * x_normed
        if cfg.no_noise:
            d_gn = torch.zeros_like(s_g)
            d_bn = torch.zeros_like(s_g)
        else:
            d_gn = gate * gstd * s_gxn
            d_bn = gate * bstd * s_g
        if cfg.mix_style:
            interior = ((lmda >= 0.0) & (lmda <= 1.0)).float()
            d_lm_full = (sig2 - sig) * s_gxn + (mu2 - mu) * s_g
            d_lmda = gate * interior * d_lm_full.sum(dim=1, keepdim=True)
        else:
            d_lmda = torch.zeros_like(lmda)
        z = torch.zeros_like
        return (None, dx, d_lmda, d_gn, d_bn, z(mu), z(sig), z(mu2), z(sig2),
                z(gstd), z(bstd), z(gate))


def apply_maxstyle_kernels(x: torch.Tensor, params: MaxStyleParams,
                           state: MaxStyleState, cfg: MaxStyleConfig
                           ) -> Tuple[torch.Tensor, MaxStyleState]:
    """Drop-in for ``ops.maxstyle.apply_maxstyle`` on the fused kernels, with
    the same (out, state') contract, first-application spread caching
    included. x: [B,C,H,W]."""
    if is_noop(x, cfg):
        return x, state
    x = x.contiguous()
    b, c, h, w = x.shape
    hw = h * w
    # stats of a detached input: no gradient ever reaches this kernel
    sums = channel_sums(x.detach())
    mu = sums[:, 0, :] / hw
    # unbiased variance, single pass, as at maxstyle_pallas.py:266-270
    var = torch.clamp_min(sums[:, 1, :] / hw - mu * mu, 0.0) * (hw / max(hw - 1, 1))
    sig = torch.sqrt(var + cfg.eps)

    new_state = cached_spreads(state, sig[:, :, None, None], mu[:, :, None, None],
                               _group_size(cfg, b))
    out = _FusedStyle.apply(
        cfg, x,
        params.lmda.reshape(b, 1),
        params.gamma_noise.reshape(b, c),
        params.beta_noise.reshape(b, c),
        mu, sig, mu[state.perm], sig[state.perm],
        new_state.gamma_std[:, :, 0, 0], new_state.beta_std[:, :, 0, 0],
        state.gate.reshape(1, 1))
    return out, new_state
