"""Segmentation, reconstruction and consistency losses (NCHW).

Counterpart of ``maxstyle_tpu/losses.py``, itself the reference's
custom_loss.py, with its reduction and weighting semantics:

* logits [N,C,H,W]; hard labels [N,H,W] integers; soft targets [N,C,H,W]
  (logits unless ``is_gt``); masks [N,1,H,W] or [N,C,H,W], whose zeros
  leave a pixel out of the sum while the denominator stays N*H*W.

Every loss computes in float32 (:func:`_f32`): under the bf16 compute
policy model outputs arrive in bf16, and log, softmax and the reductions
must not run at half precision.

In a data group (``parallel/mesh.sharded``) a loss that averages over the
batch returns the rank's share of the global mean (``mesh.share``: its
local sum over the global count), so the ranks' shares add up to the loss
of the global batch; a denominator that is a data-dependent sum (a mask's)
is summed over the group.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from maxstyle_tpu_torch.parallel import mesh

_SOBEL_X = ((1.0, 0.0, -1.0), (2.0, 0.0, -2.0), (1.0, 0.0, -1.0))
_SOBEL_Y = ((1.0, 2.0, 1.0), (0.0, 0.0, 0.0), (-1.0, -2.0, -1.0))


def _f32(x):
    """A floating tensor of another dtype as float32; anything else as it is."""
    if torch.is_tensor(x) and x.is_floating_point() and x.dtype != torch.float32:
        return x.float()
    return x


@functools.lru_cache(maxsize=8)
def _sobel_kernels(device: torch.device) -> torch.Tensor:
    """The (x, y) Sobel filters [2,1,3,3] on ``device``, copied there once:
    a copy to the GPU in every call would wait for the device."""
    return torch.tensor((_SOBEL_X, _SOBEL_Y), dtype=torch.float32, device=device)[:, None]


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """[N,...] int -> [N,C,...] one-hot in the default float dtype."""
    oh = F.one_hot(labels.long(), num_classes)
    return oh.movedim(-1, 1).to(torch.get_default_dtype())


def _normalized_class_weights(weight: Sequence[float], num_classes: int,
                              device) -> torch.Tensor:
    """The reference normalizes class weights to sum to C."""
    w = torch.as_tensor(weight, dtype=torch.float32, device=device)
    return w / w.sum() * num_classes


def cross_entropy_2d(logits: torch.Tensor, target: torch.Tensor,
                     weight: Optional[Sequence[float]] = None,
                     size_average: bool = True, mask: Optional[torch.Tensor] = None,
                     is_gt: bool = False) -> torch.Tensor:
    """Pixelwise cross entropy against hard labels [N,H,W] or soft targets
    [N,C,H,W] (logits, or probabilities with ``is_gt``); the denominator
    under ``size_average`` is N*H*W whatever the mask and the class weights
    (custom_loss.cross_entropy_2D:1043-1105)."""
    logits, target = _f32(logits), _f32(target)
    n, c, h, w = logits.shape
    log_p = F.log_softmax(logits, dim=1)
    denom = float(n * h * w)
    if target.dim() == 3:
        tgt = target.long()
        nll = -torch.gather(log_p, 1, tgt[:, None])[:, 0]  # [N,H,W]
        if weight is not None:
            nll = nll * _normalized_class_weights(weight, c, logits.device)[tgt]
        if mask is not None:
            nll = nll * mask.detach().reshape(n, h, w).to(nll.dtype)
        loss = nll.sum()
    elif target.dim() == 4:
        q = target if is_gt else torch.softmax(target, dim=1)
        plogq = q * log_p
        if mask is not None:
            plogq = plogq * mask.detach().reshape(n, 1, h, w).to(plogq.dtype)
        if weight is not None:
            plogq = plogq * _normalized_class_weights(weight, c, logits.device)[:, None, None]
        loss = -plogq.sum()
    else:
        raise NotImplementedError(f"bad target rank {target.dim()}")
    return mesh.share(loss / denom) if size_average else loss


def soft_dice_loss(logits: torch.Tensor, target: torch.Tensor, num_classes: int,
                   weight=None, mask: Optional[torch.Tensor] = None, is_gt: bool = False,
                   squared_union: bool = False, class_ids: Optional[Sequence[int]] = None,
                   smooth: float = 0.01) -> torch.Tensor:
    """Soft Dice (custom_loss.SoftDiceLoss:546-600, SelectiveSoftDiceLoss
    :604-645) of logits [B,C,...] against labels [B,...] or soft targets
    [B,C,...]. ``class_ids`` picks a class subset, and then the smooth term
    moves outside the per-class sums, as in the selective variant. The
    reference takes ``weight`` and never uses it."""
    logits, target = _f32(logits), _f32(target)
    b = logits.shape[0]
    probs = torch.softmax(logits, dim=1)
    if target.dim() == logits.dim() - 1:
        tgt = one_hot(target, num_classes).float()
    else:
        tgt = target if is_gt else torch.softmax(target, dim=1)
    if mask is not None:
        probs = probs * mask
        tgt = tgt * mask
    p = probs.reshape(b, num_classes, -1)
    t = tgt.reshape(b, num_classes, -1)
    if class_ids is not None:
        idx = list(class_ids)
        p, t = p[:, idx], t[:, idx]
        inter = torch.sum(p * t, dim=2)
        if squared_union:
            union = torch.sum(p ** 2, dim=2) + torch.sum(t ** 2, dim=2)
        else:
            union = torch.sum(p, dim=2) + torch.sum(t, dim=2)
        score = torch.sum((2.0 * inter + smooth) / (union + smooth))
        return mesh.share(1.0 - score / (float(b) * float(len(idx))))
    inter = torch.sum(p * t, dim=2) + smooth
    if squared_union:
        union = torch.sum(p ** 2, dim=2) + torch.sum(t ** 2, dim=2) + smooth
    else:
        union = torch.sum(p, dim=2) + torch.sum(t, dim=2) + smooth
    score = torch.sum(2.0 * inter / union)
    return mesh.share(1.0 - score / (float(b) * float(num_classes)))


def focal_loss(logits: torch.Tensor, target: torch.Tensor, gamma: float = 2.0,
               alpha=None, size_average: bool = True) -> torch.Tensor:
    """Focal loss (custom_loss.FocalLoss:412-445); ``pt`` is detached, as
    the reference's ``Variable(logpt.data.exp())``. A scalar ``alpha``
    weighs class 0 by alpha and class 1 by 1 - alpha."""
    logits = _f32(logits)
    tgt = target.long()
    logpt = torch.gather(F.log_softmax(logits, dim=1), 1, tgt[:, None])[:, 0]
    pt = torch.exp(logpt).detach()
    if alpha is not None:
        avec = torch.as_tensor(alpha, dtype=logits.dtype, device=logits.device)
        if avec.dim() == 0:
            avec = torch.stack([avec, 1.0 - avec])
        logpt = logpt * avec[tgt]
    loss = -((1.0 - pt) ** gamma) * logpt
    return mesh.share(torch.mean(loss)) if size_average else torch.sum(loss)


def entropy_loss_probs(probs: torch.Tensor, base=2, normalize: bool = False,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Entropy of probability maps [N,C,H,W] (custom_loss.entropy_loss
    :664-689): summed over everything and divided by N*H*W, or by the sum
    of ``mask``, which weighs nothing else."""
    probs = _f32(probs)
    n, c, h, w = probs.shape
    if mask is None:
        denom = float(mesh.global_batch(n) * h * w)
    else:
        denom = mesh.all_sum(torch.sum(_f32(mask)).detach())
    if base == 2:
        loss = -torch.sum(probs * torch.log2(probs + 1e-30)) / denom
        return loss / math.log2(c) if normalize else loss
    loss = -torch.sum(probs * torch.log(probs + 1e-30)) / denom
    return loss / math.log(c) if normalize else loss


def entropy_loss_logits(logits: torch.Tensor) -> torch.Tensor:
    """Mean per-pixel softmax entropy (custom_loss.EntropyLoss:346-361)."""
    logits = _f32(logits)
    ent = -torch.sum(torch.softmax(logits, dim=1) * F.log_softmax(logits, dim=1), dim=1)
    return mesh.share(torch.mean(ent))


# ---------------------------------------------------------------------------
# Sobel gradients and contour losses
# ---------------------------------------------------------------------------


def _dense_sobel(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's dense Sobel conv (every (out, in) tap is the Sobel
    kernel, custom_loss.py:1155-1175), as the JAX package computes it: the
    channels are summed first and the one response is broadcast to every
    output channel. Padding SAME."""
    summed = x.sum(dim=1, keepdim=True)
    g = F.conv2d(summed, _sobel_kernels(x.device), padding=1)
    return g[:, :1].expand_as(x), g[:, 1:].expand_as(x)


def contour_loss(probs: torch.Tensor, target: torch.Tensor, num_classes: Optional[int] = None,
                 ignore_background: bool = True, one_hot_target: bool = True,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sobel-gradient MSE between probability maps [N,C,H,W] and a target,
    hard labels with ``one_hot_target`` or maps otherwise
    (custom_loss.contour_loss:1120-1197)."""
    probs = _f32(probs)
    if one_hot_target:
        if num_classes is None:
            raise ValueError("contour_loss: one_hot_target needs num_classes")
        tgt = one_hot(target, num_classes).float()
    else:
        tgt = _f32(target)
    if ignore_background:
        probs, tgt = probs[:, 1:], tgt[:, 1:]
    mask = torch.ones_like(probs) if mask is None else mask.expand_as(probs)
    gx_p, gy_p = _dense_sobel(probs)
    gx_t, gy_t = _dense_sobel(tgt.detach())
    loss = (torch.mean((gx_p * mask - gx_t * mask) ** 2)
            + torch.mean((gy_p * mask - gy_t * mask) ** 2))
    return mesh.share(0.5 * loss)


# ---------------------------------------------------------------------------
# Divergences and the consistency family
# ---------------------------------------------------------------------------


def kl_divergence(reference: torch.Tensor, pred: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, is_gt: bool = False) -> torch.Tensor:
    """DKL(P||Q) per pixel, averaged, with P = softmax(reference) and Q =
    softmax(pred), both logits [N,C,H,W]; with ``is_gt`` the reference is a
    one-hot map and P is 1 on its support and 1e-8 elsewhere
    (custom_loss.kl_divergence:1200-1227)."""
    reference, pred = _f32(reference), _f32(pred)
    mask = torch.ones_like(pred) if mask is None else mask
    if is_gt:
        p = torch.where(reference == 0.0, 1e-8, 1.0)
        log_p = torch.log(p)
    else:
        p = torch.softmax(reference, dim=1)
        log_p = F.log_softmax(reference, dim=1)
    plogp = torch.sum(mask * (p * log_p), dim=1, keepdim=True)
    plogq = torch.sum(mask * (p * F.log_softmax(pred, dim=1)), dim=1, keepdim=True)
    return mesh.share(torch.mean(plogp - plogq))


def js_divergence(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """JS divergence between two logit maps (custom_loss.calc_js_divergece
    :1230-1258): the class-summed KLs to the mean, averaged over pixels."""
    pred, target = _f32(pred), _f32(target)
    p = torch.softmax(pred, dim=1)
    q = torch.softmax(target, dim=1)
    m_log = torch.log(torch.clamp(0.5 * (p + q), 1e-8, 1.0))
    n_pix = float(pred.numel() // pred.shape[1])
    kl1 = torch.sum(p * (torch.log(torch.clamp(p, 1e-30, 1.0)) - m_log)) / n_pix
    kl2 = torch.sum(q * (torch.log(torch.clamp(q, 1e-30, 1.0)) - m_log)) / n_pix
    return mesh.share(0.5 * (kl1 + kl2))


def segmentation_consistency(output: torch.Tensor, reference: torch.Tensor,
                             divergence_types: Sequence[str] = ("kl", "contour"),
                             divergence_weights: Sequence[float] = (1.0, 0.5),
                             class_weights=None, scales: Sequence[int] = (0,),
                             mask: Optional[torch.Tensor] = None,
                             is_gt: bool = False) -> torch.Tensor:
    """Weighted multi-scale consistency between two logit maps [N,C,H,W]
    (custom_loss.calc_segmentation_consistency:1261-1341): at each scale s
    the maps (and the mask) are average-pooled by 2^s, each divergence
    ("kl", "ce", "weighted ce", "Dice", "mse", "contour") is weighted by
    2^s times its weight, and the sum is averaged over the scales."""
    output, reference = _f32(output), _f32(reference)
    num_classes = reference.shape[1]
    mask = torch.ones_like(output) if mask is None else _f32(mask)
    dist = 0.0
    for scale in scales:
        if scale > 0:
            k = 2 ** scale
            ref_s, out_s, mask_s = (F.avg_pool2d(t, k, k) for t in (reference, output, mask))
        else:
            ref_s, out_s, mask_s = reference, output, mask
        for div_type, d_weight in zip(divergence_types, divergence_weights):
            if div_type == "kl":
                loss = kl_divergence(ref_s, out_s, mask=mask_s, is_gt=is_gt)
            elif div_type in ("ce", "weighted ce"):
                if div_type == "weighted ce" and class_weights is None:
                    raise ValueError("the 'weighted ce' divergence needs class_weights")
                loss = cross_entropy_2d(out_s, ref_s, mask=mask_s[:, :1], is_gt=is_gt,
                                        weight=class_weights if div_type == "weighted ce"
                                        else None)
            elif div_type == "Dice":
                loss = soft_dice_loss(out_s, ref_s, num_classes, mask=mask_s, is_gt=is_gt)
            elif div_type == "mse":
                tgt = ref_s if is_gt else torch.softmax(ref_s, dim=1)
                inp = torch.softmax(out_s, dim=1)
                n, _, h, w = out_s.shape
                loss = mesh.share(torch.sum((tgt * mask_s - inp * mask_s) ** 2)
                                  / float(n * h * w))
            elif div_type == "contour":
                tgt = ref_s if is_gt else torch.softmax(ref_s, dim=1)
                inp = torch.softmax(out_s, dim=1)
                loss = 0.0
                for i in range(1, num_classes):
                    loss = loss + contour_loss(inp[:, i:i + 1], tgt[:, i:i + 1],
                                               ignore_background=False, one_hot_target=False,
                                               mask=mask_s[:, :1])
                if num_classes > 1:
                    loss = loss / float(num_classes - 1)
            else:
                raise NotImplementedError(f"consistency divergence {div_type!r}")
            dist = dist + (2 ** scale) * d_weight * loss
    return dist / float(len(scales))


# ---------------------------------------------------------------------------
# Reconstruction losses
# ---------------------------------------------------------------------------


def mse_recon_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """0.5 * mean squared error against a detached target."""
    return mesh.share(0.5 * torch.mean((_f32(pred) - _f32(target).detach()) ** 2))


def l1_recon_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return mesh.share(torch.mean(torch.abs(_f32(pred) - _f32(target).detach())))


def normalized_cross_correlation(x: torch.Tensor, y: torch.Tensor,
                                 eps: float = 1e-8) -> torch.Tensor:
    """Batchwise NCC scalar (custom_loss.normalized_cross_correlation:76-127,
    reduction "mean")."""
    b = x.shape[0]
    xf = x.reshape(b, -1)
    yf = y.reshape(b, -1)
    xf = xf - xf.mean(dim=1, keepdim=True)
    yf = yf - yf.mean(dim=1, keepdim=True)
    denom = torch.sqrt(torch.sum(xf * xf, dim=1, keepdim=True)
                       * torch.sum(yf * yf, dim=1, keepdim=True)) + eps
    ncc = (xf * yf + eps / xf.shape[1]) / denom
    return mesh.share(torch.mean(torch.sum(ncc, dim=1)))


@functools.lru_cache(maxsize=16)
def _gaussian_kernel(sigma: float, channels: int, device: torch.device) -> torch.Tensor:
    """NGF_Loss.get_gaussian_kernel (custom_loss.py:283-326) as depthwise
    filters [C,1,ks,ks]. The reference asks for a 3x3 kernel, but its
    min-size rule grows it to 2*int(3.5*sigma)+1: 7x7 for sigma 1."""
    ks = max(3, 2 * int(3.5 * sigma) + 1)
    coords = np.arange(ks, dtype=np.float32)
    gx, gy = np.meshgrid(coords, coords, indexing="ij")
    mean = (ks - 1) / 2.0
    k = np.exp(-((gx - mean) ** 2 + (gy - mean) ** 2) / (2 * sigma ** 2))
    k = (k / k.sum()).astype(np.float32)
    return torch.from_numpy(np.tile(k[None, None], (channels, 1, 1, 1))).to(device)


def _gaussian_blur3(x: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """Depthwise gaussian smoothing of x [N,C,H,W], zero "SAME" padding."""
    kern = _gaussian_kernel(sigma, x.shape[1], x.device)
    return F.conv2d(x, kern, padding=kern.shape[-1] // 2, groups=x.shape[1])


def ngf_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Normalized-gradient-field reconstruction loss (custom_loss.NGF_Loss
    :215-343): both images gaussian-smoothed, their Sobel gradients
    compared by NCC per axis, 1 - the mean; the target is detached."""
    pred, target = _f32(pred), _f32(target).detach()
    gx_t, gy_t = _dense_sobel(_gaussian_blur3(target))
    gx_p, gy_p = _dense_sobel(_gaussian_blur3(pred))
    value = 0.5 * (normalized_cross_correlation(gx_t, gx_p)
                   + normalized_cross_correlation(gy_t, gy_p))
    return mesh.share(1.0) - value


def tv_loss(x: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """Total variation of x [N,C,H,W] (custom_loss.TVLoss:1024-1040)."""
    x = _f32(x)
    b, c, h, w = x.shape
    h_tv = torch.sum((x[:, :, 1:, :] - x[:, :, :h - 1, :]) ** 2)
    w_tv = torch.sum((x[:, :, :, 1:] - x[:, :, :, :w - 1]) ** 2)
    return mesh.share(weight * 2.0 * (h_tv / float(c * (h - 1) * w)
                                      + w_tv / float(c * h * (w - 1))) / b)


def image_recon_loss(pred: torch.Tensor, target: torch.Tensor,
                     rec_loss_type: str = "l2") -> torch.Tensor:
    """The solver's reconstruction loss: "l2", "l1" or "ngf"."""
    if rec_loss_type == "l2":
        return mse_recon_loss(pred, target)
    if rec_loss_type == "l1":
        return l1_recon_loss(pred, target)
    if rec_loss_type == "ngf":
        return ngf_loss(pred, target)
    raise NotImplementedError(f"rec_loss_type {rec_loss_type!r}")


def basic_loss_fn(pred: torch.Tensor, target: torch.Tensor,
                  loss_type: str = "cross entropy", class_weights=None) -> torch.Tensor:
    """Supervised-segmentation loss dispatch (custom_loss.basic_loss_fn:13-45).
    As in the JAX package, "cross entropy" ignores ``class_weights``, which
    default to 1/C each, and "weighted dice" is "dice" (the reference's
    SoftDiceLoss never uses its weight)."""
    num_classes = pred.shape[1]
    if class_weights is None:
        class_weights = [1.0 / num_classes] * num_classes
    if loss_type == "cross entropy":
        return cross_entropy_2d(pred, target)
    if loss_type == "weighted cross entropy":
        return cross_entropy_2d(pred, target, weight=class_weights)
    if loss_type in ("dice", "weighted dice"):
        return soft_dice_loss(pred, target, num_classes)
    if loss_type == "foreground dice":
        return soft_dice_loss(pred, target, num_classes, class_ids=list(range(1, num_classes)))
    if loss_type == "focal":
        return focal_loss(pred, target, gamma=2.0)
    if loss_type == "contour_smooth":
        # the softmax in the logits' dtype, as the JAX package computes it
        return contour_loss(torch.softmax(pred, dim=1), target, num_classes=num_classes)
    raise NotImplementedError(f"loss_type {loss_type!r}")


def cosine_similarity_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """1 - mean cosine similarity of the [N,C,HW] rows of a and b [N,C,H,W]
    (custom_loss.calc_angular_loss:48-60)."""
    a, b = _f32(a), _f32(b)
    af = a.reshape(a.shape[0], a.shape[1], -1)
    bf = b.reshape(b.shape[0], b.shape[1], -1)
    num = torch.sum(af * bf, dim=-1)
    den = torch.linalg.vector_norm(af, dim=-1) * torch.linalg.vector_norm(bf, dim=-1) + 1e-8
    return mesh.share(torch.mean(1.0 - num / den))
