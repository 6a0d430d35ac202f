"""Segmentation and reconstruction losses of the ported path (NCHW).

Counterpart of the ported part of ``maxstyle_tpu/losses.py``, itself the
reference's custom_loss.py: cross entropy, the reconstruction losses, and
the KL, contour and consistency losses of the method branches. Logits are
[N,C,H,W], hard labels [N,H,W] integers. Losses are computed in float32.
The other loss types of the JAX package (dice, focal, soft-target cross
entropy, JS, NGF, the other consistency divergences and scales) are not
ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

_SOBEL_X = ((1.0, 0.0, -1.0), (2.0, 0.0, -2.0), (1.0, 0.0, -1.0))
_SOBEL_Y = ((1.0, 2.0, 1.0), (0.0, 0.0, 0.0), (-1.0, -2.0, -1.0))


@functools.lru_cache(maxsize=8)
def _sobel_kernels(device: torch.device) -> torch.Tensor:
    """The (x, y) Sobel filters [2,1,3,3] on ``device``, copied there once:
    a copy to the GPU in every call would wait for the device."""
    return torch.tensor((_SOBEL_X, _SOBEL_Y), dtype=torch.float32, device=device)[:, None]


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """[N,H,W] int -> [N,C,H,W] one-hot in the default float dtype."""
    return F.one_hot(labels.long(), num_classes).permute(0, 3, 1, 2).to(torch.get_default_dtype())


def _normalized_class_weights(weight: Sequence[float], num_classes: int,
                              device) -> torch.Tensor:
    """The reference normalizes class weights to sum to C."""
    w = torch.as_tensor(weight, dtype=torch.float32, device=device)
    return w / w.sum() * num_classes


def cross_entropy_2d(logits: torch.Tensor, target: torch.Tensor,
                     weight: Optional[Sequence[float]] = None,
                     size_average: bool = True) -> torch.Tensor:
    """Pixelwise cross entropy with hard labels; the denominator under
    ``size_average`` is N*H*W whatever the class weights
    (custom_loss.cross_entropy_2D:1043-1105)."""
    if target.dim() != 3:
        raise NotImplementedError(
            "only hard-label targets are ported; soft targets are queued")
    logits = logits.float()
    n, c, h, w = logits.shape
    log_p = F.log_softmax(logits, dim=1)
    tgt = target.long()
    nll = -torch.gather(log_p, 1, tgt[:, None])[:, 0]  # [N,H,W]
    if weight is not None:
        nll = nll * _normalized_class_weights(weight, c, logits.device)[tgt]
    loss = nll.sum()
    if size_average:
        loss = loss / float(n * h * w)
    return loss


def mse_recon_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """0.5 * mean squared error against a detached target."""
    return 0.5 * torch.mean((pred.float() - target.detach().float()) ** 2)


def l1_recon_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred.float() - target.detach().float()))


def image_recon_loss(pred: torch.Tensor, target: torch.Tensor,
                     rec_loss_type: str = "l2") -> torch.Tensor:
    if rec_loss_type == "l2":
        return mse_recon_loss(pred, target)
    if rec_loss_type == "l1":
        return l1_recon_loss(pred, target)
    raise NotImplementedError(f"rec_loss_type {rec_loss_type!r} is not ported yet")


def basic_loss_fn(pred: torch.Tensor, target: torch.Tensor,
                  loss_type: str = "cross entropy", class_weights=None) -> torch.Tensor:
    """Supervised-segmentation loss dispatch (custom_loss.basic_loss_fn:13-45).
    As in the JAX package, "cross entropy" ignores ``class_weights``."""
    if loss_type == "cross entropy":
        return cross_entropy_2d(pred, target)
    raise NotImplementedError(f"loss_type {loss_type!r} is not ported yet")


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
    probs = probs.float()
    if one_hot_target:
        if num_classes is None:
            raise ValueError("contour_loss: one_hot_target needs num_classes")
        tgt = one_hot(target, num_classes)
    else:
        tgt = target.float()
    if ignore_background:
        probs, tgt = probs[:, 1:], tgt[:, 1:]
    mask = torch.ones_like(probs) if mask is None else mask.expand_as(probs)
    gx_p, gy_p = _dense_sobel(probs)
    gx_t, gy_t = _dense_sobel(tgt.detach())
    loss = (torch.mean((gx_p * mask - gx_t * mask) ** 2)
            + torch.mean((gy_p * mask - gy_t * mask) ** 2))
    return 0.5 * loss


def kl_divergence(reference: torch.Tensor, pred: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DKL(P||Q) per pixel, averaged, with P = softmax(reference) and Q =
    softmax(pred), both logits [N,C,H,W] (custom_loss.kl_divergence
    :1200-1227)."""
    reference, pred = reference.float(), pred.float()
    mask = torch.ones_like(pred) if mask is None else mask
    log_p = F.log_softmax(reference, dim=1)
    p = torch.softmax(reference, dim=1)
    plogp = torch.sum(mask * (p * log_p), dim=1, keepdim=True)
    plogq = torch.sum(mask * (p * F.log_softmax(pred, dim=1)), dim=1, keepdim=True)
    return torch.mean(plogp - plogq)


def segmentation_consistency(output: torch.Tensor, reference: torch.Tensor,
                             divergence_types: Sequence[str] = ("kl", "contour"),
                             divergence_weights: Sequence[float] = (1.0, 0.5),
                             scales: Sequence[int] = (0,),
                             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted consistency between two logit maps [N,C,H,W]
    (custom_loss.calc_segmentation_consistency:1261-1341), at scale 0 with
    the "kl" and "contour" divergences, the ones the method branches use."""
    if tuple(scales) != (0,):
        raise NotImplementedError(f"consistency scales {tuple(scales)} are not ported yet")
    num_classes = reference.shape[1]
    mask = torch.ones_like(output) if mask is None else mask
    dist = 0.0
    for div_type, d_weight in zip(divergence_types, divergence_weights):
        if div_type == "kl":
            loss = kl_divergence(reference, output, mask=mask)
        elif div_type == "contour":
            tgt = torch.softmax(reference.float(), dim=1)
            inp = torch.softmax(output.float(), dim=1)
            loss = 0.0
            for i in range(1, num_classes):
                loss = loss + contour_loss(inp[:, i:i + 1], tgt[:, i:i + 1],
                                           ignore_background=False, one_hot_target=False,
                                           mask=mask[:, :1])
            if num_classes > 1:
                loss = loss / float(num_classes - 1)
        else:
            raise NotImplementedError(f"consistency divergence {div_type!r} is not ported yet")
        dist = dist + d_weight * loss
    return dist
