"""Segmentation and reconstruction losses of the ported path (NCHW).

Counterpart of the main-path part of ``maxstyle_tpu/losses.py``, itself the
reference's custom_loss.py. Logits are [N,C,H,W], hard labels [N,H,W]
integers. Losses are computed in float32. The other loss types of the JAX
package (dice, focal, contour, the divergence family, NGF) are not ported
yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """[N,H,W] int -> [N,C,H,W] float one-hot."""
    return F.one_hot(labels.long(), num_classes).permute(0, 3, 1, 2).float()


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
