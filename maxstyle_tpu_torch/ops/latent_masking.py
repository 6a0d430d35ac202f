"""Gradient-based latent-code masking (LSM / RSC), NCHW.

Counterpart of ``maxstyle_tpu/ops/latent_masking.py``, itself the
reference's model_util.mask_latent_code_channel_wise (:240-312) and
mask_latent_code_spatial_wise (:315-374): a task loss of decoder(code)
against a target is differentiated with respect to the code, and the
channels or positions whose mean gradient lies above a percentile are
zeroed (hard) or shrunk by U[0, 0.5) (soft).

Nothing here waits for the device. The cut index k stays a tensor, and the
method chosen at random ('random': dropout, spatial or channel; 'RSC' and
'no_dropout': spatial or channel) is applied by selecting among every
candidate with ``torch.where`` on the drawn index: the channel and spatial
masks probe the same gradient, which is computed once.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from maxstyle_tpu_torch import losses
from maxstyle_tpu_torch.parallel import mesh

# the candidates that the random methods choose among, in the JAX package's
# switch order
METHODS = {"random": ("dropout", "spatial", "channel"),
           "RSC": ("spatial", "channel"), "no_dropout": ("spatial", "channel")}


# the draws with a row a sample (draw_masking)
_ROW_DRAWS = ("soft_channel", "soft_spatial", "keep")


def _mask_loss(pred: torch.Tensor, target: torch.Tensor, loss_type: str,
               num_classes: int) -> torch.Tensor:
    """Loss menu of the gradient probe (model_util.py:271-281)."""
    gt = losses.one_hot(target, num_classes) if target.dim() < pred.dim() else target
    if loss_type == "corr":
        return mesh.share(torch.mean(pred * gt))
    if loss_type == "l1":
        return mesh.share(torch.mean(torch.abs(pred - gt)))
    if loss_type in ("mse", "l2"):
        return mesh.share(torch.mean((pred - gt) ** 2))
    if loss_type == "ce":
        return losses.cross_entropy_2d(pred, target)
    raise NotImplementedError(loss_type)


def _grad_wrt_code(code: torch.Tensor, decode_fn: Callable, target: torch.Tensor,
                   loss_type: str, num_classes: int) -> torch.Tensor:
    """d loss / d code at a detached copy of the code. ``torch.autograd.grad``
    takes the gradient with respect to that leaf only, so no parameter's
    ``.grad`` is touched."""
    leaf = code.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = _mask_loss(decode_fn(leaf), target, loss_type, num_classes)
        (grad,) = torch.autograd.grad(loss, leaf)
    return grad


def _threshold_mask(score: torch.Tensor, k: torch.Tensor, soft_u: Optional[torch.Tensor]
                    ) -> torch.Tensor:
    """score [B,M] -> mask [B,M]: entries strictly above the descending-sorted
    score at index k (a tensor) are 0, or 0.5*soft_u when soft; the others 1."""
    order = torch.sort(score, dim=1, descending=True).values
    k = k.clamp(0, score.shape[1] - 1).long().reshape(1, 1).expand(score.shape[0], 1)
    above = score > torch.gather(order, 1, k)
    fill = torch.zeros_like(score) if soft_u is None else 0.5 * soft_u
    return torch.where(above, fill, torch.ones_like(score))


def _cut_index(n: int, percentile: float, random_threshold: bool,
               draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """floor(n * percentile * pct_u) with ``random_threshold`` (in float32,
    as the JAX package computes it), else floor(n * percentile)."""
    if random_threshold:
        return torch.floor(n * (percentile * draws["pct_u"]))
    return torch.full((), float(math.floor(n * percentile)), device=draws["pct_u"].device)


def channel_mask(grad: torch.Tensor, *, percentile: float, random_threshold: bool,
                 if_soft: bool, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The top-percentile-gradient channels' mask [B,C,1,1]."""
    b, c = grad.shape[:2]
    score = grad.mean(dim=(2, 3))
    k = _cut_index(c, percentile, random_threshold, draws)
    soft = draws["soft_channel"] if if_soft else None
    return _threshold_mask(score, k, soft).reshape(b, c, 1, 1)


def spatial_mask(grad: torch.Tensor, *, percentile: float, random_threshold: bool,
                 if_soft: bool, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The top-percentile-gradient positions' mask [B,1,H,W]."""
    b, _, h, w = grad.shape
    score = grad.mean(dim=1).reshape(b, h * w)
    k = _cut_index(h * w, percentile, random_threshold, draws)
    soft = draws["soft_spatial"] if if_soft else None
    return _threshold_mask(score, k, soft).reshape(b, 1, h, w)


def dropout2d_mask(code: torch.Tensor, rate: float, keep: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channel dropout (F.dropout2d, advanced_triplet…:610-614) with the
    boolean keep-mask ``keep`` [B,C,1,1]: (masked, keep broadcast to the
    code's shape as floats)."""
    keep = keep.to(code.dtype)
    return code * keep / (1.0 - rate), keep.expand_as(code)


def draw_masking(generator: torch.Generator, code_shape, perturb_type: str,
                 threshold: float) -> Dict[str, torch.Tensor]:
    """The random part of :func:`perturb_latent_code` for a code of
    ``code_shape`` [B,C,H,W]: the method index ``switch``, the percentile's
    uniform ``pct_u``, the soft masks' uniforms ``soft_channel`` [B,C] and
    ``soft_spatial`` [B,H*W], and dropout's boolean ``keep`` [B,C,1,1]."""
    b, c, h, w = code_shape
    dev = generator.device
    n = len(METHODS.get(perturb_type, (perturb_type,)))
    return {"switch": torch.randint(0, n, (), generator=generator, device=dev),
            "pct_u": torch.rand((), generator=generator, device=dev),
            "soft_channel": torch.rand((b, c), generator=generator, device=dev),
            "soft_spatial": torch.rand((b, h * w), generator=generator, device=dev),
            "keep": torch.rand((b, c, 1, 1), generator=generator, device=dev) < 1.0 - threshold}


def perturb_latent_code(code: torch.Tensor, decode_fn: Callable, target: torch.Tensor, *,
                        num_classes: int, draws: Dict[str, torch.Tensor],
                        perturb_type: str = "random", threshold: float = 0.5,
                        if_soft: bool = False, random_threshold: bool = False,
                        loss_type: str = "mse", if_detach: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask ``code`` [B,C,H,W] by ``perturb_type`` (advanced_triplet…
    perturb_latent_code:573-629): "dropout", "channel", "spatial", or one of
    them chosen by ``draws["switch"]`` ("random", "RSC", "no_dropout").
    ``threshold`` is the percentile, and dropout's rate. Returns (masked
    code, mask of the code's shape); the mask carries no gradient, and the
    masked code none either with ``if_detach``. In a data group ``draws``
    are those of the global batch (``draw_masking`` at its shape)."""
    if perturb_type in METHODS:
        methods = METHODS[perturb_type]
    elif perturb_type in ("dropout", "channel", "spatial"):
        methods = (perturb_type,)
    else:
        raise ValueError(perturb_type)
    base = code.detach() if if_detach else code
    # the draws of the global batch: this rank's rows
    draws = {k: mesh.local_rows(v) if k in _ROW_DRAWS else v for k, v in draws.items()}
    kw = dict(percentile=threshold, random_threshold=random_threshold, if_soft=if_soft,
              draws=draws)
    grad = None
    if "channel" in methods or "spatial" in methods:
        grad = _grad_wrt_code(code, decode_fn, target, loss_type, num_classes)
    candidates = []
    for method in methods:
        if method == "dropout":
            masked, mask = dropout2d_mask(base, threshold, draws["keep"])
        else:
            fn = channel_mask if method == "channel" else spatial_mask
            mask = fn(grad, **kw)
            # in the code's dtype, as the JAX package casts every method's
            # result (a soft mask is float32)
            masked, mask = (base * mask).to(code.dtype), mask.to(code.dtype).expand_as(code)
        candidates.append((masked, mask))
    masked, mask = candidates[-1]
    switch = draws["switch"] if len(methods) > 1 else None
    for i in range(len(candidates) - 2, -1, -1):
        hit = switch == i
        masked = torch.where(hit, candidates[i][0], masked)
        mask = torch.where(hit, candidates[i][1], mask)
    return masked, mask
