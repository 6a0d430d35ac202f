"""Library losses beyond the main training path (NCHW).

Counterpart of ``maxstyle_tpu/losses_extra.py``, the rest of the
reference's custom_loss.py loss surface: Gram/style losses (:160-189),
contrastive and triplet losses (:130-159, 982-1021), Brier (:762-778),
(local) normalized cross-correlation (:835-979), 3D cross entropy
(:192-213), smooth L1 (:500-509), Laplacian smoothness (:511-543), the
hierarchical cardiac loss (:373-409), and the semi-supervised helpers of
model_util.py:399-422. The training loop uses none of them. Losses compute
in float32, as those of ``losses.py``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from maxstyle_tpu_torch import losses
from maxstyle_tpu_torch.losses import _f32


def gram_matrix_2d(feat: torch.Tensor) -> torch.Tensor:
    """[N,C,H,W] -> [N,C,C] Gram matrix over h*w*c (custom_loss.gram_matrix_2D)."""
    feat = _f32(feat)
    n, c, h, w = feat.shape
    f = feat.reshape(n, c, h * w)
    return torch.einsum("ncp,ndp->ncd", f, f) / float(h * w * c)


def style_loss(feat_a: torch.Tensor, feat_b: torch.Tensor) -> torch.Tensor:
    """MSE between Gram matrices (custom_loss.style_loss)."""
    return torch.mean((gram_matrix_2d(feat_a) - gram_matrix_2d(feat_b)) ** 2)


def contrastive_loss(a: torch.Tensor, b: torch.Tensor, label: torch.Tensor,
                     margin: float = 1.0) -> torch.Tensor:
    """Pairwise contrastive loss (custom_loss.ContrastiveLoss:142-159);
    label 1 marks a similar pair."""
    a, b, label = _f32(a), _f32(b), _f32(label)
    d = torch.linalg.vector_norm((a - b).reshape(a.shape[0], -1), dim=1)
    return torch.mean(label * d ** 2 + (1 - label) * torch.clamp(margin - d, min=0.0) ** 2)


def triplet_loss(anchor: torch.Tensor, positive: torch.Tensor, negative: torch.Tensor,
                 margin: float = 1.0) -> torch.Tensor:
    """Angular-distance triplet loss (custom_loss.calc_triplet_loss:130-141)."""
    d_pos = losses.cosine_similarity_loss(anchor, positive)
    d_neg = losses.cosine_similarity_loss(anchor, negative)
    return torch.clamp(d_pos - d_neg + margin, min=0.0)


def brier_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Squared error between softmax probabilities and one-hot labels,
    summed and divided by batch * classes only, not by the pixel count, as
    the reference does (custom_loss.CustomBrierLoss:762-778)."""
    logits = _f32(logits)
    b, c = logits.shape[:2]
    p = torch.softmax(logits, dim=1)
    y = losses.one_hot(labels, c).float()
    return torch.sum((p - y) ** 2) / (float(b) * float(c))


def ncc_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 - NCC (custom_loss.CustomNormalizedCrossCorrelationLoss:835-889)."""
    return 1.0 - losses.normalized_cross_correlation(_f32(pred), _f32(target).detach())


def _box_sum(x: torch.Tensor, window: int) -> torch.Tensor:
    """Sum over window x window neighbourhoods of each plane of x [N,C,H,W],
    stride 1, zero "SAME" padding (the smaller half before)."""
    lo = (window - 1) // 2
    hi = window - 1 - lo
    ones = torch.ones((x.shape[1], 1, window, window), dtype=x.dtype, device=x.device)
    return F.conv2d(F.pad(x, (lo, hi, lo, hi)), ones, groups=x.shape[1])


def local_ncc_loss(pred: torch.Tensor, target: torch.Tensor, window: int = 9) -> torch.Tensor:
    """1 - the mean local NCC over sliding windows
    (custom_loss.CustomLocalNormalizedCrossCorrelationLoss:892-979)."""
    pred, target = _f32(pred), _f32(target).detach()
    n_win = float(window * window)
    s_p, s_t = _box_sum(pred, window), _box_sum(target, window)
    s_pp, s_tt = _box_sum(pred * pred, window), _box_sum(target * target, window)
    s_pt = _box_sum(pred * target, window)
    cross = s_pt - s_p * s_t / n_win
    var_p = s_pp - s_p * s_p / n_win
    var_t = s_tt - s_t * s_t / n_win
    return 1.0 - torch.mean((cross * cross) / (var_p * var_t + 1e-5))


def cross_entropy_3d(logits: torch.Tensor, labels: torch.Tensor, weight=None,
                     size_average: bool = True) -> torch.Tensor:
    """3D cross entropy of logits [N,C,S,H,W] against labels [N,S,H,W]
    (custom_loss.cross_entropy_3D:192-213); class weights as given, not
    normalized."""
    logits = _f32(logits)
    tgt = labels.long()
    nll = -torch.gather(F.log_softmax(logits, dim=1), 1, tgt[:, None])[:, 0]
    if weight is not None:
        nll = nll * torch.as_tensor(weight, dtype=nll.dtype, device=nll.device)[tgt]
    loss = torch.sum(nll)
    return loss / labels.numel() if size_average else loss


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   beta: float = 1.0 / 9) -> torch.Tensor:
    """Huber / smooth L1 with the reference's default beta 1/9
    (custom_loss.smooth_l1_loss:500-509)."""
    d = torch.abs(_f32(pred) - _f32(target))
    return torch.mean(torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta))


def laplacian_smoothness_loss(x: torch.Tensor) -> torch.Tensor:
    """Mean |Laplacian| of a field [N,C,H,W] over its interior
    (custom_loss.laplacian_smoothness_loss:511-543)."""
    x = _f32(x)
    lap = (-4.0 * x + torch.roll(x, 1, dims=2) + torch.roll(x, -1, dims=2)
           + torch.roll(x, 1, dims=3) + torch.roll(x, -1, dims=3))
    return torch.mean(torch.abs(lap[:, :, 1:-1, 1:-1]))


def hierarchical_loss(multi_logits: Sequence[torch.Tensor], labels: torch.Tensor,
                      weights: Sequence[float] = (1.0, 1.0, 1.0)) -> torch.Tensor:
    """Three-level cardiac hierarchy (custom_loss.get_hierachical_loss
    :373-409): foreground against background, LV+MYO against RV, and the
    four classes with the paper's weights [0.2, 0.25, 0.3, 0.25]."""
    l0 = losses.cross_entropy_2d(multi_logits[0], torch.where(labels > 1, 0, labels))
    l1 = losses.cross_entropy_2d(multi_logits[1], torch.where(labels <= 2, 1, 2))
    l2 = losses.cross_entropy_2d(multi_logits[2], labels, weight=(0.2, 0.25, 0.3, 0.25))
    return weights[0] * l0 + weights[1] * l1 + weights[2] * l2


# ---------------------------------------------------------------------------
# semi-supervised helpers (model_util.py:399-422)
# ---------------------------------------------------------------------------


def filter_unlabelled_predictions(probs: torch.Tensor, threshold: float = 0.8) -> torch.Tensor:
    """1 at the pixels whose largest probability exceeds ``threshold``, over
    every class channel of probs [N,C,H,W], detached
    (model_util.filter_unlabelled_predictions:399-412)."""
    probs = probs.detach()
    conf = probs.amax(dim=1, keepdim=True) > threshold
    return conf.to(probs.dtype).expand_as(probs)


def sharpen_predictions(logits: torch.Tensor, temperature: float = 0.5) -> torch.Tensor:
    """Temperature sharpening of softmax predictions over the class axis
    (model_util.sharpen_predictions:415-422)."""
    p = torch.softmax(logits, dim=1) ** (1.0 / temperature)
    return p / torch.sum(p, dim=1, keepdim=True)
