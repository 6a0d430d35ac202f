"""Per-sample intensity normalisation ops (NCHW).

Counterpart of ``maxstyle_tpu/ops/intensity.py``: the reference's batch
intensity helpers (common_utils/basic_operations.py:257-311) and the
instance norm used as the image decoder's ``z_score`` head. Reductions run
over the spatial axes of each (sample, channel) plane.
"""

from __future__ import annotations

import torch


def rescale_intensity(x: torch.Tensor, new_min: float = 0.0, new_max: float = 1.0,
                      eps: float = 1e-20) -> torch.Tensor:
    """Min-max rescale each (sample, channel) plane of x [N,C,H,W] to
    [new_min, new_max]."""
    old_min = x.amin(dim=(2, 3), keepdim=True)
    old_max = x.amax(dim=(2, 3), keepdim=True)
    return (x - old_min) / (old_max - old_min + eps) * (new_max - new_min) + new_min


def z_score_intensity(x: torch.Tensor) -> torch.Tensor:
    """Zero mean, unit std (Bessel-corrected) per plane; std <= 0 counts as 1."""
    n = x.shape[2] * x.shape[3]
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False) * (n / max(n - 1, 1))
    std = torch.sqrt(var)
    std = torch.where(std <= 0, torch.ones_like(std), std)
    return (x - mean) / std


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """F.instance_norm without affine: biased variance, eps inside the sqrt."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = xf.var(dim=(2, 3), keepdim=True, unbiased=False)
    return ((xf - mean) / torch.sqrt(var + eps)).to(x.dtype)


def intensity_norm_fn(intensity_norm_type: str):
    if intensity_norm_type == "min_max":
        return rescale_intensity
    if intensity_norm_type == "z_score":
        return z_score_intensity
    raise ValueError(f"unknown intensity_norm_type: {intensity_norm_type}")
