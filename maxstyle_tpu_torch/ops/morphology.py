"""Grayscale morphology on the device (NCHW).

Counterpart of ``maxstyle_tpu/ops/morphology.py`` (the reference's
common_utils/morphology.py:8-107 Dilation2d/Erosion2d): a square
structuring element as a stride-1 max pool whose padding counts as -inf,
and erosion as the dilation of the negated input.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dilation2d(x: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
    """Grayscale dilation with a square structuring element; [N,C,H,W]."""
    return F.max_pool2d(x, kernel_size, stride=1, padding=kernel_size // 2)


def erosion2d(x: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
    return -dilation2d(-x, kernel_size)


def morphological_gradient(x: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
    """Boundary extraction: dilation - erosion."""
    return dilation2d(x, kernel_size) - erosion2d(x, kernel_size)
