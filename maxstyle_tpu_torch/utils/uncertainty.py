"""Entropy-based uncertainty maps from logits.

Counterpart of ``maxstyle_tpu/utils/uncertainty.py``
(≙ common_utils/uncertainty.py:7-72), in torch, so the map is computed on
the logits' device.
"""

from __future__ import annotations

import math

import torch


def entropy_map(logits: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """logits [N,H,W,C] -> entropy [N,H,W]; normalized to [0,1] by log(C)."""
    p = torch.softmax(logits, dim=-1)
    log_p = torch.log_softmax(logits, dim=-1)
    ent = -torch.sum(p * log_p, dim=-1)
    if normalize:
        ent = ent / math.log(logits.shape[-1])
    return ent

