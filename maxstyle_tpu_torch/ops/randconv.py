"""RandConv pixel-space augmentation (ICLR'21), NCHW.

Counterpart of ``maxstyle_tpu/ops/randconv.py`` (the reference's
rand_conv_aug.py:13-48). The kernel size k in {1, 3, 5, 7} is drawn a call;
as in the JAX package, the weights are drawn at the largest size and the
ring outside the k x k centre is zeroed, so one 7x7 convolution covers all
four sizes and k stays a tensor (no wait for the device).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

KERNEL_CANDIDATES: Tuple[int, ...] = (1, 3, 5, 7)
_KMAX = max(KERNEL_CANDIDATES)


def draw_rand_conv(generator: torch.Generator, channels: int) -> Dict[str, torch.Tensor]:
    """The random part of one RandConv call: the kernel size ``k`` (int64,
    one of KERNEL_CANDIDATES), standard normal weights ``w`` [C,C,7,7] and
    the mix weight ``alpha`` ~ U[0, 1)."""
    dev = generator.device
    idx = torch.randint(0, len(KERNEL_CANDIDATES), (), generator=generator, device=dev)
    return {"k": 2 * idx + 1,  # KERNEL_CANDIDATES[idx], computed on the device
            "w": torch.randn((channels, channels, _KMAX, _KMAX), generator=generator,
                             device=dev),
            "alpha": torch.rand((), generator=generator, device=dev)}


def rand_conv_augment(image: torch.Tensor, draws: Optional[Dict[str, torch.Tensor]] = None,
                      fixed=None) -> torch.Tensor:
    """One RandConv transform of ``image`` [N,C,H,W]: weights
    N(0, 1/(C k^2)) masked to the k x k centre, a same-padded convolution,
    and the blend alpha*image + (1-alpha)*conv (rand_conv_aug.py:19-48; the
    transform always applies). The result is detached.

    ``fixed=(k, weights [k,k,C,C] as the JAX package lays them out, alpha)``
    injects a static kernel in place of ``draws``."""
    c = image.shape[1]
    dev = image.device
    if fixed is not None:
        k_static, w_small, alpha = fixed
        pad = (_KMAX - k_static) // 2
        w_small = torch.as_tensor(w_small, dtype=torch.float32).permute(3, 2, 0, 1)
        w_full = F.pad(w_small, (pad, pad, pad, pad)).to(dev)
        k = torch.full((), k_static, device=dev)
        alpha = torch.as_tensor(alpha, dtype=torch.float32).to(dev)
    else:
        k, alpha = draws["k"], draws["alpha"]
        w_full = draws["w"] * (1.0 / torch.sqrt(c * k.float() ** 2))
    r = torch.arange(_KMAX, device=dev)
    center = (_KMAX - 1) // 2
    half = torch.div(k - 1, 2, rounding_mode="floor")
    inside = (r - center).abs() <= half
    w = w_full * (inside[:, None] & inside[None, :])
    conv = F.conv2d(image, w, padding=_KMAX // 2)
    return (alpha * image + (1.0 - alpha) * conv).detach()
