"""The augmentation warp on the CUDA kernel of ``csrc/warp.cu``.

Counterpart of ``maxstyle_tpu/ops/warp_pallas.py::warp_bilinear_nearest``
(its ``_warp_kernel``, ``warp_pallas.py:46``): for each output pixel, a
4-tap bilinear image sample and a nearest label sample at float source
coordinates, with clipped indices and zero fill outside. Labels round half
up, a documented difference from the gather path of ``data/augment.py``,
whose ``round`` rounds half to even. The kernel is bound by device-memory
bytes; its source note says how it meets that bound.

:func:`warp_bilinear_nearest` takes :func:`warp_bilinear_nearest_plain` for
tensors on the CPU only; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from maxstyle_tpu_torch import kernels


def warp_bilinear_nearest_plain(images: torch.Tensor, labels: torch.Tensor,
                                sy: torch.Tensor, sx: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """images [N,H,W] f32, labels [N,H,W] int, sy/sx [N,h,w] f32 ->
    ([N,h,w] f32, [N,h,w] int32). The order of the float operations is the
    CUDA kernel's, so the two agree exactly on the same device."""
    n, hs, ws = images.shape
    y0f = torch.floor(sy)
    x0f = torch.floor(sx)
    wy = sy - y0f
    wx = sx - x0f
    y0 = y0f.clamp(0, hs - 1).long()
    y1 = (y0f + 1.0).clamp(0, hs - 1).long()
    x0 = x0f.clamp(0, ws - 1).long()
    x1 = (x0f + 1.0).clamp(0, ws - 1).long()
    flat = images.reshape(n, hs * ws)
    lab = labels.reshape(n, hs * ws)

    def at(src, yi, xi):
        return torch.gather(src, 1, (yi * ws + xi).reshape(n, -1)).reshape(yi.shape)

    uy = 1.0 - wy
    ux = 1.0 - wx
    r0 = uy * at(flat, y0, x0) + wy * at(flat, y1, x0)
    r1 = uy * at(flat, y0, x1) + wy * at(flat, y1, x1)
    val = r0 * ux + r1 * wx
    inside_b = (sy >= 0) & (sy <= hs - 1) & (sx >= 0) & (sx <= ws - 1)
    img = torch.where(inside_b, val, torch.zeros_like(val))

    yn = torch.where(wy >= 0.5, y1, y0)
    xn = torch.where(wx >= 0.5, x1, x0)
    inside_n = (sy >= -0.5) & (sy <= hs - 0.5) & (sx >= -0.5) & (sx <= ws - 0.5)
    lab_val = at(lab, yn, xn)
    return img, torch.where(inside_n, lab_val, torch.zeros_like(lab_val)).to(torch.int32)


def warp_bilinear_nearest(images: torch.Tensor, labels: torch.Tensor,
                          sy: torch.Tensor, sx: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched fused warp; same contract as the plain version."""
    if all(t.device.type == "cpu" for t in (images, labels, sy, sx)):
        return warp_bilinear_nearest_plain(images, labels, sy, sx)
    kernels.check_cuda_f32("warp_bilinear_nearest", images, sy, sx)
    if labels.device != images.device or labels.dtype != torch.int32 \
            or not labels.is_contiguous():
        raise TypeError("warp_bilinear_nearest: labels must be contiguous int32 "
                        "on the images' device")
    n, hs, ws = images.shape
    if labels.shape != images.shape or sy.shape != sx.shape or sy.shape[0] != n:
        raise ValueError("warp_bilinear_nearest: shape mismatch")
    h, w = sy.shape[1:]
    out_img = torch.empty((n, h, w), device=images.device, dtype=torch.float32)
    out_lab = torch.empty((n, h, w), device=images.device, dtype=torch.int32)
    kernels.launch("warp_bilinear_nearest", images, labels, sy, sx, out_img, out_lab,
                   n, hs, ws, h, w)
    kernels.LAUNCHES["warp_bilinear_nearest"] += 1
    return out_img, out_lab
