"""The augmentation warps on the CUDA kernels of ``csrc/warp.cu`` and
``csrc/warp_cubic.cu``.

Counterpart of ``maxstyle_tpu/ops/warp_pallas.py``:

* :func:`warp_bilinear_nearest` (its ``_warp_kernel``, ``warp_pallas.py:46``):
  for each output pixel, a 4-tap bilinear image sample and a nearest label
  sample at float source coordinates, with clipped indices and zero fill
  outside;
* :func:`warp_cubic_nearest` (its ``_warp_cubic_kernel``, ``:184``): the
  spline prefilter (``ops/spline.spline_filter2d_matrix``), then a 16-tap
  cubic B-spline sample of the coefficients with mirrored taps
  (:func:`sample_cubic_nearest`, the kernel) and the same nearest label.

Labels round half up, a documented difference from the gather path of
``data/augment.py``, whose ``round`` rounds half to even. Both kernels are
bound by device-memory bytes; their source notes say how they meet that
bound.

Each wrapper takes its plain version for tensors on the CPU only; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from maxstyle_tpu_torch import kernels
from maxstyle_tpu_torch.ops.spline import floor_index, sample_cubic, spline_filter2d_matrix


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

    def at(src, yi, xi):
        return torch.gather(src, 1, (yi * ws + xi).reshape(n, -1)).reshape(yi.shape)

    uy = 1.0 - wy
    ux = 1.0 - wx
    r0 = uy * at(flat, y0, x0) + wy * at(flat, y1, x0)
    r1 = uy * at(flat, y0, x1) + wy * at(flat, y1, x1)
    val = r0 * ux + r1 * wx
    inside_b = (sy >= 0) & (sy <= hs - 1) & (sx >= 0) & (sx <= ws - 1)
    img = torch.where(inside_b, val, torch.zeros_like(val))

    return img, nearest_half_up_plain(labels, sy, sx)


def warp_bilinear_nearest(images: torch.Tensor, labels: torch.Tensor,
                          sy: torch.Tensor, sx: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched fused warp; same contract as the plain version."""
    if all(t.device.type == "cpu" for t in (images, labels, sy, sx)):
        return warp_bilinear_nearest_plain(images, labels, sy, sx)
    _check_warp_args("warp_bilinear_nearest", images, labels, sy, sx)
    n, hs, ws = images.shape
    h, w = sy.shape[1:]
    out_img = torch.empty((n, h, w), device=images.device, dtype=torch.float32)
    out_lab = torch.empty((n, h, w), device=images.device, dtype=torch.int32)
    kernels.launch("warp_bilinear_nearest", images, labels, sy, sx, out_img, out_lab,
                   n, hs, ws, h, w)
    kernels.LAUNCHES["warp_bilinear_nearest"] += 1
    return out_img, out_lab


def _check_warp_args(name: str, images, labels, sy, sx) -> None:
    kernels.check_cuda_f32(name, images, sy, sx)
    if labels.device != images.device or labels.dtype != torch.int32 \
            or not labels.is_contiguous():
        raise TypeError(f"{name}: labels must be contiguous int32 on the images' device")
    if labels.shape != images.shape or sy.shape != sx.shape or sy.shape[0] != images.shape[0]:
        raise ValueError(f"{name}: shape mismatch")


def nearest_half_up_plain(labels: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor
                          ) -> torch.Tensor:
    """labels [N,H,W] int at [N,h,w] -> int32, index clip(floor + (frac >=
    0.5)), zero outside [-0.5, H-0.5] x [-0.5, W-0.5]."""
    n, hs, ws = labels.shape
    yn = (floor_index(sy, hs) + (sy - torch.floor(sy) >= 0.5).long()).clamp(0, hs - 1)
    xn = (floor_index(sx, ws) + (sx - torch.floor(sx) >= 0.5).long()).clamp(0, ws - 1)
    val = torch.gather(labels.reshape(n, hs * ws), 1, (yn * ws + xn).reshape(n, -1))
    val = val.reshape(sy.shape)
    inside = (sy >= -0.5) & (sy <= hs - 0.5) & (sx >= -0.5) & (sx <= ws - 0.5)
    return torch.where(inside, val, torch.zeros_like(val)).to(torch.int32)


def sample_cubic_nearest_plain(coeffs: torch.Tensor, labels: torch.Tensor,
                               sy: torch.Tensor, sx: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """coeffs [N,H,W] f32 spline coefficients, labels [N,H,W] int, sy/sx
    [N,h,w] f32 -> ([N,h,w] f32, [N,h,w] int32). The order of the float
    operations is the CUDA kernel's, so the two agree exactly on the same
    device."""
    return sample_cubic(coeffs, sy, sx), nearest_half_up_plain(labels, sy, sx)


def sample_cubic_nearest(coeffs: torch.Tensor, labels: torch.Tensor,
                         sy: torch.Tensor, sx: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cubic warp kernel on prefiltered coefficients; same contract as
    :func:`sample_cubic_nearest_plain`."""
    if all(t.device.type == "cpu" for t in (coeffs, labels, sy, sx)):
        return sample_cubic_nearest_plain(coeffs, labels, sy, sx)
    _check_warp_args("warp_cubic_nearest", coeffs, labels, sy, sx)
    n, hs, ws = coeffs.shape
    h, w = sy.shape[1:]
    out_img = torch.empty((n, h, w), device=coeffs.device, dtype=torch.float32)
    out_lab = torch.empty((n, h, w), device=coeffs.device, dtype=torch.int32)
    kernels.launch("warp_cubic_nearest", coeffs, labels, sy, sx, out_img, out_lab,
                   n, hs, ws, h, w)
    kernels.LAUNCHES["warp_cubic_nearest"] += 1
    return out_img, out_lab


def warp_cubic_nearest_plain(images: torch.Tensor, labels: torch.Tensor,
                             sy: torch.Tensor, sx: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """images [N,H,W] f32 -> the cubic image warp and the nearest label warp
    ([N,h,w] f32, [N,h,w] int32): prefilter, then the plain sampler."""
    return sample_cubic_nearest_plain(spline_filter2d_matrix(images), labels, sy, sx)


def warp_cubic_nearest(images: torch.Tensor, labels: torch.Tensor,
                       sy: torch.Tensor, sx: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched fused cubic warp; same contract as the plain version. The
    prefilter is two matrix products; the sampler is the kernel."""
    return sample_cubic_nearest(spline_filter2d_matrix(images), labels, sy, sx)
