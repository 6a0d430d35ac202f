"""The augmentation warps on the CUDA kernels of ``csrc/warp.cu`` and
``csrc/warp_cubic.cu``.

Counterpart of ``maxstyle_tpu/ops/warp_pallas.py``:

* :func:`warp_bilinear_nearest` (its ``_warp_kernel``, ``warp_pallas.py:46``):
  for each output pixel, a 4-tap bilinear image sample and a nearest label
  sample at float source coordinates, with clipped indices and zero fill
  outside; :func:`warp_bilinear_nearest_affine` is the same kernel with
  the coordinates composed inside it (:func:`compose_coords`: the inverse
  affine of the crop grid plus the gated elastic field), the augmentation's
  route;
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

from typing import Optional, Tuple

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


def compose_coords(mat: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                   src_hw: Tuple[int, int], out_hw: Tuple[int, int],
                   sm: Optional[torch.Tensor] = None, alpha: Optional[torch.Tensor] = None,
                   gate: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Source coordinates [n,h,w] of the crop grid (offsets oy, ox [n])
    under the inverse affine ``mat`` [n,2,3] about the source's centre,
    plus, when ``sm`` is given, the crop window of the smoothed field
    sm [n,2,H,W] times alpha [n] times the gate [n]. The order of the float
    operations is the CUDA kernel's (``csrc/warp.cu``)."""
    H, W = src_hw
    h, w = out_hw
    dev = mat.device
    ty = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None] + oy[:, None, None]
    tx = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :] + ox[:, None, None]
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    ty_c, tx_c = ty - cy, tx - cx
    m = mat[:, :, :, None, None]
    sy = m[:, 0, 0] * ty_c + m[:, 0, 1] * tx_c + m[:, 0, 2] + cy
    sx = m[:, 1, 0] * ty_c + m[:, 1, 1] * tx_c + m[:, 1, 2] + cx
    if sm is not None:
        rows = (oy[:, None] + torch.arange(h, device=dev))[:, :, None]
        cols = (ox[:, None] + torch.arange(w, device=dev))[:, None, :]
        idx = torch.arange(mat.shape[0], device=dev)[:, None, None]
        a, g = alpha[:, None, None], gate[:, None, None]
        sy = sy + sm[idx, 0, rows, cols] * a * g
        sx = sx + sm[idx, 1, rows, cols] * a * g
    return sy, sx


def warp_bilinear_nearest_affine_plain(images: torch.Tensor, labels: torch.Tensor,
                                       mat: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                                       out_hw: Tuple[int, int],
                                       sm: Optional[torch.Tensor] = None,
                                       alpha: Optional[torch.Tensor] = None,
                                       gate: Optional[torch.Tensor] = None
                                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`compose_coords`, then :func:`warp_bilinear_nearest_plain`.
    Raises ValueError unless the crop window lies inside the source, where
    the offsets are on the CPU (elsewhere the check would wait on the
    device)."""
    (hs, ws), (h, w) = images.shape[1:], out_hw
    if oy.device.type == "cpu" and ox.device.type == "cpu" and bool(
            ((oy < 0) | (oy > hs - h) | (ox < 0) | (ox > ws - w)).any()):
        raise ValueError("warp_bilinear_nearest_affine: the crop window leaves the source")
    sy, sx = compose_coords(mat, oy, ox, tuple(images.shape[1:]), out_hw, sm, alpha, gate)
    return warp_bilinear_nearest_plain(images, labels, sy, sx)


def warp_bilinear_nearest_affine(images: torch.Tensor, labels: torch.Tensor,
                                 mat: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                                 out_hw: Tuple[int, int], sm: Optional[torch.Tensor] = None,
                                 alpha: Optional[torch.Tensor] = None,
                                 gate: Optional[torch.Tensor] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The warp with its coordinates composed in the kernel; same contract
    as :func:`warp_bilinear_nearest_affine_plain`. The crop window must lie
    inside the source (0 <= oy <= H - h, 0 <= ox <= W - w), as the
    augmentation's draws make it; the kernel clamps its field window to the
    source rather than read outside it. Counts as a
    ``warp_bilinear_nearest`` launch."""
    given = [t for t in (images, labels, mat, oy, ox, sm, alpha, gate) if t is not None]
    if all(t.device.type == "cpu" for t in given):
        return warp_bilinear_nearest_affine_plain(images, labels, mat, oy, ox, out_hw, sm,
                                                  alpha, gate)
    name = "warp_bilinear_nearest_affine"
    n, hs, ws = images.shape
    h, w = out_hw
    field = (sm, alpha, gate) if sm is not None else ()
    kernels.check_cuda_f32(name, images, mat, *field)
    oy, ox = oy.long().contiguous(), ox.long().contiguous()
    if labels.device != images.device or labels.dtype != torch.int32 \
            or not labels.is_contiguous():
        raise TypeError(f"{name}: labels must be contiguous int32 on the images' device")
    if oy.device != images.device or ox.device != images.device:
        raise ValueError(f"{name}: the crop offsets must be on the images' device")
    if labels.shape != images.shape or mat.shape != (n, 2, 3) or oy.shape != (n,) \
            or ox.shape != (n,) or h > hs or w > ws:
        raise ValueError(f"{name}: shape mismatch")
    if field and (sm.shape != (n, 2, hs, ws) or alpha.shape != (n,) or gate.shape != (n,)):
        raise ValueError(f"{name}: field shape mismatch")
    out_img = torch.empty((n, h, w), device=images.device, dtype=torch.float32)
    out_lab = torch.empty((n, h, w), device=images.device, dtype=torch.int32)
    kernels.launch(name, images, labels, mat, oy, ox, sm, alpha, gate, out_img, out_lab,
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
