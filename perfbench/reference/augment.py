"""The augmentation of a training batch in plain PyTorch, from given draws.

The policy is the configuration's ``augmentation`` block (the parameters
of ACDC_affine_elastic_intensity); the draws are the benchmark's, the same
dictionary the program receives as ``overrides["aug_draws"]``. One inverse
warp per sample: the crop grid, centred on the padded slice, mapped by the
inverse of rotation (with a multiple of 45 degrees), shear, zoom, shift and
flips, plus a Gaussian-smoothed uniform displacement field scaled by alpha
when the sample's elastic gate is on. The image is sampled bilinearly with
zero fill outside the slice, the label by the nearest pixel (halves round
up, zero outside). Then contrast and brightness where the intensity gate
is on, and a min-max of each slice to [0, 1].
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def inverse_affine(d: Dict[str, torch.Tensor], pol: dict, pad_hw) -> torch.Tensor:
    """[n,2,3]: the inverse of the forward map (zoom, rotation, shear,
    flips) with the shift, in centred source coordinates."""
    rad = math.pi / 180.0
    theta = d["theta_deg"] * rad
    groups = pol.get("rotate_groups") or []
    if groups:
        g = torch.tensor(groups, dtype=theta.dtype, device=theta.device)
        theta = theta + g[d["group"]] * rad
    shear = d["shear_deg"] * rad
    one = torch.ones_like(theta)
    fh = torch.where(d["flip_h_u"] < pol["flip_p"], -one, one) if pol["flip_h"] else one
    fv = torch.where(d["flip_v_u"] < pol["flip_p"], -one, one) if pol["flip_v"] else one
    a = d["zy"] * torch.cos(theta) * fv
    b = -d["zy"] * (torch.sin(theta) + shear) * fh
    c = d["zx"] * (torch.sin(theta) + shear) * fv
    e = d["zx"] * torch.cos(theta) * fh
    det = a * e - b * c
    inv = torch.stack([e, -b, -c, a], -1) / det[:, None]
    ty, tx = d["ty"] * pad_hw[0], d["tx"] * pad_hw[1]
    t0 = -(inv[:, 0] * ty + inv[:, 1] * tx)
    t1 = -(inv[:, 2] * ty + inv[:, 3] * tx)
    return torch.stack([inv[:, 0], inv[:, 1], t0, inv[:, 2], inv[:, 3], t1], -1).reshape(-1, 2, 3)


def gaussian_smooth(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Fields [n,2,H,W] smoothed by a periodic Gaussian of each sample's
    sigma [n] (the transfer function exp(-2 pi^2 sigma^2 f^2))."""
    h, w = x.shape[-2:]
    fy = torch.fft.fftfreq(h, device=x.device, dtype=x.dtype)[:, None]
    fx = torch.fft.rfftfreq(w, device=x.device, dtype=x.dtype)[None, :]
    s = sigma[:, None, None, None]
    tf = torch.exp(-2.0 * math.pi ** 2 * s ** 2 * (fy ** 2 + fx ** 2))
    return torch.fft.irfft2(torch.fft.rfft2(x) * tf, s=(h, w))


def source_coords(d, pol, pad_hw, crop_hw) -> Tuple[torch.Tensor, torch.Tensor]:
    H, W = pad_hw
    h, w = crop_hw
    n = d["oy"].shape[0]
    dev = d["theta_deg"].device
    m = inverse_affine(d, pol, pad_hw)
    ty = (torch.arange(h, device=dev)[None, :, None] + d["oy"][:, None, None]).float()
    tx = (torch.arange(w, device=dev)[None, None, :] + d["ox"][:, None, None]).float()
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    ty, tx = ty - cy, tx - cx
    mm = m[:, :, :, None, None]
    sy = mm[:, 0, 0] * ty + mm[:, 0, 1] * tx + mm[:, 0, 2] + cy
    sx = mm[:, 1, 0] * ty + mm[:, 1, 1] * tx + mm[:, 1, 2] + cx
    if pol["elastic_prob"] > 0:
        field = gaussian_smooth(d["elastic_noise"], d["sigma"])
        gate = (d["elastic_u"] < pol["elastic_prob"]).float()
        scale = (d["alpha"] * gate)[:, None, None]
        rows = (d["oy"][:, None] + torch.arange(h, device=dev))[:, :, None]
        cols = (d["ox"][:, None] + torch.arange(w, device=dev))[:, None, :]
        idx = torch.arange(n, device=dev)[:, None, None]
        sy = sy + field[idx, 0, rows, cols] * scale
        sx = sx + field[idx, 1, rows, cols] * scale
    return sy, sx


def _gather(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    n, H, W = img.shape
    flat = img.reshape(n, H * W)
    return torch.gather(flat, 1, (yi * W + xi).reshape(n, -1)).reshape(yi.shape)


def warp(images: torch.Tensor, labels: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor):
    n, H, W = images.shape
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = sy - y0, sx - x0
    y0i, x0i = y0.long().clamp(0, H - 1), x0.long().clamp(0, W - 1)
    y1i, x1i = (y0.long() + 1).clamp(0, H - 1), (x0.long() + 1).clamp(0, W - 1)
    val = ((1 - wy) * (1 - wx) * _gather(images, y0i, x0i)
           + (1 - wy) * wx * _gather(images, y0i, x1i)
           + wy * (1 - wx) * _gather(images, y1i, x0i)
           + wy * wx * _gather(images, y1i, x1i))
    inside = (sy >= 0) & (sy <= H - 1) & (sx >= 0) & (sx <= W - 1)
    img = torch.where(inside, val, torch.zeros_like(val))
    yn = (y0.long() + (wy >= 0.5).long()).clamp(0, H - 1)
    xn = (x0.long() + (wx >= 0.5).long()).clamp(0, W - 1)
    lab = _gather(labels.long(), yn, xn)
    inside_n = (sy >= -0.5) & (sy <= H - 0.5) & (sx >= -0.5) & (sx <= W - 0.5)
    return img, torch.where(inside_n, lab, torch.zeros_like(lab))


def minmax(img: torch.Tensor) -> torch.Tensor:
    """Each slice [n,h,w] to [0, 1]."""
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    return torch.clamp((img - lo) / (hi - lo + 1e-20), 0.0, 1.0)


def augment(images, labels, d, pol, pad_hw, crop_hw):
    """Raw padded slices [n,H,W] -> (images [n,1,h,w], labels [n,h,w])."""
    sy, sx = source_coords(d, pol, pad_hw, crop_hw)
    img, lab = warp(images.float(), labels, sy, sx)
    if pol["intensity_prob"] > 0:
        on = (d["intensity_u"] < pol["intensity_prob"])[:, None, None]
        img = torch.where(on, d["contrast"][:, None, None] * img
                          + d["brightness"][:, None, None], img)
    if pol.get("gamma_prob", 0) > 0:
        on = (d["gamma_u"] < pol["gamma_prob"])[:, None, None]
        img = torch.where(on, minmax(img) ** d["gamma"][:, None, None], img)
    return minmax(img)[:, None], lab


def center_crop(images, labels, crop_hw):
    """The originals: the centre crop, min-max normalized."""
    H, W = images.shape[-2:]
    h, w = crop_hw
    oy, ox = (H - h) // 2, (W - w) // 2
    img = minmax(images[:, oy:oy + h, ox:ox + w].float())
    return img[:, None], labels[:, oy:oy + h, ox:ox + w].long()
