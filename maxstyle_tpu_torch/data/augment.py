"""On-device batched data augmentation.

Counterpart of ``maxstyle_tpu/data/augment.py``. The whole geometric chain
(random affine, 45-degree group rotation, flips, random crop and a gated
elastic field) composes into one inverse warp per sample; the elastic field
is smoothed uniform noise, smoothed in Fourier space. Images are sampled
bilinearly, or by an order-3 B-spline with ``image_interp="cubic"``
(``ops/spline.py``); labels by nearest neighbour. After the warp come
brightness/contrast, the smooth bias field (V2), the multi-scale bias field
with noise (V1), gamma, and a per-slice min-max.

Random draws are split from the arithmetic: :func:`draw_aug` takes a
``torch.Generator`` and draws every number for a batch at once;
:func:`aug_coords` and :func:`post_warp_intensity` are deterministic in
those draws, so tests can feed them the numbers JAX drew. The coordinates
come in two parts: :func:`affine_matrix` and :func:`elastic_field` (the
FFT smoothing) stay torch ops, and ``ops/warp_kernels.compose_coords``
composes them, either as torch ops (:func:`aug_coords`) or inside the
bilinear warp kernel (``warp_bilinear_nearest_affine``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from maxstyle_tpu_torch.ops.spline import map_coordinates_cubic
from maxstyle_tpu_torch.ops.warp_kernels import (compose_coords, warp_bilinear_nearest_affine,
                                                 warp_cubic_nearest)

Draws = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AugPolicy:
    pad_hw: Tuple[int, int] = (224, 224)
    crop_hw: Tuple[int, int] = (192, 192)
    rotate_deg: float = 0.0
    shift_frac: Tuple[float, float] = (0.0, 0.0)
    shear_deg: float = 0.0
    zoom_range: Tuple[float, float] = (1.0, 1.0)
    flip_h: bool = False
    flip_v: bool = False
    flip_p: float = 0.0
    rotate_groups: Tuple[float, ...] = ()   # e.g. multiples of 45°
    elastic_prob: float = 0.0
    elastic_alpha_range: Tuple[float, float] = (1.5, 2.0)   # x H
    elastic_sigma_range: Tuple[float, float] = (0.075, 0.15)  # x H
    intensity_prob: float = 0.0
    contrast_range: Tuple[float, float] = (0.8, 1.2)
    brightness_range: Tuple[float, float] = (-0.1, 0.1)
    gamma_prob: float = 0.0
    gamma_range: Tuple[float, float] = (0.8, 1.2)
    bias_field_prob: float = 0.0
    bias_field_magnitude: float = 0.2
    noise_epsilon: float = 0.0
    perturb_v1_prob: float = 0.0
    perturb_v1_magnitude: float = 0.3
    perturb_v1_noise_eps: float = 0.01
    perturb_v1_control_points: Tuple[int, ...] = (2, 4, 8)
    perturb_v1_max_sigma: float = 16.0
    image_interp: str = "bilinear"

    def __post_init__(self):
        if self.image_interp not in ("bilinear", "cubic"):
            raise ValueError(
                f"image_interp must be 'bilinear' or 'cubic', got {self.image_interp!r}")


def no_aug(pad_hw, crop_hw) -> AugPolicy:
    return AugPolicy(pad_hw=tuple(pad_hw), crop_hw=tuple(crop_hw))


def get_policy(name: str, pad_hw=(224, 224), crop_hw=(192, 192),
               image_interp: str = "bilinear") -> AugPolicy:
    """Aug-policy registry (the reference's transform.py:15-42 and
    :113-215), the same table as the JAX package's."""
    base = no_aug(pad_hw, crop_hw)
    rep = dataclasses.replace
    acdc_affine = rep(base, flip_h=True, flip_v=True, flip_p=0.2, rotate_deg=15.0,
                      zoom_range=(0.8, 1.1), rotate_groups=tuple(45.0 * i for i in range(8)))
    table = {
        "no_aug": base,
        "affine": rep(base, shift_frac=(0.1, 0.1), rotate_deg=15.0, zoom_range=(0.9, 1.1)),
        "scale": rep(base, zoom_range=(0.8, 1.2)),
        "elastic": rep(base, elastic_prob=0.5),
        "gamma": rep(base, gamma_prob=0.5),
        "gamma_elastic": rep(base, gamma_prob=0.5, elastic_prob=0.5),
        "ACDC_affine": acdc_affine,
        "ACDC_affine_intensity": rep(acdc_affine, intensity_prob=0.5),
        "ACDC_affine_elastic": rep(acdc_affine, elastic_prob=0.5),
        "ACDC_affine_elastic_intensity": rep(acdc_affine, intensity_prob=0.5,
                                             elastic_prob=0.5),
        "ACDC_affine_elastic_bias": rep(acdc_affine, elastic_prob=0.5, bias_field_prob=0.5),
        "ACDC_affine_all": rep(acdc_affine, elastic_prob=0.5, intensity_prob=0.5,
                               bias_field_prob=0.5),
        "Prostate_affine_elastic_intensity": rep(
            base, flip_h=True, flip_v=True, flip_p=0.5, shift_frac=(0.1, 0.1),
            rotate_deg=15.0, zoom_range=(0.8, 1.2), intensity_prob=0.5, elastic_prob=0.5),
        "UKBB_affine_elastic_intensity_aug": rep(acdc_affine, intensity_prob=0.5,
                                                 elastic_prob=0.5),
        "gamma_scale": rep(base, gamma_prob=0.5, zoom_range=(0.8, 1.2)),
        "affine_elastic": rep(base, shift_frac=(0.1, 0.1), rotate_deg=15.0,
                              zoom_range=(0.9, 1.1), elastic_prob=0.5),
        "affine_gamma": rep(base, shift_frac=(0.1, 0.1), rotate_deg=15.0,
                            zoom_range=(0.9, 1.1), gamma_prob=0.5),
        "affine_gamma_elastic": rep(base, shift_frac=(0.1, 0.1), rotate_deg=15.0,
                                    zoom_range=(0.9, 1.1), gamma_prob=0.5,
                                    elastic_prob=0.5),
        "elastic_scale": rep(base, elastic_prob=0.5, zoom_range=(0.8, 1.2)),
        "elastic_v2": rep(base, elastic_prob=0.5),
        "ACDC_affine_perturb": rep(acdc_affine, perturb_v1_prob=0.5),
        "ACDC_affine_perturb_v2": rep(acdc_affine, bias_field_prob=0.5),
        "Atrial_basic": rep(base, flip_h=True, flip_v=True, flip_p=0.5,
                            shift_frac=(0.1, 0.1), rotate_deg=10.0, zoom_range=(0.7, 1.3)),
        "Atrial_perturb": rep(base, flip_h=True, flip_v=True, flip_p=0.5,
                              shift_frac=(0.1, 0.1), rotate_deg=10.0,
                              zoom_range=(0.7, 1.3), perturb_v1_prob=0.5),
    }
    if name not in table:
        raise KeyError(f"unknown aug policy {name}; have {sorted(table)}")
    if image_interp not in ("bilinear", "cubic"):
        raise ValueError(f"image_interp must be 'bilinear' or 'cubic', got {image_interp!r}")
    pol = table[name]
    if image_interp != "bilinear":
        pol = dataclasses.replace(pol, image_interp=image_interp)
    return pol


def bias_grid_hw(crop_hw: Tuple[int, int], control_spacing: int = 32) -> Tuple[int, int]:
    """Control-grid size of the V2 bias field: one point every
    ``control_spacing`` pixels, at least 2 a side."""
    return max(crop_hw[0] // control_spacing, 2), max(crop_hw[1] // control_spacing, 2)


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------


def draw_aug(generator: torch.Generator, policy: AugPolicy, n: int) -> Draws:
    """Every random number of a batch of ``n`` augmentations, on the
    generator's device: the affine's angles, zooms, shifts, group index and
    flip uniforms; the crop offset; the elastic gate uniform, alpha, sigma
    and noise field; the intensity gate uniform, contrast and brightness;
    the gamma gate uniform and exponent. Then, only for a branch whose
    probability is above 0 (so that other policies draw the same stream):
    the bias-field gate uniform and U(-1, 1) control grid, and the V1 gate
    uniform, one U(0, 1) control grid per scale and the N(0, 1) noise."""
    p = policy
    dev = generator.device
    H, W = p.pad_hw
    h, w = p.crop_hw

    def uni(lo, hi, shape=(n,)):
        return lo + (hi - lo) * torch.rand(shape, generator=generator, device=dev)

    def randint(hi):
        return torch.randint(0, hi, (n,), generator=generator, device=dev)

    d = {
        "theta_deg": uni(-p.rotate_deg, p.rotate_deg),
        "shear_deg": uni(-p.shear_deg, p.shear_deg),
        "zy": uni(*p.zoom_range), "zx": uni(*p.zoom_range),
        "ty": uni(-p.shift_frac[0], p.shift_frac[0]),
        "tx": uni(-p.shift_frac[1], p.shift_frac[1]),
        "group": randint(max(len(p.rotate_groups), 1)),
        "flip_h_u": uni(0.0, 1.0), "flip_v_u": uni(0.0, 1.0),
        "oy": randint(H - h + 1), "ox": randint(W - w + 1),
        "elastic_u": uni(0.0, 1.0),
        "alpha": H * uni(*p.elastic_alpha_range),
        "sigma": H * uni(*p.elastic_sigma_range),
        "elastic_noise": uni(-1.0, 1.0, (n, 2, H, W)),
        "intensity_u": uni(0.0, 1.0),
        "contrast": uni(*p.contrast_range), "brightness": uni(*p.brightness_range),
        "gamma_u": uni(0.0, 1.0), "gamma": uni(*p.gamma_range),
    }
    if p.bias_field_prob > 0:
        d["bias_u"] = uni(0.0, 1.0)
        d["bias_grid"] = uni(-1.0, 1.0, (n,) + bias_grid_hw(p.crop_hw))
    if p.perturb_v1_prob > 0:
        d["v1_u"] = uni(0.0, 1.0)
        for cp in p.perturb_v1_control_points:
            d[f"v1_grid{cp}"] = uni(0.0, 1.0, (n, cp, cp))
        if p.perturb_v1_noise_eps > 0:
            d["v1_noise"] = torch.randn((n, h, w), generator=generator, device=dev)
    return d


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def affine_matrix(d: Draws, p: AugPolicy) -> torch.Tensor:
    """Inverse (target -> source) [n,2,3] matrices composing rotation, shear,
    zoom, shift, flips and the 45° group rotation, in centred coordinates."""
    deg2rad = math.pi / 180.0
    theta = d["theta_deg"] * deg2rad
    shear = d["shear_deg"] * deg2rad
    zy, zx = d["zy"], d["zx"]
    if p.rotate_groups:
        groups = torch.tensor(p.rotate_groups, dtype=torch.float32, device=theta.device)
        theta = theta + groups[d["group"]] * deg2rad
    one = torch.ones_like(theta)
    fh = torch.where(d["flip_h_u"] < p.flip_p, -one, one) if p.flip_h else one
    fv = torch.where(d["flip_v_u"] < p.flip_p, -one, one) if p.flip_v else one
    cos, sin = torch.cos(theta), torch.sin(theta)
    f00 = zy * cos * fv
    f01 = -zy * (sin + shear) * fh
    f10 = zx * (sin + shear) * fv
    f11 = zx * cos * fh
    det = f00 * f11 - f01 * f10
    i00, i01, i10, i11 = f11 / det, -f01 / det, -f10 / det, f00 / det
    ty = d["ty"] * p.pad_hw[0]
    tx = d["tx"] * p.pad_hw[1]
    t0 = -(i00 * ty + i01 * tx)
    t1 = -(i10 * ty + i11 * tx)
    return torch.stack([torch.stack([i00, i01, t0], -1),
                        torch.stack([i10, i11, t1], -1)], -2)


def fft_gaussian_smooth(x: torch.Tensor, sigma) -> torch.Tensor:
    """Gaussian-smooth fields [..., H, W] in Fourier space: multiply by the
    Gaussian's transfer function exp(-2 pi^2 sigma^2 f^2). ``sigma`` is a
    float, or a tensor shaped like x's leading axes followed by (1, 1)."""
    h, w = x.shape[-2:]
    fy = torch.fft.fftfreq(h, device=x.device)[:, None]
    fx = torch.fft.rfftfreq(w, device=x.device)[None, :]
    transfer = torch.exp(-2.0 * (math.pi ** 2) * (sigma ** 2) * (fy ** 2 + fx ** 2))
    return torch.fft.irfft2(torch.fft.rfft2(x) * transfer, s=(h, w))


def elastic_field(d: Draws, p: AugPolicy) -> Tuple[torch.Tensor, ...]:
    """The elastic branch's inputs to :func:`compose_coords`: the noise
    [n,2,H,W] Gaussian-smoothed at each sample's own sigma, alpha [n] and
    the float gate [n]; empty when the policy has no elastic branch."""
    if p.elastic_prob <= 0:
        return ()
    sm = fft_gaussian_smooth(d["elastic_noise"], d["sigma"][:, None, None, None])
    return sm, d["alpha"], (d["elastic_u"] < p.elastic_prob).float()


def _fma32(a, b, c) -> np.ndarray:
    """float32 fused multiply-add: a * b + c rounded once (exact in float64
    for float32 inputs, then rounded)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] float32 bicubic resize weights as ``jax.image.resize``
    builds them: half-pixel centres, Keys' cubic kernel with a = -0.5, each
    output's weights renormalised over the taps inside the input, and zero
    for a sample outside [-0.5, n_in - 0.5]; upsampling, so nothing is
    antialiased. The arithmetic is float32 with the multiply-adds fused, as
    XLA compiles that function, so the weights are JAX's to the bit at the
    sizes the policies use."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    sample = _fma32(np.arange(n_out, dtype=f32) + f32(0.5), inv_scale, f32(-0.5))
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
    near = _fma32(_fma32(f32(1.5), x, f32(-2.5)) * x, x, f32(1.0))
    far = _fma32(_fma32(_fma32(f32(-0.5), x, f32(2.5)), x, f32(-4.0)), x, f32(2.0))
    wts = np.where(x >= 2.0, f32(0.0), np.where(x >= 1.0, far, near))
    total = wts.sum(axis=0, keepdims=True, dtype=f32)
    wts = np.where(np.abs(total) > f32(1000.0 * float(np.finfo(np.float32).eps)),
                   wts / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= f32(n_in - 0.5))
    return np.where(inside[None, :], wts, f32(0.0)).astype(f32)


def resize_bicubic(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """[n,h_in,w_in] -> [n,h,w], ``jax.image.resize(method="bicubic")`` per
    sample, as two matrix products with the weights of
    :func:`_resize_weights`."""
    h_in, w_in = x.shape[-2:]
    h, w = out_hw
    out = x
    if h != h_in:
        wh = torch.from_numpy(_resize_weights(h_in, h)).to(x.device, x.dtype)
        out = torch.matmul(wh.t(), out)
    if w != w_in:
        ww = torch.from_numpy(_resize_weights(w_in, w)).to(x.device, x.dtype)
        out = torch.matmul(out, ww)
    return out


def bias_field(grid: torch.Tensor, hw: Tuple[int, int], magnitude: float) -> torch.Tensor:
    """Smooth multiplicative bias field (the reference's
    MyRandomPurtarbationV2 b-spline field, intensity_transform.py:375-548):
    the U(-1, 1) control grid [n,gh,gw] bicubically upsampled to [n,h,w],
    scaled to 1 +- magnitude."""
    field = resize_bicubic(grid, hw)
    mx = field.abs().amax(dim=(1, 2), keepdim=True) + 1e-10
    return 1.0 + magnitude * field / mx


def multiscale_bias_field(grids, hw: Tuple[int, int], control_points: Tuple[int, ...],
                          max_sigma: float, magnitude: float) -> torch.Tensor:
    """The V1 bias field (the reference's MyRandomPurtarbation,
    intensity_transform.py:318-353, with the JAX package's documented
    deviations): each U(0, 1) control grid [n,cp,cp] smoothed at sigma
    cp/4, bicubically upsampled and normalised to mass 1/cp; their sum
    smoothed at ``max_sigma``, normalised to unit mean and clipped to
    [1 - magnitude, 1 + magnitude]."""
    h, w = hw
    total = None
    for grid, cp in zip(grids, control_points):
        field = resize_bicubic(fft_gaussian_smooth(grid, cp / 4.0), hw)
        field = field / (field.sum(dim=(1, 2), keepdim=True) * cp / (h * w) + 1e-12)
        total = field if total is None else total + field
    total = fft_gaussian_smooth(total, max_sigma)
    total = total / (total.mean(dim=(1, 2), keepdim=True) + 1e-12)
    return torch.clamp(total, 1.0 - magnitude, 1.0 + magnitude)


def aug_coords(d: Draws, policy: AugPolicy) -> Tuple[torch.Tensor, torch.Tensor]:
    """Source coordinates [n,h,w] of the composed inverse warp, as torch
    ops."""
    return compose_coords(affine_matrix(d, policy), d["oy"], d["ox"], policy.pad_hw,
                          policy.crop_hw, *elastic_field(d, policy))


def sample_bilinear(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """The gather path: img [n,H,W], coords [n,h,w] -> [n,h,w], zero fill
    outside [0, H-1] x [0, W-1]."""
    n, h, w = img.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = ys - y0
    wx = xs - x0
    y0i = y0.long().clamp(0, h - 1)
    x0i = x0.long().clamp(0, w - 1)
    y1i = (y0i + 1).clamp(0, h - 1)
    x1i = (x0i + 1).clamp(0, w - 1)
    flat = img.reshape(n, h * w)

    def at(yi, xi):
        return torch.gather(flat, 1, (yi * w + xi).reshape(n, -1)).reshape(yi.shape)

    out = (at(y0i, x0i) * (1 - wy) * (1 - wx) + at(y0i, x1i) * (1 - wy) * wx
           + at(y1i, x0i) * wy * (1 - wx) + at(y1i, x1i) * wy * wx)
    inside = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
    return torch.where(inside, out, torch.zeros_like(out))


def sample_nearest(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """The gather path's nearest sample; ``round`` rounds half to even."""
    n, h, w = img.shape
    yi = torch.round(ys).long().clamp(0, h - 1)
    xi = torch.round(xs).long().clamp(0, w - 1)
    out = torch.gather(img.reshape(n, h * w), 1, (yi * w + xi).reshape(n, -1)).reshape(yi.shape)
    inside = (ys >= -0.5) & (ys <= h - 0.5) & (xs >= -0.5) & (xs <= w - 0.5)
    return torch.where(inside, out, torch.zeros_like(out))


def percentile_minmax(img: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Per-sample min-max of [n,h,w] to [0, 1] (the (0, 100) percentiles)."""
    mn = img.amin(dim=(1, 2), keepdim=True)
    mx = img.amax(dim=(1, 2), keepdim=True)
    return torch.clamp((img - mn) / (mx - mn + eps), 0.0, 1.0)


def post_warp_intensity(d: Draws, img: torch.Tensor, policy: AugPolicy) -> torch.Tensor:
    """Brightness/contrast, the V2 bias field, the V1 bias field with noise,
    gamma, then the final per-slice min-max."""
    p = policy
    if p.intensity_prob > 0:
        do_int = (d["intensity_u"] < p.intensity_prob)[:, None, None]
        c = d["contrast"][:, None, None]
        b = d["brightness"][:, None, None]
        img = torch.where(do_int, c * img + b, img)
    if p.bias_field_prob > 0:
        do_bias = (d["bias_u"] < p.bias_field_prob)[:, None, None]
        field = bias_field(d["bias_grid"], p.crop_hw, p.bias_field_magnitude)
        img = torch.where(do_bias, img * field, img)
    if p.perturb_v1_prob > 0:
        # min-max, noise and a clip to [0, 1] (intensity_transform.py:354-366)
        do_p = (d["v1_u"] < p.perturb_v1_prob)[:, None, None]
        cps = p.perturb_v1_control_points
        field = multiscale_bias_field([d[f"v1_grid{cp}"] for cp in cps], p.crop_hw, cps,
                                      p.perturb_v1_max_sigma, p.perturb_v1_magnitude)
        pert = percentile_minmax(img * field)
        if p.perturb_v1_noise_eps > 0:
            pert = torch.clamp(pert + p.perturb_v1_noise_eps * d["v1_noise"], 0.0, 1.0)
        img = torch.where(do_p, pert, img)
    if p.gamma_prob > 0:
        do_gamma = (d["gamma_u"] < p.gamma_prob)[:, None, None]
        img = torch.where(do_gamma, percentile_minmax(img) ** d["gamma"][:, None, None], img)
    return percentile_minmax(img)


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------


def center_crop_norm(images: torch.Tensor, labels: Optional[torch.Tensor],
                     crop_hw: Tuple[int, int], normalize: bool = True):
    """[n,H,W] -> center crop [n,h,w], min-max normalized; labels int32."""
    H, W = images.shape[-2:]
    h, w = crop_hw
    oy, ox = (H - h) // 2, (W - w) // 2
    img = images[:, oy:oy + h, ox:ox + w].float()
    if normalize:
        img = percentile_minmax(img)
    lab = None
    if labels is not None:
        lab = labels[:, oy:oy + h, ox:ox + w].to(torch.int32)
    return img, lab


def augment_batch_inner(generator: torch.Generator, images: torch.Tensor,
                        labels: torch.Tensor, policy: AugPolicy,
                        warp_backend: str = "kernel", draws: Optional[Draws] = None):
    """[n,H,W] padded slices -> ([n,h,w,1] float32, [n,h,w] int32).

    warp_backend: "kernel" (``ops/warp_kernels.py``: the CUDA kernels on the
    GPU, their plain versions on the CPU; labels round half up) or "gather"
    (:func:`sample_bilinear` or ``ops/spline.map_coordinates_cubic``, and
    :func:`sample_nearest`; labels round half to even). The policy's
    ``image_interp`` picks the bilinear or the cubic image warp; the
    bilinear kernel composes its coordinates itself, from the affine matrix
    and the smoothed field. ``draws`` pins the random numbers (see
    :func:`draw_aug`)."""
    if warp_backend not in ("kernel", "gather"):
        raise ValueError(warp_backend)
    images = images.float().contiguous()
    if draws is None:
        draws = draw_aug(generator, policy, images.shape[0])
    cubic = policy.image_interp == "cubic"
    if warp_backend == "kernel":
        labels = labels.to(torch.int32).contiguous()
    if warp_backend == "kernel" and not cubic:
        img, lab = warp_bilinear_nearest_affine(
            images, labels, affine_matrix(draws, policy), draws["oy"], draws["ox"],
            policy.crop_hw, *elastic_field(draws, policy))
    elif warp_backend == "kernel":
        sy, sx = aug_coords(draws, policy)
        img, lab = warp_cubic_nearest(images, labels, sy.contiguous(), sx.contiguous())
    else:
        sy, sx = aug_coords(draws, policy)
        img = map_coordinates_cubic(images, sy, sx) if cubic else sample_bilinear(images, sy, sx)
        lab = sample_nearest(labels.float(), sy, sx).to(torch.int32)
    img = post_warp_intensity(draws, img, policy)
    return img[..., None], lab


def augment_batch_sharded(generator: torch.Generator, images: torch.Tensor,
                          labels: torch.Tensor, policy: AugPolicy,
                          warp_backend: str = "kernel", draws: Optional[Draws] = None):
    """:func:`augment_batch_inner` of this rank's raw shard inside a data
    group (``parallel/mesh.sharded``), from a stream of the rank's own: one
    seed is drawn from ``generator`` (which every rank seeds alike, so it
    stays in step), and the rank's generator is seeded from that seed and
    its data rank, as the JAX package's ``augment_batch_sharded`` folds the
    data-axis index into its key. ``draws`` pins the rank's draws (the
    seed is drawn all the same)."""
    from maxstyle_tpu_torch import prng
    from maxstyle_tpu_torch.parallel import mesh

    shard = mesh.active()
    if shard is None:
        raise RuntimeError("augment_batch_sharded runs inside parallel/mesh.sharded")
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator, device=generator.device))
    own = prng.stream(seed, "augment", shard.rank, device=generator.device)
    return augment_batch_inner(own, images, labels, policy, warp_backend=warp_backend,
                               draws=draws)


def norm_batch(images: torch.Tensor, labels: torch.Tensor, crop_hw: Tuple[int, int],
               normalize: bool = True):
    """[n,H,W] -> center-cropped, normalized ([n,h,w,1], [n,h,w])."""
    img, lab = center_crop_norm(images, labels, crop_hw, normalize)
    return img[..., None], lab
