"""Adversarial data-augmentation attacks: AdvNoise and AdvBias (NCHW).

Counterpart of ``maxstyle_tpu/ops/advchain.py``, the JAX package's native
re-implementation of the advchain baselines used at the reference's call
sites (train_adv_supervised_segmentation_triplet.py:434-530):

* AdvNoise — VAT-style additive noise: epsilon 0.1, xi 1e-6, one power
  iteration on the KL divergence, the attacked image min-max rescaled.
* AdvBias — a multiplicative bias field exp(field) in log space, spanned by
  a coarse control grid (spacing H/2 x W/2) interpolated to full size,
  moved by normalized-gradient ascent on the kl + contour consistency.

Each attack returns (attacked image, detached; consistency loss), where the
consistency loss is a fresh forward of the attacked image, differentiable
with respect to the model. The attack's own gradients are taken with
``torch.autograd.grad`` with respect to the perturbation only. The forwards
should be eval-mode (running BatchNorm statistics), as the reference runs
them. In a data group (``parallel/mesh.sharded``) the draws are those of
the global batch and each attack takes the rank's rows.

The bias field is resized as ``jax.image.resize`` resizes: per axis, a
weight matrix of the Keys cubic kernel (a = -0.5) or the triangle kernel at
half-pixel centres, each output's taps renormalized to sum to 1 where some
fall outside the input. ``F.interpolate(mode="bicubic")`` differs (a =
-0.75, clamped edge taps): 0.127 apart on a [-1, 1] 5x5 grid.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from maxstyle_tpu_torch import losses
from maxstyle_tpu_torch.ops.intensity import rescale_intensity
from maxstyle_tpu_torch.parallel import mesh


def _l2_normalize_per_sample(d: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Divide each sample by its largest magnitude, then by its L2 norm (the
    advchain ``unit_norm`` recipe, model_util.unit_norm:450-465)."""
    flat = d.reshape(d.shape[0], -1)
    flat = flat / (eps + flat.abs().amax(dim=1, keepdim=True))
    flat = flat / (eps + torch.linalg.vector_norm(flat, dim=1, keepdim=True))
    return flat.reshape(d.shape)


def draw_adv_noise(generator: torch.Generator, image_shape) -> Dict[str, torch.Tensor]:
    """AdvNoise's random start ``d`` ~ N(0, 1) of the image's shape."""
    return {"d": torch.randn(tuple(image_shape), generator=generator, device=generator.device)}


def adv_noise_attack(forward_fn: Callable[[torch.Tensor], torch.Tensor], image: torch.Tensor,
                     init_output: torch.Tensor, draws: Dict[str, torch.Tensor], *,
                     epsilon: float = 0.1, xi: float = 1e-6, n_iter: int = 1,
                     if_norm_image: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """VAT power iteration from ``draws["d"]``. ``forward_fn`` maps an image
    [N,1,H,W] to logits [N,C,H,W]. Returns (adv_image, consistency)."""
    p0 = init_output.detach()
    d = mesh.local_rows(draws["d"])

    def attack_input(r):
        x = image + r
        return rescale_intensity(x) if if_norm_image else x

    for _ in range(max(n_iter, 1)):
        r = (xi * _l2_normalize_per_sample(d)).detach().requires_grad_(True)
        with torch.enable_grad():
            div = losses.kl_divergence(p0, forward_fn(attack_input(r)))
            (d,) = torch.autograd.grad(div, r)
    adv_image = image + epsilon * _l2_normalize_per_sample(d)
    if if_norm_image:
        adv_image = rescale_intensity(adv_image)
    adv_image = adv_image.detach()
    return adv_image, losses.kl_divergence(p0, forward_fn(adv_image))


def control_grid_shape(hw: Tuple[int, int]) -> Tuple[int, int]:
    """Control points per axis at spacing H/2 x W/2, with the +3 border of a
    cubic spline: (5, 5)."""
    h, w = hw
    return (h // (h // 2) + 3, w // (w // 2) + 3)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def resize_weights_np(in_size: int, out_size: int, method: str) -> np.ndarray:
    """The [out, in] float32 weight matrix that ``jax.image.resize`` (scale
    out/in, no translation, antialias) contracts an axis with, for method
    "bicubic" or "bilinear"."""
    kernel = {"bicubic": _keys_cubic, "bilinear": _triangle}[method]
    inv_scale = np.float32(in_size) / np.float32(out_size)
    kernel_scale = max(float(inv_scale), 1.0)
    sample = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale
              - np.float32(0.5)).astype(np.float32)
    x = (np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None])
         / np.float32(kernel_scale)).astype(np.float32)
    weights = kernel(x).astype(np.float32)
    total = weights.sum(axis=0, keepdims=True, dtype=np.float32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32).T


@functools.lru_cache(maxsize=32)
def _resize_weights(in_size: int, out_size: int, method: str,
                    device: torch.device) -> torch.Tensor:
    """:func:`resize_weights_np` on ``device``, copied there once: a copy to
    the GPU in every call would wait for the device."""
    return torch.from_numpy(resize_weights_np(in_size, out_size, method)).to(device)


def resize(x: torch.Tensor, out_hw: Tuple[int, int], method: str) -> torch.Tensor:
    """``jax.image.resize`` of the spatial axes of x [N,C,H,W]."""
    wy = _resize_weights(x.shape[2], out_hw[0], method, x.device)
    wx = _resize_weights(x.shape[3], out_hw[1], method, x.device)
    return torch.einsum("yh,nchw,xw->ncyx", wy, x, wx)


def bias_field_from_control_points(cp: torch.Tensor, out_hw: Tuple[int, int],
                                   downscale: int = 2) -> torch.Tensor:
    """Smooth field [B,1,H,W] from a control grid [B,1,gh,gw]: bicubic to
    the downscaled grid, then bilinear to full size (advchain's
    ``downscale`` trick)."""
    h, w = out_hw
    low = resize(cp, (max(h // downscale, 1), max(w // downscale, 1)), "bicubic")
    return resize(low, (h, w), "bilinear")


def _project_field(field: torch.Tensor, epsilon: float) -> torch.Tensor:
    """Scale each sample's field to the largest magnitude ``epsilon``."""
    mx = field.reshape(field.shape[0], -1).abs().amax(dim=1).reshape(-1, 1, 1, 1)
    return epsilon * field / (mx + 1e-10)


def draw_adv_bias(generator: torch.Generator, image_shape) -> Dict[str, torch.Tensor]:
    """AdvBias's control points ``cp`` ~ U[-1, 1) [B,1,gh,gw]."""
    b, _, h, w = image_shape
    gh, gw = control_grid_shape((h, w))
    u = torch.rand((b, 1, gh, gw), generator=generator, device=generator.device)
    return {"cp": u * 2.0 - 1.0}


def adv_bias_attack(forward_fn: Callable[[torch.Tensor], torch.Tensor], image: torch.Tensor,
                    init_output: torch.Tensor, draws: Dict[str, torch.Tensor], *,
                    epsilon: float = 0.4, downscale: int = 2, n_iter: int = 1,
                    divergence_types=("kl", "contour"), divergence_weights=(1.0, 0.5),
                    step_size: float = 0.3, if_norm_image: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adversarial bias field x * exp(field) from ``draws["cp"]``, moved by
    ``n_iter`` normalized-gradient-ascent steps of the consistency
    divergence. Returns (adv_image, consistency)."""
    h, w = image.shape[2], image.shape[3]
    p0 = init_output.detach()

    def apply_bias(cp_):
        field = _project_field(bias_field_from_control_points(cp_, (h, w), downscale), epsilon)
        x = image * torch.exp(field)
        return rescale_intensity(x) if if_norm_image else x

    def divergence(x):
        return losses.segmentation_consistency(forward_fn(x), p0,
                                               divergence_types=divergence_types,
                                               divergence_weights=divergence_weights)

    cp = mesh.local_rows(draws["cp"])
    for _ in range(max(n_iter, 1)):
        live = cp.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(divergence(apply_bias(live)), live)
        cp = cp + step_size * _l2_normalize_per_sample(g)
    adv_image = apply_bias(cp).detach()
    return adv_image, divergence(adv_image)


def compose_adversarial_attack(forward_fn: Callable[[torch.Tensor], torch.Tensor],
                               image: torch.Tensor, init_output: torch.Tensor, draws, *,
                               transforms=("noise",), n_iter: int = 1,
                               divergence_types=("kl",), divergence_weights=(1.0,),
                               if_norm_image: bool = True, downscale: int = 2):
    """A chain of adversarial transforms ("noise", "bias"), each attacking
    the current image with ``draws[i]``, the draws of transform i; the
    consistency is measured on the final composition (advchain's
    ComposeAdversarialTransformSolver surface)."""
    x = image
    for t, d in zip(transforms, draws, strict=True):
        if t == "noise":
            x, _ = adv_noise_attack(forward_fn, x, init_output, d, n_iter=n_iter,
                                    if_norm_image=if_norm_image)
        elif t == "bias":
            x, _ = adv_bias_attack(forward_fn, x, init_output, d, n_iter=n_iter,
                                   downscale=downscale, divergence_types=divergence_types,
                                   divergence_weights=divergence_weights,
                                   if_norm_image=if_norm_image)
        else:
            raise NotImplementedError(t)
    x = x.detach()
    consistency = losses.segmentation_consistency(
        forward_fn(x), init_output.detach(), divergence_types=divergence_types,
        divergence_weights=divergence_weights)
    return x, consistency
