"""Cubic B-spline interpolation with scipy ``map_coordinates(order=3)``
semantics.

Counterpart of ``maxstyle_tpu/ops/spline.py``:

* :func:`spline_filter1d` / :func:`spline_filter2d` — Unser's recursive
  prefilter (pole z = sqrt(3) - 2, gain 6, mirror boundary), as a loop along
  the filtered axis, vectorised over every other axis, like the JAX
  ``lax.scan``. It is the reference for the fast form.
* :func:`spline_filter2d_matrix` — the same filter as two matrix products.
  The prefilter is linear and separable, so along an axis of length n it is
  an [n, n] matrix: the loop applied to the identity in float64. The matrix
  is built once per (n, device) and cached, and ``M_h @ img @ M_w^T`` runs
  as two batched float32 products instead of ~4n small sequential steps.
* :func:`sample_cubic` — 4x4-tap B-spline evaluation of prefiltered
  coefficients at float coordinates: taps mirror at the rim (-1 -> 1,
  N -> N-2), and only coordinates strictly outside [0, N-1] return 0
  (scipy ``mode="constant"``).
* :func:`map_coordinates_cubic` — the two composed.

Arrays are batched: images [n, H, W], coordinates [n, h, w].
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

# cubic B-spline pole (Unser 1993; scipy ni_interpolation.c order-3)
_POLE = math.sqrt(3.0) - 2.0
_GAIN = 6.0  # (1 - z)(1 - 1/z) for the cubic pole
_SIXTH = 1.0 / 6.0
_EXACT_INIT_MAX = 28  # z^k underflows float32 past 28 terms

_MATRICES: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def spline_filter1d(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Cubic B-spline coefficient prefilter along ``axis``, mirror boundary
    (scipy.ndimage.spline_filter1d(order=3, mode='mirror'))."""
    x = x.movedim(axis, 0)
    n = x.shape[0]
    if n < 2:
        return x.movedim(0, axis)  # a single sample is its own coefficient
    z = torch.tensor(_POLE, dtype=x.dtype, device=x.device)
    xg = x * _GAIN
    # causal init: c+[0] over the mirror extension; truncated for n > 28,
    # the exact sum over the reflected period otherwise
    if n > _EXACT_INIT_MAX:
        pw = z ** torch.arange(_EXACT_INIT_MAX, dtype=x.dtype, device=x.device)
        c0 = torch.tensordot(pw, xg[:_EXACT_INIT_MAX], dims=([0], [0]))
    else:
        k = torch.arange(1, n - 1, dtype=x.dtype, device=x.device)
        wts = z ** k + z ** (2 * (n - 1) - k)
        inner = torch.tensordot(wts, xg[1:n - 1], dims=([0], [0]))
        c0 = (xg[0] + z ** (n - 1) * xg[n - 1] + inner) / (1.0 - z ** (2 * n - 2))
    cp = [c0]
    for k in range(1, n):
        cp.append(xg[k] + z * cp[-1])
    # anticausal init (mirror, Unser eq. 2.6 / scipy _sym_iir)
    out = [(z / (z * z - 1.0)) * (cp[n - 1] + z * cp[n - 2])]
    for k in range(n - 2, -1, -1):
        out.append(z * (out[-1] - cp[k]))
    return torch.stack(out[::-1]).movedim(0, axis)


def spline_filter2d(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W] images -> cubic spline coefficients (both axes), by the
    recursion."""
    return spline_filter1d(spline_filter1d(img, axis=-2), axis=-1)


def spline_matrix(n: int, device) -> torch.Tensor:
    """The [n, n] float32 matrix M with M @ v == spline_filter1d(v) for a
    vector v of length n: the recursion applied to the identity in float64
    on the CPU, cached per (n, device)."""
    key = (n, torch.device(device))
    if key not in _MATRICES:
        eye = torch.eye(n, dtype=torch.float64)
        _MATRICES[key] = spline_filter1d(eye, axis=0).to(torch.float32).to(key[1])
    return _MATRICES[key]


def spline_filter2d_matrix(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W] float32 images -> the coefficients of
    :func:`spline_filter2d` as ``M_H @ img @ M_W^T`` (two batched matrix
    products; full float32 when TF32 is off, as the port sets it)."""
    h, w = img.shape[-2:]
    m_h = spline_matrix(h, img.device)
    m_w = spline_matrix(w, img.device)
    return torch.matmul(torch.matmul(m_h, img), m_w.t())


def bspline_weights(t: torch.Tensor):
    """Cubic B-spline basis at fractional offset t in [0, 1): weights of the
    taps at floor-1, floor, floor+1, floor+2. Every operation rounds once,
    in this order (the CUDA warp kernel repeats it)."""
    t2 = t * t
    t3 = t2 * t
    w0 = (1.0 - 3.0 * t + 3.0 * t2 - t3) * _SIXTH
    w1 = (4.0 - 6.0 * t2 + 3.0 * t3) * _SIXTH
    w2 = (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3) * _SIXTH
    w3 = t3 * _SIXTH
    return w0, w1, w2, w3


def reflect_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Whole-sample mirror (-1 -> 1, n -> n-2), then clip: far-outside
    coordinates are filled anyway."""
    idx = torch.where(idx < 0, -idx, idx)
    idx = torch.where(idx > n - 1, 2 * (n - 1) - idx, idx)
    return idx.clamp(0, n - 1)


def floor_index(coord: torch.Tensor, n: int) -> torch.Tensor:
    """floor(coord) as an integer index, held to [-2, n+1] so that any
    coordinate indexes safely; inside [-0.5, n-0.5] nothing is clipped."""
    return torch.floor(coord).clamp(-2.0, n + 1.0).long()


def sample_cubic(coeffs: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Evaluate prefiltered coefficients [n,H,W] at float coordinates
    [n,h,w] -> [n,h,w]; zero strictly outside [0, H-1] x [0, W-1]. The 16
    terms (wy_i * wx_j) * c add in row-major tap order, one rounding per
    operation, which the CUDA warp kernel repeats."""
    n, h, w = coeffs.shape
    wy = bspline_weights(ys - torch.floor(ys))
    wx = bspline_weights(xs - torch.floor(xs))
    y0 = floor_index(ys, h)
    x0 = floor_index(xs, w)
    flat = coeffs.reshape(n, h * w)
    out = torch.zeros_like(ys)
    for i in range(4):
        row = reflect_index(y0 + (i - 1), h) * w
        for j in range(4):
            idx = (row + reflect_index(x0 + (j - 1), w)).reshape(n, -1)
            tap = torch.gather(flat, 1, idx).reshape(ys.shape)
            out = out + wy[i] * wx[j] * tap
    inside = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
    return torch.where(inside, out, torch.zeros_like(out))


def map_coordinates_cubic(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """scipy.ndimage.map_coordinates(img, [ys, xs], order=3, mode='constant',
    prefilter=True) for batches of 2-D images [n,H,W] at [n,h,w]."""
    return sample_cubic(spline_filter2d(img), ys, xs)
