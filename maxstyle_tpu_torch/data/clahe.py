"""Contrast-Limited Adaptive Histogram Equalization (host-side numpy).

The port's copy of ``maxstyle_tpu/data/clahe.py``.

Parity target: MyRandomImageContrastTransform
(the reference's src/dataset_loader/_utils/intensity_transform.py:12-65),
which wraps skimage.exposure.equalize_adapthist and is gated `enable=False`
in every shipped experiment. It is a HOST preprocessing transform in the
reference (per-slice, before batching), so it stays host-side here too —
no device round-trip is warranted for an off-by-default path.

Implementation: classic tile-grid CLAHE — per-tile clipped histogram with
uniform excess redistribution, per-tile CDF mapping, bilinear blending of
the four neighbouring tile mappings per pixel. Matches skimage's semantics
(clip_limit scaled by tile_pixels/nbins, output in [0, 1]) without the
skimage dependency (not in this image).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def equalize_adapthist(image: np.ndarray, clip_limit: float = 0.01,
                       nbins: int = 256,
                       tile_grid: Tuple[int, int] = (8, 8)) -> np.ndarray:
    """CLAHE on a single [H, W] image; returns float32 in [0, 1]."""
    img = np.asarray(image, np.float64)
    mn, mx = img.min(), img.max()
    if mx - mn < 1e-12:
        return np.zeros_like(img, np.float32)
    img = (img - mn) / (mx - mn)
    h, w = img.shape
    gy, gx = tile_grid
    th, tw = -(-h // gy), -(-w // gx)  # ceil tile size
    ph, pw = th * gy - h, tw * gx - w
    padded = np.pad(img, ((0, ph), (0, pw)), mode="reflect")
    bins = np.minimum((padded * nbins).astype(np.int32), nbins - 1)

    # per-tile clipped histograms -> CDF mappings [gy, gx, nbins]
    tiles = bins.reshape(gy, th, gx, tw).transpose(0, 2, 1, 3).reshape(
        gy, gx, th * tw)
    maps = np.empty((gy, gx, nbins), np.float64)
    clim = max(clip_limit * th * tw / nbins, 1.0)
    for iy in range(gy):
        for ix in range(gx):
            hist = np.bincount(tiles[iy, ix], minlength=nbins).astype(np.float64)
            excess = np.maximum(hist - clim, 0.0).sum()
            hist = np.minimum(hist, clim) + excess / nbins
            cdf = np.cumsum(hist)
            maps[iy, ix] = (cdf - cdf[0]) / max(cdf[-1] - cdf[0], 1e-12)

    # bilinear blend of the 4 surrounding tile mappings at each pixel
    yy = (np.arange(th * gy, dtype=np.float64) + 0.5) / th - 0.5
    xx = (np.arange(tw * gx, dtype=np.float64) + 0.5) / tw - 0.5
    y0 = np.clip(np.floor(yy).astype(np.int32), 0, gy - 1)
    x0 = np.clip(np.floor(xx).astype(np.int32), 0, gx - 1)
    y1 = np.minimum(y0 + 1, gy - 1)
    x1 = np.minimum(x0 + 1, gx - 1)
    fy = np.clip(yy - y0, 0.0, 1.0)[:, None]
    fx = np.clip(xx - x0, 0.0, 1.0)[None, :]

    b = bins
    Y0, X0 = y0[:, None], x0[None, :]
    Y1, X1 = y1[:, None], x1[None, :]
    out = ((1 - fy) * (1 - fx) * maps[Y0, X0, b]
           + (1 - fy) * fx * maps[Y0, X1, b]
           + fy * (1 - fx) * maps[Y1, X0, b]
           + fy * fx * maps[Y1, X1, b])
    return out[:h, :w].astype(np.float32)


def random_clahe(rng: np.random.RandomState, image: np.ndarray,
                 clip_limit_range: Tuple[float, float] = (0.01, 1.0),
                 nbins: int = 256,
                 label: Optional[np.ndarray] = None):
    """MyRandomImageContrastTransform semantics (:32-65): draw one clip
    limit, equalize each slice of an [S, H, W] (or single [H, W]) image,
    restore the per-slice intensity range; labels pass through untouched."""
    clip_limit = float(rng.uniform(*clip_limit_range))
    img = np.asarray(image, np.float32)
    single = img.ndim == 2
    vol = img[None] if single else img
    out = np.empty_like(vol)
    for i, sl in enumerate(vol):
        eq = equalize_adapthist(sl, clip_limit=clip_limit, nbins=nbins)
        lo, hi = float(sl.min()), float(sl.max())
        out[i] = eq * (hi - lo) + lo  # recover original range (:55-57)
    out = out[0] if single else out
    return out if label is None else (out, label)
