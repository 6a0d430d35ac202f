"""Figure/report utilities (host, numpy; PNG written with zlib).

Counterpart of ``maxstyle_tpu/utils/visualize.py`` (the reference's
common_utils/save.py:148-325), which draws with matplotlib. The port's
machines have no matplotlib, so the port composes the figure as pixels and
writes the PNG itself (8-bit RGB, one IDAT chunk, ``zlib`` and ``struct``):

* :func:`save_segmentation_panels` — rows of (image, ground-truth overlay,
  prediction overlay), each panel at the image's own resolution, the image
  in gray scaled to its own min..max (matplotlib's ``imshow`` default), the
  label colors of :data:`PALETTE` blended at alpha 0.5 where the label is
  not 0;
* :func:`save_image_grid` — images in a ``cols``-wide grid.

The layout, file names and directories are the JAX package's. There is no
font: the panel titles go into the PNG's ``tEXt`` chunks
(``Title <row>,<col>``), beside the figure's own ``Title``.
:func:`read_png` reads such a file back.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# RGB of label 1, 2, 3, ... (label k takes PALETTE[(k - 1) % len])
PALETTE = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 0],
                    [255, 0, 255], [0, 255, 255], [255, 128, 0], [128, 0, 255]], np.float64)
ALPHA = 0.5
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def gray_rgb(image: np.ndarray) -> np.ndarray:
    """[H,W] -> [H,W,3] float gray in 0..255, scaled to the image's min..max
    (a constant image is black)."""
    img = np.asarray(image, np.float64)
    lo, hi = img.min(), img.max()
    g = (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
    return np.repeat(g[..., None] * 255.0, 3, axis=-1)


def overlay(image: np.ndarray, label: np.ndarray) -> np.ndarray:
    """The gray image with each non-zero label's color blended at ALPHA."""
    rgb = gray_rgb(image)
    lab = np.asarray(label).astype(np.int64)
    on = lab != 0
    color = PALETTE[(lab[on] - 1) % len(PALETTE)]
    rgb[on] = (1.0 - ALPHA) * rgb[on] + ALPHA * color
    return rgb


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray, text: Optional[Dict[str, str]] = None) -> str:
    """[H,W,3] values in 0..255 -> an 8-bit RGB PNG (filter 0 on every row),
    with ``text`` as tEXt chunks (Latin-1 keywords of 1-79 characters)."""
    pix = np.clip(np.rint(np.asarray(rgb, np.float64)), 0, 255).astype(np.uint8)
    h, w, c = pix.shape
    if c != 3:
        raise ValueError(f"expected [H,W,3] pixels, got {pix.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), pix.reshape(h, w * 3)], axis=1)
    out = [PNG_SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))]
    for key, value in (text or {}).items():
        out.append(_chunk(b"tEXt", key.encode("latin-1") + b"\x00" + value.encode("latin-1")))
    out += [_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)), _chunk(b"IEND", b"")]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"".join(out))
    return path


def read_png(path: str) -> Tuple[np.ndarray, Dict[str, str]]:
    """(pixels [H,W,3] uint8, tEXt entries) of a PNG that :func:`write_png`
    wrote: 8-bit RGB, no interlace, filter 0 rows. Checks every chunk's CRC."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG")
    pos, idat, text, header = len(PNG_SIGNATURE), [], {}, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in a {kind!r} chunk")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"tEXt":
            key, _, value = body.partition(b"\x00")
            text[key.decode("latin-1")] = value.decode("latin-1")
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: not an 8-bit RGB PNG without interlace: {header}")
    w, h = header[0], header[1]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: rows with a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3).copy(), text


def _grid(panels: Sequence[np.ndarray], cols: int) -> np.ndarray:
    """RGB panels laid out row by row in ``cols`` columns, each cell as large
    as the largest panel (a smaller panel sits top-left on black)."""
    ch = max(p.shape[0] for p in panels)
    cw = max(p.shape[1] for p in panels)
    rows = -(-len(panels) // cols)
    out = np.zeros((rows * ch, cols * cw, 3))
    for i, p in enumerate(panels):
        r, c = divmod(i, cols)
        out[r * ch:r * ch + p.shape[0], c * cw:c * cw + p.shape[1]] = p
    return out


def save_segmentation_panels(images: np.ndarray, gts: np.ndarray, preds: np.ndarray,
                             save_dir: str, tag: str = "best", max_slices: int = 10,
                             file_name: str = "Seg_plots.png") -> Optional[str]:
    """Rows of (image, GT overlay, prediction overlay) panels
    (save.save_testing_images_results:286-325) into
    ``{save_dir}/{tag}/{file_name}``; None when there is no slice."""
    n = min(len(images), max_slices)
    if n == 0:
        return None
    panels, text = [], {"Title": "rows of image | ground truth | prediction"}
    for i in range(n):
        panels += [gray_rgb(images[i]), overlay(images[i], gts[i]), overlay(images[i], preds[i])]
        for j, title in enumerate(("image", "ground truth", "prediction")):
            text[f"Title {i},{j}"] = title
    return write_png(os.path.join(save_dir, str(tag), file_name), _grid(panels, 3), text)


def save_image_grid(images: Sequence[np.ndarray], path: str,
                    titles: Optional[Sequence[str]] = None, cols: int = 4) -> str:
    """Gray images in a ``cols``-wide grid (save.py figure helpers
    :148-273); ``titles[i]`` is the tEXt entry of image i."""
    text = {}
    for i, title in enumerate(titles or ()):
        if i < len(images):
            r, c = divmod(i, cols)
            text[f"Title {r},{c}"] = title
    return write_png(path, _grid([gray_rgb(im) for im in images], cols), text)
