"""Prediction post-processing (host-side).

The port's copy of ``maxstyle_tpu/utils/postprocess.py``
(≙ common_utils/post_process.keep_largest_connected_components:5-44), via
scipy.ndimage.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def keep_largest_connected_components(segmentation: np.ndarray) -> np.ndarray:
    """For each foreground class, keep only its largest connected component.

    segmentation: int array [S,H,W] or [H,W].
    """
    out = np.zeros_like(segmentation)
    for cls in np.unique(segmentation):
        if cls == 0:
            continue
        binary = segmentation == cls
        labeled, n = ndimage.label(binary)
        if n == 0:
            continue
        sizes = ndimage.sum(binary, labeled, index=np.arange(1, n + 1))
        keep = int(np.argmax(sizes)) + 1
        out[labeled == keep] = cls
    return out
