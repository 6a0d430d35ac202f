"""The card's peaks, and the least work the port's kernels have to do.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 3.35 TB/s of HBM3, 67 TFLOP/s in float32 outside the tensor cores.
The configurations state float32 with TF32 off, so 67 is the step's peak.

A kernel's bound is the larger of its bytes over the memory rate and its
operations over the float32 rate, with each input read once and each output
written once (the rule of the port's kernel table), from the shapes alone.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# the kernels' symbols in the profiler's kernel names
KERNELS = {"maxstyle_stats": "maxstyle_stats_kernel",
           "maxstyle_apply": "maxstyle_apply_kernel",
           "maxstyle_bwd": "maxstyle_bwd_kernel",
           "warp_bilinear_nearest": "warp_bilinear_nearest_kernel"}
STYLE_KERNELS = ("maxstyle_stats", "maxstyle_apply", "maxstyle_bwd")


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S)


def style_bound_s(kernel: str, b: int, c: int, h: int, w: int) -> float:
    """One launch at a style hook of [b, c, h, w] float32 activations:
    moments (read x; write mean and spread), apply (read x, the [b, c]
    moments, noises and spreads, lmda, the permutation, the gate; write the
    output) or backward (read the gradient and x; write dx and two [b, c]
    sums)."""
    n = b * c * h * w
    bc = b * c
    if kernel == "maxstyle_stats":
        return bound_s(4 * n + 8 * bc, 3 * n)
    if kernel == "maxstyle_apply":
        return bound_s(8 * n + 32 * bc + 12 * b + 16 * c + 4, 2 * n + 25 * bc)
    if kernel == "maxstyle_bwd":
        return bound_s(12 * n + 12 * bc, 4 * n)
    raise ValueError(kernel)


def warp_bound_s(n: int, pad: int, crop: int) -> float:
    """One composed warp of ``n`` raw [pad, pad] slices to [crop, crop]:
    read the image and the label, the crop window of the two-channel
    elastic field, and a sample's matrix, offsets, alpha and gate; write the
    image and the label."""
    px = n * crop * crop
    return bound_s(8 * n * pad * pad + 16 * px + 48 * n, 40 * px)
