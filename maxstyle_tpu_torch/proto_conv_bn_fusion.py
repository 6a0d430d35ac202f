"""A 3x3 convolution with the BatchNorm statistics in its epilogue, on the
CUDA kernel of ``csrc/conv_bn_stats.cu``, and its bench.

    python3 -m maxstyle_tpu_torch.proto_conv_bn_fusion           # bench
    python3 -m maxstyle_tpu_torch.proto_conv_bn_fusion --check   # kernel vs plain

Counterpart of ``scripts/proto_conv_bn_fusion.py`` (its ``_kernel``,
``:41``). A convolution followed by BatchNorm writes y, reads it back for the
per-channel mean and variance, and reads it again to normalise; a
convolution that sums y and y^2 per channel in its epilogue saves the middle
pass. The bench measures, at the encoder's hot shapes (B=20: 192^2 x 16,
96^2 x 32, 48^2 x 64 channels, Cout = Cin), three arms on the GPU:

* ``cudnn_conv``: ``F.conv2d`` alone (the floor);
* ``cudnn_conv_stats``: ``F.conv2d`` then ``torch.var_mean`` (the library);
* ``fused``: :func:`conv3x3_bn_stats`, the kernel;

and prints one JSON row per shape, after one line with the card's name and
power limit. ``--check`` holds the kernel against
:func:`conv3x3_bn_stats_plain` at those shapes and at ``RAGGED_SHAPES``
with the prototype's tolerances and exits nonzero if they disagree.
Float32 throughout, TF32 off in the library arms (the kernel's split-TF32
products are float32-accurate). Without a GPU both raise.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from maxstyle_tpu_torch import kernels
from maxstyle_tpu_torch.flagship import set_float32_policy
from maxstyle_tpu_torch.timing import (TF32_OPS_PER_S, bound_by, bound_ms, card,
                                       copies_beyond_l2, cuda_ms)

SHAPES = ((20, 192, 16), (20, 96, 32), (20, 48, 64))   # (B, H = W, Cin = Cout)
# (B, Cin, Cout, H, W) that reach every masked edge of the kernel: channels
# off the 8-channel chunk, Cout above one block's 32 channels, sides off the
# tile, widths staged by TMA boxes (W % 4 == 0) and by 4-byte copies, and
# 72 input channels, whose weights leave room for 16-channel groups only
RAGGED_SHAPES = ((3, 5, 7, 19, 23), (2, 24, 80, 50, 37), (2, 12, 40, 20, 36),
                 (1, 72, 96, 24, 40))
# the prototype's check() tolerances (rtol, atol)
TOLERANCES = {"y": (1e-5, 1e-5), "mean": (1e-5, 1e-6), "var": (1e-4, 1e-5)}
# the kernel keeps a channel group's split weights in shared memory: at
# least 16 channels of 9 taps x Cin, hi and lo, within 150 KiB
MAX_CIN = 128

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _stats(sum_y: torch.Tensor, sum_sq: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """float64 channel sums -> float32 (mean, biased var = E[y^2] - mean^2)."""
    mean = sum_y / n
    return mean.float(), (sum_sq / n - mean * mean).float()


def conv3x3_bn_stats_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> Result:
    """x [B,Cin,H,W], w [Cout,Cin,3,3], b [Cout] -> (y [B,Cout,H,W], mean
    [Cout], var [Cout]): the same-padding convolution as nine shifted
    channel contractions plus the bias, and the statistics from float64
    channel sums, as the kernel computes them."""
    bsz, _, h, wd = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    y = b[None, :, None, None].expand(bsz, -1, h, wd)
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, :, dy:dy + h, dx:dx + wd]
            y = y + torch.einsum("bihw,oi->bohw", tap, w[:, :, dy, dx])
    yd = y.double()
    return (y, *_stats(yd.sum(dim=(0, 2, 3)), (yd * yd).sum(dim=(0, 2, 3)), bsz * h * wd))


def conv3x3_bn_stats(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> Result:
    """The fused kernel; same contract as :func:`conv3x3_bn_stats_plain`."""
    if all(t.device.type == "cpu" for t in (x, w, b)):
        return conv3x3_bn_stats_plain(x, w, b)
    kernels.check_cuda_f32("conv3x3_bn_stats", x, w, b)
    bsz, cin, h, wd = x.shape
    cout = w.shape[0]
    if tuple(w.shape) != (cout, cin, 3, 3) or tuple(b.shape) != (cout,):
        raise ValueError("conv3x3_bn_stats: w must be [Cout, Cin, 3, 3] and b [Cout]")
    if min(bsz, cin, cout, h, wd) == 0 or cin > MAX_CIN:
        raise ValueError(f"conv3x3_bn_stats: the kernel takes no empty dimension and at most "
                         f"{MAX_CIN} input channels, got x {tuple(x.shape)}, w {tuple(w.shape)}")
    y = torch.empty((bsz, cout, h, wd), device=x.device, dtype=torch.float32)
    sums = torch.zeros((2, cout), device=x.device, dtype=torch.float64)
    kernels.launch("conv3x3_bn_stats", x, w, b, y, sums, bsz, cin, cout, h, wd)
    kernels.LAUNCHES["conv3x3_bn_stats"] += 1
    return (y, *_stats(sums[0], sums[1], bsz * h * wd))


def conv_stats_library(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> Result:
    """cuDNN's convolution, then ``torch.var_mean``: the two library calls
    that compute the same function."""
    y = F.conv2d(x, w, b, padding=1)
    var, mean = torch.var_mean(y, dim=(0, 2, 3), unbiased=False)
    return y, mean, var


def make_case(shape: Tuple[int, ...], seed: int, device, copies: int = 1):
    """The prototype's inputs: x ~ U[0, 1) [B,Cin,H,W] (``copies`` of them),
    w ~ 0.1 N(0, 1), b ~ 0.1 N(0, 1). ``shape`` is (B, H = W, Cin = Cout) or
    (B, Cin, Cout, H, W)."""
    bsz, cin, cout, h, wd = shape if len(shape) == 5 else (
        shape[0], shape[2], shape[2], shape[1], shape[1])
    g = torch.Generator(device=device).manual_seed(seed)
    xs = [torch.rand((bsz, cin, h, wd), generator=g, device=device) for _ in range(copies)]
    w = 0.1 * torch.randn((cout, cin, 3, 3), generator=g, device=device)
    b = 0.1 * torch.randn((cout,), generator=g, device=device)
    return xs, w, b


def work(shape: Tuple[int, int, int]) -> Tuple[float, float]:
    """(bytes, float32 operations) the function must move and do: x, w and
    b read once, y and the statistics written once; 2 * 9 * Cin * Cout
    operations a pixel for the convolution and 3 a value for the sums."""
    bsz, hw, c = shape
    n = bsz * hw * hw
    nbytes = 4 * (2 * n * c + 9 * c * c + c + 2 * c)
    return nbytes, 2 * 9 * c * c * n + 3 * n * c


def bound(shape: Tuple[int, int, int]) -> Tuple[float, str]:
    """The kernel's least time in ms and which term sets it: the bytes of
    :func:`work` over the memory rate, or the convolution's products over
    the tensor cores' TF32 rate, three times over, since a float32-accurate
    product takes three TF32 ones (lo*hi + hi*lo + hi*hi)."""
    nbytes, _ = work(shape)
    bsz, hw, c = shape
    products = 3 * 2 * 9 * c * c * bsz * hw * hw
    return (bound_ms(nbytes, products, TF32_OPS_PER_S),
            bound_by(nbytes, products, TF32_OPS_PER_S))


def compare(got: Result, want: Result) -> Dict[str, float]:
    """Largest error of each output in units of its tolerance (<= 1 passes),
    and the largest absolute error."""
    out = {"max_abs_err": 0.0, "worst": 0.0}
    for name, a, b in zip(TOLERANCES, got, want):
        rtol, atol = TOLERANCES[name]
        err = (a - b).abs()
        out["max_abs_err"] = max(out["max_abs_err"], float(err.max()))
        out[f"{name}_worst"] = float((err / (atol + rtol * b.abs())).max())
        out["worst"] = max(out["worst"], out[f"{name}_worst"])
    return out


def check(shapes=SHAPES + RAGGED_SHAPES, device="cuda") -> List[dict]:
    """The kernel against its plain version at each shape."""
    set_float32_policy(torch.device(device))
    rows = []
    for i, shape in enumerate(shapes):
        (x,), w, b = make_case(shape, i, device)
        rows.append({"shape": list(shape), **compare(conv3x3_bn_stats(x, w, b),
                                                     conv3x3_bn_stats_plain(x, w, b))})
    return rows


def bench(shapes=SHAPES, device="cuda") -> List[dict]:
    """Device times of the three arms (and of the plain version) at each
    shape, by CUDA-graph replays over input copies larger than L2."""
    set_float32_policy(torch.device(device))
    rows = []
    for i, shape in enumerate(shapes):
        bsz, hw, c = shape
        copies = copies_beyond_l2(4 * bsz * c * hw * hw)
        xs, w, b = make_case(shape, i, device, copies)
        t_conv = cuda_ms(lambda k: F.conv2d(xs[k], w, b, padding=1), copies)
        t_stats = cuda_ms(lambda k: conv_stats_library(xs[k], w, b), copies)
        t_fused = cuda_ms(lambda k: conv3x3_bn_stats(xs[k], w, b), copies)
        t_plain = cuda_ms(lambda k: conv3x3_bn_stats_plain(xs[k], w, b), copies)
        t_bound, bound_term = bound(shape)
        rows.append({
            "shape": f"B{bsz} {hw}x{hw} C{c}",
            "cudnn_conv_ms": t_conv, "cudnn_conv_stats_ms": t_stats,
            "stat_pass_cost_ms": t_stats - t_conv,
            "stat_pass_pct_of_conv": 100 * (t_stats - t_conv) / max(t_conv, 1e-9),
            "fused_ms": t_fused, "fused_vs_cudnn_stats": t_fused / t_stats,
            "plain_ms": t_plain, "bound_ms": t_bound, "bound_by": bound_term,
            "ffma_bound_ms": bound_ms(*work(shape)),
        })
        del xs
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="hold the kernel against its plain version and exit")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("proto_conv_bn_fusion runs on the GPU: no CUDA device is available")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": card()}))
    if args.check:
        rows = check()
        for row in rows:
            print(json.dumps(row))
        if any(row["worst"] > 1.0 for row in rows):
            print("conv3x3_bn_stats disagrees with its plain version", file=sys.stderr)
            return 1
        print("numerics OK (conv + mean + var match the plain version)")
        return 0
    for row in bench():
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
