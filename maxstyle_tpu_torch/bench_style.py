"""Device time of the MaxStyle calls at both training cells' hook shapes,
as the training step makes them, and of the two warp kernels.

    python3 -m maxstyle_tpu_torch.bench_style [--rows style,cubic,warp]

The statistics call is ``channel_moments``, the backward call
``plane_affine_bwd`` and the forward call ``apply_maxstyle_kernels`` itself
(moments, spreads, the style map; its ``launches`` are the device launches
of one call, by ``torch.profiler``). The cubic warp is
``sample_cubic_nearest`` at the Prostate-cubic cell's shape, at the
augmentation policy's coordinates and at uniform ones. The bilinear warp
(:func:`warp_rows`, the headline cell's shape) is timed by entry and by
pixels a thread, each also held bit for bit against its plain version:
the coordinate entry at the policy's, uniform and rim-straddling
coordinates, the composed entry at the policy's draws, and the parent's
route to the warp (:func:`parent_route`). Only names that every checkout
since the moments kernel has are used (a checkout without the composed
entry times its coordinate kernel alone), so to compare two checkouts of
the port, run this file with the other one first on the path,
``PYTHONPATH=<checkout> python3 maxstyle_tpu_torch/bench_style.py``, one
process after the other on one card. Times are per call, by CUDA-graph
replay over input copies larger than L2 (``timing.cuda_ms``). Prints the
card, one JSON line per (call, cell, hook shape or coordinates), and the
launch floor (:func:`launch_floor_ms`).
"""

from __future__ import annotations

import argparse
import json
import math

import torch

import maxstyle_tpu_torch
from maxstyle_tpu_torch.config import MaxStyleConfig
from maxstyle_tpu_torch.data import augment as A
from maxstyle_tpu_torch.ops import maxstyle as ms
from maxstyle_tpu_torch.ops import maxstyle_kernels as mk
from maxstyle_tpu_torch.ops import spline
from maxstyle_tpu_torch.ops import warp_kernels as wk
from maxstyle_tpu_torch.timing import card, copies_beyond_l2, cuda_ms

# the style hooks of one decode (hook 3: 16 ch at half size, hook 4: 16 ch,
# hook 5: 1 ch), effective batch 20, for the 192^2 and the 224^2 cells
STYLE_SHAPES = {"headline": ((20, 16, 96, 96), (20, 16, 192, 192), (20, 1, 192, 192)),
                "prostate": ((20, 16, 112, 112), (20, 16, 224, 224), (20, 1, 224, 224))}
# the cubic warp of the Prostate-cubic cell: N, padded source side, crop side
CUBIC_SHAPE = (10, 288, 224)
# the bilinear warp of the headline cell, and its policy
WARP_SHAPE = (10, 224, 192)
WARP_POLICY = "ACDC_affine_elastic_intensity"


def launch_floor_ms() -> float:
    """The device time of a launch that does next to nothing (fill_ of a
    one-element tensor), timed as ``cuda_ms`` times a kernel."""
    one = [torch.zeros(1, device="cuda") for _ in range(2)]
    return cuda_ms(lambda i: one[i].fill_(1.0), 2)


def device_launches(fn) -> int:
    """Kernels, copies and fills that one call of fn puts on the card, by
    torch.profiler (after one call outside it)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False))


def forward_call(shape, gen, copies):
    """fn(i): the forward MaxStyle call of the training step on input copy i,
    with style parameters and state drawn by ``init_maxstyle`` (gate on)."""
    cfg = MaxStyleConfig()
    xs = [torch.randn(shape, generator=gen, device="cuda") for _ in range(copies)]
    params, state = ms.init_maxstyle(gen, shape[0], shape[1], cfg)
    state.gate = torch.ones((), device="cuda")

    @torch.no_grad()
    def fn(i):
        return mk.apply_maxstyle_kernels(xs[i], params, state, cfg)
    return fn


def cubic_rows() -> None:
    """sample_cubic_nearest at the policy's and at uniform coordinates."""
    n, big, crop = CUBIC_SHAPE
    copies = copies_beyond_l2(n * big * big * 8 + n * crop * crop * 8)
    gen = torch.Generator(device="cuda").manual_seed(7)
    policy = A.get_policy("Prostate_affine_elastic_intensity", (big, big), (crop, crop))
    coefs = [spline.spline_filter2d_matrix(torch.rand((n, big, big), generator=gen,
                                                      device="cuda")) for _ in range(copies)]
    labs = [torch.randint(0, 4, (n, big, big), generator=gen, device="cuda", dtype=torch.int32)
            for _ in range(copies)]
    coords = {"policy": [tuple(t.contiguous() for t in
                               A.aug_coords(A.draw_aug(gen, policy, n), policy))
                         for _ in range(copies)],
              "uniform": [tuple(torch.rand((n, crop, crop), generator=gen, device="cuda")
                                * (big + 3) - 2 for _ in range(2)) for _ in range(copies)]}
    for kind, crd in coords.items():
        print(json.dumps({"call": "cubic", "coords": kind, "shape": [n, big, big, crop, crop],
                          "ms": cuda_ms(lambda i: wk.sample_cubic_nearest(
                              coefs[i], labs[i], *crd[i]), copies)}))


def rim_coords(gen, n, big, crop):
    """Coordinates of a grid stretched over [-2.5, big+1.5] on both axes,
    jittered by up to half a pixel, so that tiles straddle both rims."""
    grid = torch.linspace(-2.5, big + 1.5, crop, device=gen.device)
    jitter = [torch.rand((n, crop, crop), generator=gen, device=gen.device) * 0.5
              for _ in range(2)]
    return grid[None, :, None] + jitter[0], grid[None, None, :] + jitter[1]


def composed_inputs(gen, policy, n):
    """(mat, oy, ox[, sm, alpha, gate]) of the composed warp from the
    policy's draws, with the elastic gate on for even samples and off for
    odd ones."""
    d = A.draw_aug(gen, policy, n)
    d["elastic_u"] = (torch.arange(n, device=gen.device) % 2).float()
    return (A.affine_matrix(d, policy), d["oy"], d["ox"]) + A.elastic_field(d, policy)


def parent_route(images, labels, mat, oy, ox, out_hw, sm, alpha, gate):
    """The route from the affine matrix and the smoothed field to the warped
    batch before the coordinates moved into the kernel: ``aug_coords``'
    torch ops as they were (the field times alpha at full size, its crop
    window gathered, times the gate), then the coordinate kernel."""
    _, big_h, big_w = images.shape
    h, w = out_hw
    dev = images.device
    ty = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None] + oy[:, None, None]
    tx = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :] + ox[:, None, None]
    cy, cx = (big_h - 1) / 2.0, (big_w - 1) / 2.0
    ty_c, tx_c = ty - cy, tx - cx
    m = mat[:, :, :, None, None]
    sy = m[:, 0, 0] * ty_c + m[:, 0, 1] * tx_c + m[:, 0, 2] + cy
    sx = m[:, 1, 0] * ty_c + m[:, 1, 1] * tx_c + m[:, 1, 2] + cx
    a, g = alpha[:, None, None], gate[:, None, None]
    dy_full, dx_full = sm[:, 0] * a, sm[:, 1] * a
    rows = (oy[:, None] + torch.arange(h, device=dev))[:, :, None]
    cols = (ox[:, None] + torch.arange(w, device=dev))[:, None, :]
    idx = torch.arange(mat.shape[0], device=dev)[:, None, None]
    sy = sy + dy_full[idx, rows, cols] * g
    sx = sx + dx_full[idx, rows, cols] * g
    return wk.warp_bilinear_nearest(images, labels, sy.contiguous(), sx.contiguous())


def warp_rows() -> None:
    """The bilinear warp at the headline cell's shape: each entry, and the
    parent's route."""
    n, big, crop = WARP_SHAPE
    composed = hasattr(wk, "warp_bilinear_nearest_affine")
    copies = copies_beyond_l2(n * big * big * 16 + n * crop * crop * 8)
    gen = torch.Generator(device="cuda").manual_seed(7)
    policy = A.get_policy(WARP_POLICY, (big, big), (crop, crop))
    imgs = [torch.rand((n, big, big), generator=gen, device="cuda") for _ in range(copies)]
    labs = [torch.randint(0, 4, (n, big, big), generator=gen, device="cuda", dtype=torch.int32)
            for _ in range(copies)]
    coords = {"policy": [tuple(t.contiguous() for t in
                               A.aug_coords(A.draw_aug(gen, policy, n), policy))
                         for _ in range(copies)],
              "uniform": [tuple(torch.rand((n, crop, crop), generator=gen, device="cuda")
                                * (big + 3) - 2 for _ in range(2)) for _ in range(copies)],
              "rim": [rim_coords(gen, n, big, crop) for _ in range(copies)]}
    shape = [n, big, big, crop, crop]

    def same(a, b):
        return all(torch.equal(u, v) for u, v in zip(a, b))

    for kind, crd in coords.items():
        plain = wk.warp_bilinear_nearest_plain(imgs[0], labs[0], *crd[0])
        print(json.dumps({"call": "warp", "entry": "coords", "coords": kind, "shape": shape,
                          "ms": cuda_ms(lambda i: wk.warp_bilinear_nearest(
                              imgs[i], labs[i], *crd[i]), copies),
                          "bit_equal": same(wk.warp_bilinear_nearest(
                              imgs[0], labs[0], *crd[0]), plain)}))
    if not composed:
        return
    del coords
    comp = [composed_inputs(gen, policy, n) for _ in range(copies)]
    plain = wk.warp_bilinear_nearest_affine_plain(imgs[0], labs[0], *comp[0][:3], (crop, crop),
                                                  *comp[0][3:])

    def fn(i):
        return wk.warp_bilinear_nearest_affine(imgs[i], labs[i], *comp[i][:3], (crop, crop),
                                               *comp[i][3:])
    print(json.dumps({"call": "warp", "entry": "composed", "coords": "policy",
                      "shape": shape, "ms": cuda_ms(fn, copies),
                      "bit_equal": same(fn(0), plain)}))
    print(json.dumps({"call": "warp", "entry": "parent_route", "coords": "policy",
                      "shape": shape, "ms": cuda_ms(
                          lambda i: parent_route(imgs[i], labs[i], *comp[i][:3], (crop, crop),
                                                 *comp[i][3:]), copies)}))


def style_rows() -> None:
    """stats, bwd and the forward call at both cells' hook shapes."""
    eps = MaxStyleConfig().eps
    for cell, shapes in STYLE_SHAPES.items():
        for hook, shape in zip((3, 4, 5), shapes):
            copies = copies_beyond_l2(math.prod(shape) * 4)
            gen = torch.Generator(device="cuda").manual_seed(hook)
            xs = [torch.randn(shape, generator=gen, device="cuda") for _ in range(copies)]
            gs = [torch.randn(shape, generator=gen, device="cuda") for _ in range(copies)]
            scale = torch.randn(shape[:2], generator=gen, device="cuda")
            for name, fn in (("stats", lambda i: mk.channel_moments(xs[i], eps)),
                             ("bwd", lambda i: mk.plane_affine_bwd(gs[i], xs[i], scale))):
                print(json.dumps({"call": name, "cell": cell, "hook": hook, "shape": list(shape),
                                  "ms": cuda_ms(fn, copies)}))
            del xs, gs
            fwd = forward_call(shape, gen, copies)
            print(json.dumps({"call": "forward", "cell": cell, "hook": hook,
                              "shape": list(shape), "ms": cuda_ms(fwd, copies),
                              "launches": device_launches(lambda: fwd(0))}))
            del fwd


ROWS = {"style": style_rows, "cubic": cubic_rows, "warp": warp_rows}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default=",".join(ROWS),
                    help="comma-separated groups of rows: " + ", ".join(ROWS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_style needs a GPU")
    from maxstyle_tpu_torch.utils.gpulock import chip_lock
    with chip_lock("bench_style"):
        print(f"bench_style: package {maxstyle_tpu_torch.__file__} on {card()}")
        for name in args.rows.split(","):
            ROWS[name]()
        print(json.dumps({"call": "launch_floor", "ms": launch_floor_ms()}))


if __name__ == "__main__":
    main()
