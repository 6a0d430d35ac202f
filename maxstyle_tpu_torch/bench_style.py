"""Device time of the MaxStyle calls at both training cells' hook shapes,
as the training step makes them, and of the cubic warp kernel.

    python3 -m maxstyle_tpu_torch.bench_style

The statistics call is ``channel_moments``, the backward call
``plane_affine_bwd`` and the forward call ``apply_maxstyle_kernels`` itself
(moments, spreads, the style map; its ``launches`` are the device launches
of one call, by ``torch.profiler``). The cubic warp is
``sample_cubic_nearest`` at the Prostate-cubic cell's shape, at the
augmentation policy's coordinates and at uniform ones. Only names that
every checkout since the moments kernel has are used, so to compare two
checkouts of the port, run this file with the other one first on the path,
``PYTHONPATH=<checkout> python3 maxstyle_tpu_torch/bench_style.py``, one
process after the other on one card. Times are per call, by CUDA-graph
replay over input copies larger than L2 (``timing.cuda_ms``). Prints the
card, one JSON line per (call, cell, hook shape or coordinates), and the
launch floor (:func:`launch_floor_ms`).
"""

from __future__ import annotations

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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_style needs a GPU")
    eps = MaxStyleConfig().eps
    print(f"bench_style: package {maxstyle_tpu_torch.__file__} on {card()}")
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
    cubic_rows()
    print(json.dumps({"call": "launch_floor", "ms": launch_floor_ms()}))


if __name__ == "__main__":
    main()
