"""Device time of the MaxStyle statistics and backward calls at both
training cells' hook shapes, as the training step makes them.

    python3 -m maxstyle_tpu_torch.bench_style

The statistics call is ``channel_moments`` and the backward call
``plane_affine_bwd``, as ``apply_maxstyle_kernels`` runs them. To compare
two checkouts of the port, run this file with the other one first on the
path, ``PYTHONPATH=<checkout> python3 maxstyle_tpu_torch/bench_style.py``,
one process after the other on one card. Times are per call, by CUDA-graph
replay over input copies larger than L2 (``timing.cuda_ms``). Prints the
card, one JSON line per (call, cell, hook shape), and the launch floor
(:func:`launch_floor_ms`).
"""

from __future__ import annotations

import json
import math

import torch

import maxstyle_tpu_torch
from maxstyle_tpu_torch.config import MaxStyleConfig
from maxstyle_tpu_torch.ops import maxstyle_kernels as mk
from maxstyle_tpu_torch.timing import card, copies_beyond_l2, cuda_ms

# the style hooks of one decode (hook 3: 16 ch at half size, hook 4: 16 ch,
# hook 5: 1 ch), effective batch 20, for the 192^2 and the 224^2 cells
STYLE_SHAPES = {"headline": ((20, 16, 96, 96), (20, 16, 192, 192), (20, 1, 192, 192)),
                "prostate": ((20, 16, 112, 112), (20, 16, 224, 224), (20, 1, 224, 224))}


def launch_floor_ms() -> float:
    """The device time of a launch that does next to nothing (fill_ of a
    one-element tensor), timed as ``cuda_ms`` times a kernel."""
    one = [torch.zeros(1, device="cuda") for _ in range(2)]
    return cuda_ms(lambda i: one[i].fill_(1.0), 2)


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
    print(json.dumps({"call": "launch_floor", "ms": launch_floor_ms()}))


if __name__ == "__main__":
    main()
