"""Device timing of short calls on the GPU, and the card's roofline.

Used by ``chip_smoke.py`` and the bench of ``proto_conv_bn_fusion``.
"""

from __future__ import annotations

import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12     # H100 SXM TF32 on the tensor cores, dense


def bound_ms(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> float:
    """The least time the card could take: bytes over the memory rate or
    operations over their peak rate (float32 by default), whichever is
    larger."""
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def bound_by(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> str:
    """Which term sets :func:`bound_ms`: "bytes" or "operations"."""
    return "bytes" if nbytes / HBM_BYTES_PER_S >= ops / ops_per_s else "operations"


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"


def cuda_ms(fn, n_buffers: int, iters: int = 20, reps: int = 5) -> float:
    """Median per-call device time of fn(i), by CUDA events around the
    replay of a CUDA graph of ``iters`` calls that cycle through
    ``n_buffers`` input copies (so inputs come from device memory, not L2).
    The graph keeps the host's launch cost out of the time: a single small
    launch from Python takes longer on the host than on the card."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i % n_buffers)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i % n_buffers)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    times.sort()
    return times[len(times) // 2]


def copies_beyond_l2(nbytes: int) -> int:
    """Input copies whose total exceeds 4x the 50 MB L2 cache."""
    return max(2, -(-200_000_000 // max(nbytes, 1)))
