"""The Swin blocks' window attention against its roofline: the summed
bound time of the traced ``maxstyle/swin/window_attention`` spans over
their summed traced device time, in %.

The spans are grouped by the stage span they run in (``swin/stage{k}``).
A call's bound is the larger of its bytes at 3.35 TB/s and its operations
at 67 TFLOP/s (``roofline.bound_s``, the kernel table's rule), from the
shapes alone, whatever implements the attention: read the normed tokens
and write the output (padded windows x w^2 tokens x C, float32), read the
``qkv`` and ``proj`` weights and biases, the bias table and, in a shifted
block, the mask; 2 Nw w^2 (4 C^2) operations in the two projections and
4 Nw w^4 C in the two products of the scores, for Nw windows of w^2
tokens. The stage's blocks alternate unshifted and shifted, so a call's
bound is the mean of the stage's blocks'. The widths are the network
family's (``FEAT``, ``HEADS``, ``DEPTHS``, ``WINDOW``); nothing without a
trace, without such spans, or for a family without them. The time is
placed as ``swin_trunk_ms`` places its work."""

import re

from perfbench.roofline import bound_s
from perfbench.spans import PATH_SEP

SPAN = "swin/window_attention"
STAGE = re.compile(r"swin/stage(\d+)")


def call_bound_s(batch: int, crop: int, stage: int, shifted: bool, feat: int, heads: int,
                 window: int) -> float:
    """One block's window attention at ``stage`` (1-4) of a batch of
    ``crop``^2 slices behind a stride-2 patch."""
    grid = crop >> stage
    ws, shift = (grid, False) if grid <= window else (window, shifted)
    per_side = -(-grid // ws)
    nw = batch * per_side ** 2
    n = ws * ws
    c = feat * 2 ** (stage - 1)
    values = (2 * nw * n * c + 4 * c * c + 4 * c + (2 * window - 1) ** 2 * heads
              + (per_side ** 2 * n * n if shift else 0))
    ops = 2 * nw * n * 4 * c * c + 4 * nw * n * n * c
    return bound_s(4 * values, ops)


def stage_bound_s(batch: int, crop: int, stage: int, net) -> float:
    """The mean bound of a call at ``stage``, over its blocks."""
    m = net.module
    depth = m.DEPTHS[stage - 1]
    return sum(call_bound_s(batch, crop, stage, j % 2 == 1, m.FEAT, m.HEADS[stage - 1],
                            m.WINDOW) for j in range(depth)) / depth


def read(run):
    spans = (run.get("trace") or {}).get("spans")
    if spans is None:
        return None
    net = run["cell"].net()
    if not all(hasattr(net.module, k) for k in ("FEAT", "HEADS", "DEPTHS", "WINDOW")):
        return None
    bound = secs = 0.0
    for path, row in spans["paths"].items():
        names = path.split(PATH_SEP)
        stages = [int(m.group(1)) for m in map(STAGE.fullmatch, names) if m]
        if names[-1] != SPAN or not stages:
            continue
        bound += row["calls"] * stage_bound_s(run["slices_per_step"], run["crop"], stages[-1],
                                              net)
        secs += 1e-3 * row["busy_ms"]
    if secs <= 0:
        return None
    return 100.0 * bound / secs
