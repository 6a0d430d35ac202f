"""The comparison that decides ``correct``.

The numbers, each the program's checked steps against the reference's:

* ``loss_gap``: the largest relative gap, over the steps, of the total loss;
  ``first_loss_gap`` the first step's; ``std_loss_gap`` the standard pass's;
  ``first_std_loss_gap`` the first step's standard pass's, which no inner
  loop has touched yet, and ``first_std_parts_gap`` the larger of its
  segmentation and image losses' (a gap of their sum can cancel);
* ``grad_gap`` / ``grad_gap_median``: the first step's gradient, as the
  program's AdamW holds it after that step (its first moment over
  1 - beta1), by the worst / the median leaf of |norm(program) -
  norm(reference)| over the larger of the reference leaf's norm and the
  median leaf's;
* ``change_gap`` / ``change_gap_median``: the same of each leaf's change
  over the steps. Leaves whose reference gradient is under a thousandth of
  the median leaf's move by round-off alone under Adam and are left out.

A cell compares those its ``limits/<cell>.json`` names; a number that is
not finite fails.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable

GRAD_FLOOR = 1e-3  # a leaf under this share of the median gradient is left out of the change


def loss_gap(program: Iterable[float], reference: Iterable[float]) -> float:
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(program, reference))


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              keep: Iterable[str]) -> list:
    keep = [k for k in keep]
    med = statistics.median(reference[k] for k in keep)
    return [abs(program[k] - reference[k]) / max(reference[k], med, 1e-30) for k in keep]


def gaps(program: dict, reference: dict) -> Dict[str, float]:
    """program / reference: {"loss": [...], "std_loss": [...], "std_parts":
    [[segmentation, image], ...], "grad_norm": {leaf: norm}, "change_norm":
    {leaf: norm}}, by step where a list."""
    g_ref = reference["grad_norm"]
    if set(program["grad_norm"]) != set(g_ref) or set(program["change_norm"]) != set(g_ref):
        missing = set(g_ref) ^ set(program["grad_norm"]) | set(g_ref) ^ set(program["change_norm"])
        raise ValueError(f"the program's leaves differ from the reference's: "
                         f"{sorted(missing)[:5]}")
    med = statistics.median(g_ref.values())
    moving = [k for k, v in g_ref.items() if v >= GRAD_FLOOR * med]
    grad = leaf_gaps(program["grad_norm"], g_ref, g_ref)
    change = leaf_gaps(program["change_norm"], reference["change_norm"], moving)
    return {"loss_gap": loss_gap(program["loss"], reference["loss"]),
            "first_loss_gap": loss_gap(program["loss"][:1], reference["loss"][:1]),
            "std_loss_gap": loss_gap(program["std_loss"], reference["std_loss"]),
            "first_std_loss_gap": loss_gap(program["std_loss"][:1], reference["std_loss"][:1]),
            "first_std_parts_gap": loss_gap(program["std_parts"][0], reference["std_parts"][0]),
            "grad_gap": max(grad), "grad_gap_median": statistics.median(grad),
            "change_gap": max(change), "change_gap_median": statistics.median(change)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
