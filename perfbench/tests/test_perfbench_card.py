"""On the card, at each cell's own size: the program's checked steps pass
the cell's limits on three seeds, and each of the TF32 control, the
program itself with TF32 on and the half-batch fault fails one of them.
Run with ``python3 -m pytest perfbench/tests -m card`` on a machine with
one H100."""

from __future__ import annotations

import pytest

import perfbench_helpers  # noqa: F401  (puts the checkout on the path)

CELLS = ("fcn16_acdc.maxstyle", "unetr_acdc.maxstyle")


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_limits_on_the_card(name):
    from perfbench import check
    from perfbench.calibrate import calibrate
    from perfbench.manifest import load_cell
    cell = load_cell(name)
    for seed in (101, 102, 103):
        r = calibrate(cell, seed, "cuda")
        assert check.verdict(r["program"], cell.limits), (seed, r["program"])
        for wrong in ("control_tf32", "program_tf32", "fault_half_batch"):
            assert not check.verdict(r[wrong], cell.limits), (seed, wrong, r[wrong])
