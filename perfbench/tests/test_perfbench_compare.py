"""The comparison that decides ``correct``, on the CPU at a small size: the
port's step (its plain CPU paths) agrees with the reference within the
cell's limits, and the reference run in bfloat16 in the program's place
fails one of them."""

from __future__ import annotations

import pytest

from perfbench_helpers import tiny_cell


@pytest.mark.parametrize("name", ["fcn16_acdc.maxstyle", "unetr_acdc.maxstyle"])
def test_program_agrees_and_bf16_fails(name):
    from perfbench import check
    from perfbench.calibrate import calibrate
    cell = tiny_cell(name)
    r = calibrate(cell, 21, "cpu", control="bfloat16")
    assert check.verdict(r["program"], cell.limits), r["program"]
    assert not check.verdict(r["control_bfloat16"], cell.limits), r["control_bfloat16"]
    assert not check.verdict(r["fault_half_batch"], cell.limits), r["fault_half_batch"]
