"""A whole run, less the look for a card, on the CPU at a small size, with
the timed path broken underneath: ``correct`` comes out false for each
fault a one-chip training cell can have, and true without one."""

from __future__ import annotations

import time

import pytest
import torch

from perfbench_helpers import tiny_cell

CELLS = ("fcn16_acdc.maxstyle",)


def _correct(cell) -> bool:
    from perfbench import harness, run
    r = harness.run_cell(cell, 11, 0.2, False, "cpu", time.perf_counter())
    return run.result(cell, r, False)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    assert _correct(tiny_cell(name))


@pytest.mark.parametrize("name", CELLS)
def test_state_left_unchanged(name, monkeypatch):
    """AdamW steps its moments but every parameter keeps its value."""
    step = torch.optim.AdamW.step

    def unchanged(self, *a, **k):
        saved = [p.detach().clone() for g in self.param_groups for p in g["params"]]
        out = step(self, *a, **k)
        with torch.no_grad():
            for p, s in zip((p for g in self.param_groups for p in g["params"]), saved):
                p.copy_(s)
        return out

    monkeypatch.setattr(torch.optim.AdamW, "step", unchanged)
    assert not _correct(tiny_cell(name))


@pytest.mark.parametrize("name", CELLS)
def test_half_the_batch_left_out(name, monkeypatch):
    """Every loss is the mean over the first half of the batch."""
    from maxstyle_tpu_torch import losses
    ce, rec = losses.cross_entropy_2d, losses.image_recon_loss

    def half(x):
        return x[: x.shape[0] // 2]

    monkeypatch.setattr(losses, "cross_entropy_2d",
                        lambda logits, target, *a, **k: ce(half(logits), half(target), *a, **k))
    monkeypatch.setattr(losses, "image_recon_loss",
                        lambda pred, target, *a, **k: rec(half(pred), half(target), *a, **k))
    assert not _correct(tiny_cell(name))
