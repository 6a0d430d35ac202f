"""The method branches' STN terms in the port against the JAX package: one
whole ``make_train_step`` step of RSC, MixStyle and RandConv on
FCN_16_standard, each with the draws JAX made rebuilt from its key chain
(``tests/torch_port_branch_steps.py``), at tests/test_torch_port_train_step's
bars. RSC refines both masked-code predictions, MixStyle the replayed
prediction and RandConv each view's (a KL of the refined predictions)."""

import dataclasses

import pytest

from tests.test_torch_port_train_step import assert_port_step_matches
from tests.torch_port_branch_steps import branch_config, jax_branch_draws, jax_branch_step

CHANNEL = {"RSC": "loss/hard/RSC", "mix_style": "loss/hard/mix_style",
           "rand_conv": "loss/hard/rand_conv"}


@pytest.mark.parametrize("flag", ["RSC", "mix_style", "rand_conv"])
def test_branch_step_on_the_stn_matches_jax(flag):
    base = branch_config(flag)
    cfg = dataclasses.replace(base, segmentation_model=dataclasses.replace(
        base.segmentation_model, network_type="FCN_16_standard"))
    r = jax_branch_step(cfg)
    assert r["metrics"][CHANNEL[flag]] != 0.0
    assert_port_step_matches(r, {"branch_draws": {flag: jax_branch_draws(r, flag)}})
