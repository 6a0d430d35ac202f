"""Whole training steps of AdvNoise and AdvBias (ACDC's downscale 2) against the JAX package's.

The recipe and the bars are those of tests/torch_port_branch_steps.py.
"""

import pytest
import torch

from tests.torch_port_branch_steps import check_branch_step

torch.set_num_threads(2)


@pytest.mark.parametrize("flag", ["adv_noise", "adv_bias"])
def test_branch_step_matches_jax(flag):
    check_branch_step(flag)
