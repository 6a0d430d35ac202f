"""The seven method branches under the bf16 compute policy, the port against
the JAX package.

One step of each branch config of tests/torch_port_branch_steps.py
(FCN_16_standard_no_STN, 40^2 -> 32^2, effective batch 4, AdamW) with
``compute_dtype="bfloat16"``: JAX's bf16 step, its draws rebuilt from its
key chain and given to the port's bf16 step and to the float64 reference
(the port under the float32 policy with float64 modules). The bar is
test_torch_port_bf16.py's: every loss, each module's gradients and BatchNorm
statistics within BAR_FACTOR (4) times JAX's own distance from the
reference plus FLOOR (2^-8) of the reference's largest value. The branch
ops (LSM and RSC masks, MixStyle/DSU, RandConv, AdvNoise, AdvBias) see the
bf16 activations that the JAX step gives them.
"""

import pytest
import torch

from tests.test_torch_port_bf16 import assert_step_matches, jax_bf16_step
from tests.torch_port_branch_steps import branch_config, jax_branch_draws

torch.set_num_threads(2)

CHANNEL = {"latent_DA": "loss/hard/total", "RSC": "loss/hard/RSC",
           "mix_style": "loss/hard/mix_style", "DSU": "loss/hard/DSU",
           "rand_conv": "loss/hard/rand_conv", "adv_noise": "loss/hard/adv_noise",
           "adv_bias": "loss/hard/adv_bias"}


@pytest.mark.parametrize("flag", sorted(CHANNEL))
def test_bf16_branch_step_matches_jax_within_bar(flag):
    r = jax_bf16_step(branch_config(flag, compute_dtype="bfloat16"))
    assert r["metrics"][CHANNEL[flag]] != 0.0
    assert_step_matches(r, {flag: jax_branch_draws(r, flag)})
