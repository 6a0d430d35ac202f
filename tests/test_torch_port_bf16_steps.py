"""One MaxStyle step (n_iter=2) of each network family under the bf16
compute policy, the port against the JAX package: FCN_16_standard_no_STN,
FCN_16_standard (the STN), DS_FCN_16_standard, Unet_16_Unet_im_recon_no_STN
and UnetTransformer_16_no_STN (UNETR with its ViT-B/16 at 32^2: 4 tokens
an image), at hw 32, effective batch 4, from JAX's seed-0 weights, with the
style draws pinned. Every loss term, each module's gradients and its
BatchNorm statistics are held at test_torch_port_bf16.py's bar: within
BAR_FACTOR (4) times JAX's own bf16 distance from the float64 reference
plus FLOOR (2^-8) of the reference's largest value.
"""

import pytest
import torch

from tests.test_torch_port_bf16 import FAMILIES, assert_step_matches, config, jax_bf16_step

torch.set_num_threads(2)


@pytest.mark.parametrize("network_type", FAMILIES)
def test_bf16_maxstyle_step_matches_jax_within_bar(network_type):
    r = jax_bf16_step(config(network_type))
    assert r["metrics"]["loss/hard/total"] > 0
    assert_step_matches(r)
