"""The NGF reconstruction loss (``learning.rec_loss_type="ngf"``) inside
whole training steps, the port against the JAX package at float32.

The passes that reach ``image_recon_loss``: the standard pass and the
MaxStyle hard-example pass (one step at n_iter=1 on
tests/test_torch_port_train_step.py's batch and draws), and the three
branch passes (RSC's masked-code reconstruction, MixStyle's replayed code,
RandConv's three views; tests/torch_port_branch_steps.py, JAX's draws
injected). Held at those modules' bars (``assert_port_step_matches``):
standard losses rtol 1e-4, hard-example and branch losses rtol 2e-3,
weights within 2.1*lr + 1e-6 and the update cosines > 0.95, statistics
rtol 1e-4. The reconstruction terms must be non-zero (1 - NCC lies in
[0, 2]).
"""

import dataclasses

import pytest
import torch

from tests.test_torch_port_train_step import assert_port_step_matches, config, jax_step
from tests.torch_port_branch_steps import check_branch_step

torch.set_num_threads(2)


def test_ngf_in_the_standard_and_maxstyle_passes():
    base = config(n_iter=1)
    cfg = dataclasses.replace(base, learning=dataclasses.replace(base.learning,
                                                                 rec_loss_type="ngf"))
    r = jax_step(cfg)
    image = r["metrics"]["loss/standard/image"]
    assert 0.0 < image <= 2.0 and r["metrics"]["loss/hard/image"] > 0.0
    assert_port_step_matches(r)


@pytest.mark.parametrize("flag", ["RSC", "mix_style", "rand_conv"])
def test_ngf_in_the_branch_passes(flag):
    r = check_branch_step(flag, rec_loss_type="ngf")
    assert r["metrics"]["loss/standard/image"] > 0.0
