"""Whole training steps of RandConv against the JAX package's, in both
view-BatchNorm modes: "frozen" (the default: the views write no running
statistics) and "train" (each view updates them, in turn, as the
reference does). The recipe and the bars are those of
tests/torch_port_branch_steps.py.
"""

import pytest
import torch

from tests.torch_port_branch_steps import check_branch_step

torch.set_num_threads(2)


@pytest.mark.parametrize("view_bn", ["frozen", "train"])
def test_rand_conv_step_matches_jax(view_bn):
    check_branch_step("rand_conv", randconv_view_bn=view_bn)
