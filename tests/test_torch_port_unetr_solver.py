"""The solver's UNETR bundles in the port against the JAX package.

``build_modules`` for every UNETR variant of the grammar at the solver's
width (ViT-B/16: hidden 768, 12 layers, 12 heads, MLP 3072; feature size
16) at 32^2, batch 2, from JAX's ``init_state`` converted: the
module kinds (the image decoder is a UnetDecoder over the pyramid for
``Unet_im_recon`` types, else the FCN Decoder over the 768-channel bottom
level), every converted leaf loaded strictly and used once, the solver's
``run`` in "train" mode (reconstruction, prediction and, with the STN, its
refinement) with the BatchNorm statistics it writes, and ``predict`` with
``n_iter=2``. Bars: test_torch_port_model's forwards and statistics (rtol
1e-4 / atol 5e-5), outputs with an absolute floor of 1e-4 of their largest
value.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu.config import (DataConfig, ExperimentConfig, LearningConfig,
                                 SegmentationModelConfig)
from maxstyle_tpu.solver import TripletSegmentationSolver as JSolver
from maxstyle_tpu_torch import config as tconfig
from maxstyle_tpu_torch import convert
from maxstyle_tpu_torch.models import unetr as tu
from maxstyle_tpu_torch.solver import TripletSegmentationSolver as TSolver
from tests.test_torch_port_unetr import FWD, close, nchw, to_np

torch.set_num_threads(2)

VARIANTS = ["UnetTransformer_16", "UnetTransformer_16_no_STN",
            "UnetTransformer_16_Unet_im_recon_no_STN", "UnetTransformer_enable_code_filter_16"]


def unetr_config(network_type, hw=32, n=2):
    return ExperimentConfig(
        data=DataConfig(crop_size=(hw, hw, 1), num_classes=4),
        segmentation_model=SegmentationModelConfig(network_type=network_type, num_classes=4),
        learning=LearningConfig(lr=1e-4, batch_size=n, optimizer_type="AdamW"))


def n_leaves(tree):
    return len(jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("network_type", VARIANTS)
def test_build_modules_of_every_variant_matches_jax(network_type):
    from maxstyle_tpu_torch.models.encoder_decoder import Decoder
    from maxstyle_tpu_torch.models.unet import UnetDecoder

    cfg = unetr_config(network_type)
    js = JSolver(cfg)
    state = js.init_state(jax.random.key(0), (32, 32), batch_size=2)
    params, stats = to_np(state.params), to_np(state.batch_stats)
    ts = TSolver(tconfig.ExperimentConfig.from_dict(dataclasses.asdict(cfg)), device="cpu")
    nets = ts.build_modules()
    assert isinstance(nets["image_encoder"], tu.UNETREncoder)
    assert isinstance(nets["segmentation_decoder"], tu.UNETRDecoder)
    assert isinstance(nets["image_decoder"],
                      UnetDecoder if "Unet_im_recon" in network_type else Decoder)
    assert ("shape_encoder" in nets) == ("no_STN" not in network_type)
    vit = nets["image_encoder"].vit
    assert (vit.num_layers, vit.block0.attn.head_dim, vit.block0.linear1.out_features) == (
        12, 64, 3072)
    sds = convert.convert_train_state(params, stats)
    for name, module in nets.items():
        # every flax leaf is converted once, and the module takes them all
        assert len(sds[name]) == n_leaves(params[name]) + n_leaves(stats.get(name, {})), name
        module.load_state_dict(sds[name], strict=True)

    x = np.random.RandomState(1).rand(2, 32, 32, 1).astype(np.float32)
    recon, y0, refined, new_stats = jax.jit(lambda p, s, xx: js.run(p, s, xx, mode="train"))(
        params, stats, jnp.asarray(x))
    t_recon, t_y0, t_refined = ts.run(nets, nchw(x), mode="train")
    for t, j in ((t_recon, recon), (t_y0, y0), (t_refined, refined)):
        close(t, np.asarray(j).transpose(0, 3, 1, 2), FWD["rtol"], 1e-4)
    want = convert.convert_train_state(params, to_np(new_stats))
    for name, module in nets.items():
        sd = module.state_dict()
        for k, w in want[name].items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(sd[k].numpy(), w.numpy(), err_msg=f"{name}.{k}",
                                           **FWD)
    jpred = jax.jit(lambda p, s, xx: js.predict(p, s, xx, n_iter=2))(params, new_stats,
                                                                     jnp.asarray(x))
    close(ts.predict(nets, torch.from_numpy(x), n_iter=2), jpred, FWD["rtol"], 1e-4)
