"""UNETR's whole MaxStyle step and its ViT importer in the port against
the JAX package.

* One ``make_train_step`` step of ``UnetTransformer_16_no_STN`` at the
  solver's width (ViT-B/16, hidden 768, 12 layers) on
  test_torch_port_train_step's batch (40^2 pads cropped to 32^2, effective
  batch 4) with MaxStyle n_iter=1 at hooks 3, 4, 5 of the image decoder (the
  FCN Decoder over the 768-channel bottom level), JAX's draws injected
  through ``overrides``, held at that module's bars: the losses, the
  weights after AdamW and the BatchNorm statistics.
* ``convert_unetr_vit``: the same seeded MONAI-layout ViT state dict through
  the JAX package's importer and ``convert.py``, and through the port's, bit
  for bit (the qkv columns' (qkv, head, dim) -> (head, qkv, dim)
  permutation included), and the result loads strictly into the UNETR
  encoder's ViT; a key the ViT has no counterpart for is refused.
* ``convert_module_state_dict`` refuses a UNETR network's modules with a
  ValueError that names ``convert_unetr_vit``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from maxstyle_tpu.utils import torch_import as jti
from maxstyle_tpu_torch import convert
from maxstyle_tpu_torch.models import unetr as tu
from maxstyle_tpu_torch.models.registry import parse_network_type
from maxstyle_tpu_torch.utils import torch_import as tti
from tests.test_torch_port_train_step import assert_port_step_matches, config, jax_step

torch.set_num_threads(2)


def test_one_unetr_step_with_maxstyle_matches_jax():
    base = config(n_iter=1)
    cfg = dataclasses.replace(base, segmentation_model=dataclasses.replace(
        base.segmentation_model, network_type="UnetTransformer_16_no_STN"))
    r = jax_step(cfg, init_cfg=cfg)
    assert r["metrics"]["loss/hard/total"] > 0
    assert_port_step_matches(r)


def monai_vit_sd(rng, hidden=48, mlp=96, layers=2, in_ch=1, patch=16, n_patch=4):
    """A seeded MONAI ViT state dict (qkv without bias, MONAI's default)."""
    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    sd = {"patch_embedding.patch_embeddings.weight": t(hidden, in_ch, patch, patch),
          "patch_embedding.patch_embeddings.bias": t(hidden),
          "patch_embedding.position_embeddings": t(1, n_patch, hidden),
          "norm.weight": t(hidden), "norm.bias": t(hidden)}
    for i in range(layers):
        p = f"blocks.{i}"
        sd.update({f"{p}.norm1.weight": t(hidden), f"{p}.norm1.bias": t(hidden),
                   f"{p}.norm2.weight": t(hidden), f"{p}.norm2.bias": t(hidden),
                   f"{p}.attn.qkv.weight": t(3 * hidden, hidden),
                   f"{p}.attn.out_proj.weight": t(hidden, hidden),
                   f"{p}.attn.out_proj.bias": t(hidden),
                   f"{p}.mlp.linear1.weight": t(mlp, hidden), f"{p}.mlp.linear1.bias": t(mlp),
                   f"{p}.mlp.linear2.weight": t(hidden, mlp), f"{p}.mlp.linear2.bias": t(hidden)})
    return sd


def test_vit_importer_is_bit_equal_to_the_jax_importer_and_convert():
    heads = 4
    sd = monai_vit_sd(np.random.RandomState(0))
    vit = tu.ViT(1, img_size=32, hidden_size=48, mlp_dim=96, num_layers=2, num_heads=heads)
    flax_params = jti.convert_unetr_vit({k: v.numpy() for k, v in sd.items()}, num_layers=2,
                                        num_heads=heads)
    want = convert.flax_to_state_dict(flax_params)
    got = tti.convert_unetr_vit(sd, num_layers=2, num_heads=heads)
    assert set(got) == set(want) == set(vit.state_dict())
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    # the permutation moved the columns: head h's q rows are MONAI's rows h*d..h*d+d
    d = 48 // heads
    q = sd["blocks.0.attn.qkv.weight"]
    for h in range(heads):
        rows = got["block0.attn.qkv.weight"][h * 3 * d:(h + 1) * 3 * d]
        assert torch.equal(rows[:d], q[h * d:(h + 1) * d])
        assert torch.equal(rows[2 * d:], q[2 * 48 + h * d:2 * 48 + (h + 1) * d])
    vit.load_state_dict(got, strict=True)
    enc = tu.UNETREncoder(1, img_size=32, feature_size=4, hidden_size=48, mlp_dim=96,
                          num_layers=10, num_heads=heads)
    enc.vit.load_state_dict(tti.convert_unetr_vit(
        monai_vit_sd(np.random.RandomState(1), layers=10), num_layers=10, num_heads=heads),
        strict=True)
    with pytest.raises(ValueError, match="no counterpart"):
        tti.convert_unetr_vit({**sd, "blocks.0.attn.qkv.bias": torch.zeros(144)},
                              num_layers=2, num_heads=heads)


@pytest.mark.parametrize("name", ["image_encoder", "segmentation_decoder", "image_decoder"])
def test_a_reference_unetr_module_is_refused_naming_the_vit_importer(name):
    spec = parse_network_type("UnetTransformer_enable_code_filter_16")
    with pytest.raises(ValueError, match="no importer for a reference UNETR checkpoint.*"
                                         "convert_unetr_vit"):
        tti.convert_module_state_dict({}, name, spec)
