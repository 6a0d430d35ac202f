"""The port's Swin-UNETR family (``models/swin_unetr.py``) against the plain
reference ``tests/swin_unetr_reference.py``, which computes each block's
attention as one dense attention over the whole padded, rolled grid.

At feature 12, heads (3, 6, 12, 24), window 7, crop 64, batch 2, in
float64, from seeded random weights (bias tables, LayerNorm and BatchNorm
affines included): stage 1 runs a 32^2 grid padded to 35^2, stages 1-3
shift every second block under masks, stage 4's 4^2 grid is one window of
4 with no shift (and MONAI's truncated bias index). The logits, the
reconstruction of the FCN image decoder over the 1/16 level and the
gradients of every parameter and of the input agree within 1e-10 of each
tensor's largest value; in float32 the forward agrees within FLOAT32_TOL.
Beside it: the merge order, the buffers, the spans, the grammar (and its
refusals), and one fused MaxStyle step of ``SwinUNETR_16_no_STN`` through
``init_state`` and ``make_fused_train_step``.
"""

from __future__ import annotations

import pytest
import torch

from maxstyle_tpu_torch.models import swin_unetr as S
from maxstyle_tpu_torch.models.encoder_decoder import Decoder
from tests import swin_unetr_reference as R

FEAT, CROP, BATCH = 12, 64, 2
F64_TOL = 1e-10
# float32 against the float64 reference: round-off compounds through eight
# Swin blocks, four merges and up to ten BatchNorm'd conv blocks (each
# dividing by a spread computed in float32); the float32 port reads 1.2e-6
# (logits) and 2.0e-6 (reconstruction) of the largest value here, so 2e-5
# leaves ten times that, while running the shifted blocks unshifted moves
# both by more than 0.3.
FLOAT32_TOL = 2e-5


def build(seed: int = 0, dtype=torch.float64):
    torch.manual_seed(seed)
    nets = torch.nn.ModuleDict({
        "image_encoder": S.SwinUNETREncoder(1, CROP, feature_size=FEAT),
        "segmentation_decoder": S.SwinUNETRDecoder(4, feature_size=FEAT),
        "image_decoder": Decoder(8 * FEAT, 1, 4, up_type="Conv2", last_act="sigmoid")})
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in nets.named_parameters():
            base = 1.0 if name.endswith("norm1.weight") or name.endswith("norm2.weight") \
                or name.endswith("norm.weight") else 0.0
            scale = 0.5 if "relative_position_bias_table" in name else 0.1
            if p.dim() > 1 and "relative_position_bias_table" not in name:
                scale = (1.0 / p[0].numel()) ** 0.5
            p.copy_(base + scale * torch.randn(p.shape, generator=g))
    return nets.to(dtype)


def table(nets):
    return {f"{m}.{k}": v for m, mod in nets.items() for k, v in mod.named_parameters()}


def port_forward(nets, x, mode="train"):
    z = nets["image_encoder"].encode(x, mode)
    return nets["segmentation_decoder"](z, mode), nets["image_decoder"](z[4], mode)


def rel(a, b, floor: float = 0.0):
    """The largest gap over the larger of the largest reference value and
    ``floor``."""
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max() / max(float(b.abs().max()), floor))


@pytest.fixture(scope="module")
def pair():
    nets = build()
    x = torch.rand((BATCH, 1, CROP, CROP), generator=torch.Generator().manual_seed(7),
                   dtype=torch.float64)
    return nets, x


def test_the_stages_take_the_cases_the_tests_need(pair):
    nets, _ = pair
    trunk = nets["image_encoder"].swinViT
    got = []
    for i in range(1, 5):
        layer = getattr(trunk, f"layers{i}")[0]
        got.append([(b.window, b.shift) for b in layer.blocks]
                   + [None if layer.attn_mask is None else tuple(layer.attn_mask.shape)])
    assert got == [[(7, 0), (7, 3), (25, 49, 49)],  # 32^2 padded to 35^2
                   [(7, 0), (7, 3), (9, 49, 49)],
                   [(7, 0), (7, 3), (4, 49, 49)],
                   [(4, 0), (4, 0), None]]  # grid 4 <= window: one window, no shift
    assert trunk.layers4[0].blocks[0].attn.relative_position_bias_table.shape == (169, 24)


def test_forward_and_gradients_match_the_dense_reference(pair):
    nets, x = pair
    x = x.clone().requires_grad_(True)
    g = torch.Generator().manual_seed(3)
    w_seg = torch.randn((BATCH, 4, CROP, CROP), generator=g, dtype=torch.float64)
    w_rec = torch.randn((BATCH, 1, CROP, CROP), generator=g, dtype=torch.float64)
    params = dict(nets.named_parameters())

    logits, recon = port_forward(nets, x)
    grads = torch.autograd.grad((logits * w_seg).sum() + (recon * w_rec).sum(),
                                [x] + list(params.values()))

    P = {k: v.detach().clone().requires_grad_(True) for k, v in table(nets).items()}
    xr = x.detach().clone().requires_grad_(True)
    r_logits, r_recon = R.forward(P, xr)
    r_grads = torch.autograd.grad((r_logits * w_seg).sum() + (r_recon * w_rec).sum(),
                                  [xr] + [P[k] for k in params])

    assert rel(logits, r_logits) < F64_TOL
    assert rel(recon, r_recon) < F64_TOL
    # The bias of a convolution followed by a batch-statistics BatchNorm has
    # a gradient of 0, which both sides compute as round-off: those are held
    # to be under a millionth of the largest gradient, every other gradient
    # to the reference within F64_TOL of its own largest value.
    names = ["input"] + list(params)
    before_bn = [n.endswith((".conv1.bias", ".conv2.bias")) for n in names]
    top = max(float(g.abs().max()) for g in r_grads)
    bad = {n: rel(a, b) for n, a, b, z in zip(names, grads, r_grads, before_bn)
           if not z and not rel(a, b) < F64_TOL}
    assert not bad, bad
    assert sum(before_bn) == 28  # 5 + 5 conv blocks and 4 FCN up blocks, two each
    assert all(max(float(a.abs().max()), float(b.abs().max())) < 1e-6 * top
               for a, b, z in zip(grads, r_grads, before_bn) if z)


def test_float32_forward_within_its_tolerance(pair):
    nets, x = pair
    logits, recon = port_forward(build(dtype=torch.float32), x.float())
    r_logits, r_recon = R.forward(table(nets), x)
    assert rel(logits.double(), r_logits) < FLOAT32_TOL
    assert rel(recon.double(), r_recon) < FLOAT32_TOL


def test_merge_concatenates_monais_phases_in_order():
    merge = S.PatchMerging(2).double()
    seen = {}
    merge.norm.register_forward_hook(lambda m, inp, out: seen.update(x=inp[0]))
    x = torch.arange(2 * 4 * 6 * 2, dtype=torch.float64).reshape(2, 4, 6, 2)
    out = merge(x)
    assert out.shape == (2, 2, 3, 4)
    want = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                     dim=-1)
    assert torch.equal(seen["x"], want)
    assert seen["x"][0, 0, 0].tolist() == [0, 1, 12, 13, 2, 3, 14, 15]


def test_buffers_are_built_once_outside_the_state_dict():
    enc = S.SwinUNETREncoder(1, CROP, feature_size=FEAT)
    names = {k for k, _ in enc.named_buffers()}
    assert "swinViT.layers1.0.attn_mask" in names
    assert "swinViT.layers1.0.blocks.0.attn.relative_position_index" in names
    assert not any("attn_mask" in k or "relative_position_index" in k
                   for k in enc.state_dict())
    mask = enc.swinViT.layers1[0].attn_mask
    assert set(mask.unique().tolist()) == {S.MASK_VALUE, 0.0}
    assert enc.double().swinViT.layers1[0].attn_mask.dtype == torch.float64
    idx = S.relative_position_index(7)
    assert idx.shape == (49, 49) and int(idx.min()) == 0 and int(idx.max()) == 168
    assert int(idx[0, 48]) == 0 and int(idx[48, 0]) == 168 and int(idx[24, 24]) == 84


@pytest.mark.parametrize("img_size, hw", [(48, (48, 48)), (64, (32, 32)), (64, (64, 32))])
def test_other_crops_raise(img_size, hw):
    with pytest.raises(ValueError, match="multiple of 32"):
        S.check_square_crop(img_size, hw)
    if img_size % 32:
        with pytest.raises(ValueError, match="multiple of 32"):
            S.SwinUNETREncoder(1, img_size, feature_size=6)
    else:
        enc = S.SwinUNETREncoder(1, img_size, feature_size=6)
        with pytest.raises(ValueError, match="multiple of 32"):
            enc.encode(torch.rand((1, 1) + hw), "train")


def test_the_trunk_opens_its_spans():
    from torch.profiler import ProfilerActivity, profile
    enc = S.SwinUNETREncoder(1, 32, feature_size=6)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        enc.encode(torch.rand(2, 1, 32, 32), "train")
    names = [e.name for e in prof.events() if e.name.startswith("maxstyle/swin/")]
    assert sorted(set(names)) == ["maxstyle/swin/stage1", "maxstyle/swin/stage2",
                                  "maxstyle/swin/stage3", "maxstyle/swin/stage4",
                                  "maxstyle/swin/window_attention"]
    assert names.count("maxstyle/swin/window_attention") == 8


# ---------------------------------------------------------------------------
# the grammar and the solver
# ---------------------------------------------------------------------------


def test_the_prefix_builds_swin_unetr_and_not_the_fcn_bundle():
    from maxstyle_tpu_torch.models.encoder_decoder import DualBranchEncoder
    from maxstyle_tpu_torch.models.registry import build_modules, parse_network_type
    spec = parse_network_type("SwinUNETR_16_no_STN")
    assert spec.is_swin_unetr and not spec.is_unet and not spec.is_transformer
    assert spec.feature_reduce == 4 and not spec.has_stn and spec.has_image_recon
    nets = build_modules(spec, image_size=32)
    assert set(nets) == {"image_encoder", "segmentation_decoder", "image_decoder"}
    assert not isinstance(nets["image_encoder"], DualBranchEncoder)
    assert isinstance(nets["image_encoder"], S.SwinUNETREncoder)
    assert nets["image_decoder"].up1.conv1.in_channels == 384
    assert not parse_network_type("FCN_16_standard_no_STN").is_swin_unetr
    assert not parse_network_type("UnetTransformer_16_no_STN").is_swin_unetr


@pytest.mark.parametrize("network_type", ["SwinUNETR_16", "SwinUNETR_16_w_image",
                                          "SwinUNETR_64_no_STN",
                                          "SwinUNETR_enable_code_filter_16_no_STN",
                                          "SwinUNETR_16_share_code_no_STN"])
def test_unsupported_variants_raise(network_type):
    from maxstyle_tpu_torch.models.registry import parse_network_type
    with pytest.raises(NotImplementedError, match="SwinUNETR"):
        parse_network_type(network_type)


def test_the_importers_refuse_the_family():
    from maxstyle_tpu_torch.models.registry import parse_network_type
    from maxstyle_tpu_torch.utils.torch_import import convert_module_state_dict
    spec = parse_network_type("SwinUNETR_16_no_STN")
    for module_name in ("image_encoder", "segmentation_decoder", "image_decoder"):
        with pytest.raises(ValueError, match="Swin-UNETR"):
            convert_module_state_dict({}, module_name, spec)


def test_a_fused_maxstyle_step_changes_every_module():
    from maxstyle_tpu_torch.config import (DataConfig, ExperimentConfig, LearningConfig,
                                           MaxStyleConfig, SegmentationModelConfig)
    from maxstyle_tpu_torch.data import augment as A
    from maxstyle_tpu_torch.solver import TripletSegmentationSolver
    from maxstyle_tpu_torch.train_step import make_fused_train_step
    cfg = ExperimentConfig(
        data=DataConfig(crop_size=(32, 32, 1), pad_size=(40, 40, 1), num_classes=4),
        segmentation_model=SegmentationModelConfig(network_type="SwinUNETR_16_no_STN",
                                                   num_classes=4),
        learning=LearningConfig(lr=1e-4, batch_size=4, optimizer_type="AdamW",
                                max_style=True),
        max_style=MaxStyleConfig(n_iter=1, decoder_layers_indexes=(3, 4, 5)))
    solver = TripletSegmentationSolver(cfg, device="cpu")
    state = solver.init_state(seed=1)
    before = {n: [p.detach().clone() for p in m.parameters()]
              for n, m in state.modules.items()}
    step = make_fused_train_step(solver, A.get_policy("ACDC_affine_elastic_intensity",
                                                      (40, 40), (32, 32)), keep_orig=True)
    g = torch.Generator().manual_seed(2)
    raw = {"image": torch.rand((2, 40, 40), generator=g),
           "label": torch.randint(0, 4, (2, 40, 40), generator=g, dtype=torch.int32)}
    state, metrics = step(state, raw, torch.Generator().manual_seed(5))
    assert torch.isfinite(metrics["loss/total"])
    z = solver.encode_image(state.modules, torch.rand(2, 1, 32, 32), mode="eval")
    assert tuple(z[0].shape) == (2, 384, 2, 2) and len(z[1]) == 6
    for name, module in state.modules.items():
        moved = [not torch.equal(a, b) for a, b in zip(module.parameters(), before[name])]
        assert any(moved), name
    trunk = dict(state.modules["image_encoder"].named_parameters())
    start = dict(zip(trunk, before["image_encoder"]))
    still = [k for k, p in trunk.items() if k.startswith("swinViT") and torch.equal(p, start[k])]
    assert not still, still
