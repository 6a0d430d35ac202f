"""The port's reference ``.pth`` import (``maxstyle_tpu_torch/utils/torch_import.py``)
against the JAX package's import followed by ``convert.py``.

State dicts in the reference's naming are synthesized from a numpy seed (no
pretrained encoder ships with the reference), as
``tests/test_torch_import_encoder.py`` does: the dual-branch encoder, the
segmentation decoder (NN) and the image decoder (Conv2 transposed convs),
each with ``num_batches_tracked`` buffers. Checked:

* the port's state dict equals ``convert.flax_to_state_dict`` of the JAX
  import bit for bit (the JAX import flips the transposed-conv taps and
  convert.py flips them back, so both equal the file's tensors);
* the imported modules' eval-mode forwards against the JAX package's on the
  same imported weights, at test_torch_port_model's tolerances (rtol 1e-4,
  atol 5e-5 on O(1) values, here scaled to each output's largest value);
* ``import_snapshot``, the dropped ``num_batches_tracked``, a key with no
  counterpart, a pickled module, and a reference UNETR module, which has
  no converter in the JAX package either, raising a ValueError that names
  the ViT's importer ``convert_unetr_vit`` (tests/test_torch_port_unetr_step.py);
* every other family's converter (DS_FCN's encoder with its spectral-norm
  vectors, the STN's shape encoder and decoder, the Unet encoders with and
  without code filters and decoders with bilinear and Conv2 ups, the
  baseline FCN): bit for bit as the JAX import followed by ``convert.py``,
  holding exactly the file's tensors, loaded strictly;
* the training CLI's ``--torch_ckpt_dir``: the weights before its first
  step are the files' tensors.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu.config import (DataConfig, ExperimentConfig, LearningConfig,
                                 SegmentationModelConfig)
from maxstyle_tpu.solver import TripletSegmentationSolver as JSolver
from maxstyle_tpu.utils import torch_import as jti
from maxstyle_tpu_torch import config as tconfig
from maxstyle_tpu_torch import convert, train
from maxstyle_tpu_torch.models.registry import parse_network_type
from maxstyle_tpu_torch.solver import TripletSegmentationSolver as TSolver
from maxstyle_tpu_torch.utils import torch_import as tti
from tests.test_torch_import_encoder import bn_entries, conv_entries, make_encoder_sd

torch.set_num_threads(2)

HW, N, R = 32, 2, 4
FWD = dict(rtol=1e-4, atol=5e-5)


def make_decoder_sd(rng, up_type, out_ch, r=R, in_ch=128):
    """A MyDecoder state dict in the reference's naming (up{i}.up for Conv2,
    up{i}.conv.0/1/3/4, up{i}.conv_input, final_conv)."""
    sd = {}
    chans = [in_ch, 256 // r, 128 // r, 64 // r, 64 // r]
    for i in range(1, 5):
        cin, cout = chans[i - 1], chans[i]
        if up_type == "Conv2":
            sd[f"up{i}.up.weight"] = torch.from_numpy(
                rng.randn(cin, cin, 2, 2).astype(np.float32) * 0.1)
            sd[f"up{i}.up.bias"] = torch.from_numpy(rng.randn(cin).astype(np.float32) * 0.1)
        conv_entries(rng, sd, f"up{i}.conv.0", cin, cout, 3)
        bn_entries(rng, sd, f"up{i}.conv.1", cout)
        conv_entries(rng, sd, f"up{i}.conv.3", cout, cout, 3)
        bn_entries(rng, sd, f"up{i}.conv.4", cout)
        conv_entries(rng, sd, f"up{i}.conv_input", cin, cout, 1)
    conv_entries(rng, sd, "final_conv", chans[4], out_ch, 1)
    return sd


def with_batch_counts(sd):
    out = dict(sd)
    for k in sd:
        if k.endswith(".running_mean"):
            out[k.replace("running_mean", "num_batches_tracked")] = torch.tensor(123)
    return out


def reference_files(seed=0, num_classes=4):
    """{module: reference state dict} of FCN_16_standard_no_STN."""
    rng = np.random.RandomState(seed)
    return {"image_encoder": with_batch_counts(make_encoder_sd(rng)),
            "segmentation_decoder": with_batch_counts(make_decoder_sd(rng, "NN", num_classes)),
            "image_decoder": with_batch_counts(make_decoder_sd(rng, "Conv2", 1))}


def jax_import(name, sd):
    return jti.convert_module_state_dict({k: v.numpy() for k, v in sd.items()}, name)


@pytest.fixture(scope="module")
def files():
    return reference_files()


@pytest.mark.parametrize("name", ["image_encoder", "segmentation_decoder", "image_decoder"])
def test_import_equals_the_jax_import_and_convert_bit_for_bit(files, name):
    sd = files[name]
    ours = tti.convert_module_state_dict(sd, name)
    theirs = convert.flax_to_state_dict(*jax_import(name, sd))
    assert set(ours) == set(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype == torch.float32
        assert torch.equal(ours[k], theirs[k]), k
    # the port's module takes it strictly, and no batch count reaches it
    ts = TSolver(tconfig.ExperimentConfig(), device="cpu")
    ts.build_modules()[name].load_state_dict(ours, strict=True)
    assert not any(k.endswith("num_batches_tracked") for k in ours)
    if name == "image_decoder":
        # the transposed convs keep the file's taps, unflipped
        assert torch.equal(ours["up1.up.conv.weight"], sd["up1.up.weight"])


@pytest.fixture(scope="module")
def imported(files, tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    for name, sd in files.items():
        torch.save(sd, str(d / f"{name}.pth"))
    cfg = ExperimentConfig(
        data=DataConfig(crop_size=(HW, HW, 1), num_classes=4),
        segmentation_model=SegmentationModelConfig(
            network_type="FCN_16_standard_no_STN", num_classes=4),
        learning=LearningConfig(lr=1e-4, batch_size=N, optimizer_type="AdamW"))
    js = JSolver(cfg)
    state = js.init_state(jax.random.key(0), (HW, HW), batch_size=N)
    params, stats = dict(state.params), dict(state.batch_stats)
    for name in params:
        p, s = jti.import_module_checkpoint(str(d / f"{name}.pth"), name, js.spec)
        params[name] = jax.tree_util.tree_map(jnp.asarray, p)
        stats[name] = jax.tree_util.tree_map(jnp.asarray, s)
    ts = TSolver(tconfig.ExperimentConfig.from_dict(dataclasses.asdict(cfg)), device="cpu")
    tstate = ts.init_state(0)
    names = tti.import_module_checkpoints(tstate.modules, str(d), ts.spec)
    assert sorted(names) == sorted(files)
    return js, params, stats, ts, tstate, d


def close(t, j):
    j = np.asarray(j)
    scale = max(1.0, float(np.abs(j).max()))
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=FWD["rtol"], atol=FWD["atol"] * scale)


def test_imported_modules_forward_as_the_jax_package(imported):
    js, params, stats, ts, tstate, _ = imported
    x = np.random.RandomState(1).rand(N, HW, HW, 1).astype(np.float32)
    (z_i, z_s), _ = js.encode_image(params, stats, jnp.asarray(x), mode="eval")
    tz_i, tz_s = ts.encode_image(tstate.modules, torch.from_numpy(x.transpose(0, 3, 1, 2)),
                                 mode="eval")
    close(tz_i, np.asarray(z_i).transpose(0, 3, 1, 2))
    close(tz_s, np.asarray(z_s).transpose(0, 3, 1, 2))
    for name, code in (("segmentation_decoder", z_s), ("image_decoder", z_i)):
        out, _ = js.decode(name, params, stats, code, mode="eval")
        tout = ts.decode(tstate.modules, name,
                         torch.from_numpy(np.asarray(code).transpose(0, 3, 1, 2).copy()),
                         mode="eval")
        close(tout, np.asarray(out).transpose(0, 3, 1, 2))


def test_import_snapshot_matches_the_jax_package(files, tmp_path):
    path = str(tmp_path / "snapshot.pth")
    torch.save({"network_type": "FCN_16_standard_no_STN", "epoch": 7,
                "model_state": files,
                "optimizer_state": {"image_encoder": {"state": {}, "param_groups": []}}}, path)
    jparams, jstats, jmeta = jti.import_snapshot(path)
    sds, meta = tti.import_snapshot(path)
    assert meta == jmeta == {"epoch": 7, "network_type": "FCN_16_standard_no_STN"}
    assert set(sds) == set(jparams) == set(files)
    for name, sd in sds.items():
        want = convert.flax_to_state_dict(jparams[name], jstats[name])
        assert set(sd) == set(want)
        assert all(torch.equal(sd[k], want[k]) for k in sd)


def test_batch_counts_are_dropped_and_other_strays_refused(files, tmp_path):
    sd = files["segmentation_decoder"]
    assert any(k.endswith("num_batches_tracked") for k in sd)
    plain = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    a = tti.convert_module_state_dict(sd, "segmentation_decoder")
    b = tti.convert_module_state_dict(plain, "segmentation_decoder")
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="no counterpart"):
        tti.convert_module_state_dict({**sd, "up1.extra.weight": torch.zeros(1)},
                                      "segmentation_decoder")
    with pytest.raises(KeyError):
        tti.convert_module_state_dict({k: v for k, v in sd.items() if "final_conv" not in k},
                                      "segmentation_decoder")
    path = str(tmp_path / "module.pth")
    torch.save(torch.nn.Linear(2, 2), path)
    with pytest.raises(ValueError, match="pickled"):
        tti.load_torch_state_dict(path)


def test_unported_models_raise_naming_roadmap_item_7(files):
    """A reference UNETR module has no converter, in the JAX package either;
    its refusal says so and names convert_unetr_vit, the ViT's importer."""
    spec = parse_network_type("UnetTransformer_enable_code_filter_16")
    for name in ("image_encoder", "segmentation_decoder"):
        with pytest.raises(ValueError, match="JAX package has no importer for a reference "
                                             "UNETR checkpoint.*convert_unetr_vit"):
            tti.convert_module_state_dict(files["image_encoder"], name, spec)


def make_ds_encoder_sd(rng, r=R, in_ch=1, out_ch=128, nd=2):
    """A Dual_Branch_Encoder with a DomainSpecificEncoder in the reference's
    naming: inc_conv_1/2 and norm_1/2 (bns.{d}), down{i} with down, a
    spectral_norm'd conv_1 (weight_orig, weight_u, weight_v), norm_1,
    conv_2, norm_2, conv_input; a bare final_conv and final_norm."""
    sd = {}
    p = "general_encoder"
    chans = [64 // r, 128 // r, 256 // r, 512 // r, 512 // r]

    def ds_bn(name, c):
        for d in range(nd):
            bn_entries(rng, sd, f"{name}.bns.{d}", c)

    conv_entries(rng, sd, f"{p}.inc_conv_1", in_ch, chans[0], 3)
    ds_bn(f"{p}.norm_1", chans[0])
    conv_entries(rng, sd, f"{p}.inc_conv_2", chans[0], chans[0], 3)
    ds_bn(f"{p}.norm_2", chans[0])
    cin = chans[0]
    for i, cout in enumerate(chans[1:], start=1):
        q = f"{p}.down{i}"
        conv_entries(rng, sd, f"{q}.down", cin, cin, 3)
        sd[f"{q}.conv_1.weight_orig"] = torch.from_numpy(
            rng.randn(cout, cin, 3, 3).astype(np.float32) * 0.1)
        sd[f"{q}.conv_1.bias"] = torch.from_numpy(rng.randn(cout).astype(np.float32) * 0.1)
        u, v = rng.randn(cout).astype(np.float32), rng.randn(cin * 9).astype(np.float32)
        sd[f"{q}.conv_1.weight_u"] = torch.from_numpy(u / np.linalg.norm(u))
        sd[f"{q}.conv_1.weight_v"] = torch.from_numpy(v / np.linalg.norm(v))
        ds_bn(f"{q}.norm_1", cout)
        conv_entries(rng, sd, f"{q}.conv_2", cout, cout, 3)
        ds_bn(f"{q}.norm_2", cout)
        conv_entries(rng, sd, f"{q}.conv_input", cin, cout, 1)
        cin = cout
    conv_entries(rng, sd, f"{p}.final_conv", cin, out_ch, 1)
    ds_bn(f"{p}.final_norm", out_ch)
    for i in (0, 3):
        conv_entries(rng, sd, f"code_decoupler.{i}", out_ch, out_ch, 3, bias=False)
        bn_entries(rng, sd, f"code_decoupler.{i + 1}", out_ch)
    return sd


def _double_conv(rng, sd, prefix, cin, cout):
    conv_entries(rng, sd, f"{prefix}.0", cin, cout, 3)
    bn_entries(rng, sd, f"{prefix}.1", cout)
    conv_entries(rng, sd, f"{prefix}.3", cout, cout, 3)
    bn_entries(rng, sd, f"{prefix}.4", cout)


def make_unet_encoder_sd(rng, r=R, code_filter=False):
    """segmentation_models.UnetEncoder in the reference's naming."""
    sd = {}
    chans = [64 // r, 128 // r, 256 // r, 512 // r, 512 // r]
    _double_conv(rng, sd, "inc.conv.conv", 1, chans[0])
    for i in range(1, 5):
        _double_conv(rng, sd, f"down{i}.mpconv.1.conv", chans[i - 1], chans[i])
    if code_filter:
        for i, c in enumerate(chans, start=1):
            for j in (0, 3):
                conv_entries(rng, sd, f"code_filter_{i}.code_decoupler.{j}", c, c, 3, bias=False)
                bn_entries(rng, sd, f"code_filter_{i}.code_decoupler.{j + 1}", c)
    return sd


def make_unet_decoder_sd(rng, out_ch, conv2, r=R):
    """segmentation_models.UnetDecoder in the reference's naming (up{i}.up
    ConvTranspose2d taps (in, out, 2, 2) for Conv2 ups)."""
    sd = {}
    outs = [256 // r, 128 // r, 64 // r, 64 // r]
    below = [512 // r] + outs[:3]
    skips = [512 // r, 256 // r, 128 // r, 64 // r]
    for i in range(4):
        if conv2:
            sd[f"up{i + 1}.up.weight"] = torch.from_numpy(
                rng.randn(below[i], below[i], 2, 2).astype(np.float32) * 0.1)
            sd[f"up{i + 1}.up.bias"] = torch.from_numpy(rng.randn(below[i]).astype(np.float32))
        _double_conv(rng, sd, f"up{i + 1}.conv.conv", skips[i] + below[i], outs[i])
    conv_entries(rng, sd, "outc.conv", outs[3], out_ch, 1)
    return sd


def make_fcn_sd(rng, fs=R, num_classes=4):
    """The reference's Bai-style FCN (segmentation_models/fcn.py)."""
    from maxstyle_tpu_torch.models.baselines import _fcn_units
    f = [64 // fs, 128 // fs, 256 // fs, 512 // fs, 512 // fs]
    sd = {}
    for name, (cin, cout, _, k) in zip(tti.FCN_UNITS, _fcn_units(1, f)):
        conv_entries(rng, sd, f"{name}.cbr_unit.0", cin, cout, k)
        bn_entries(rng, sd, f"{name}.cbr_unit.1", cout)
    conv_entries(rng, sd, "outS", 64, num_classes, 1)
    return sd


def _tensors_of(sd):
    """The file's tensors, num_batches_tracked dropped, as sorted byte strings."""
    return sorted(v.numpy().tobytes() for k, v in sd.items()
                  if not k.endswith("num_batches_tracked"))


def family_files(seed=0):
    """(network_type, module name, reference state dict) of every new
    converter: DS_FCN's encoder, the STN's shape encoder (w_image: 4 + 1
    input channels) and decoder, the Unet encoders and decoders."""
    rng = np.random.RandomState(seed)
    shape_encoder = {k[len("general_encoder."):]: v for k, v in
                     make_encoder_sd(rng, in_ch=5).items() if k.startswith("general_encoder.")}
    return [
        ("DS_FCN_16_standard", "image_encoder", with_batch_counts(make_ds_encoder_sd(rng))),
        ("FCN_16_standard_w_image", "shape_encoder", with_batch_counts(shape_encoder)),
        ("FCN_16_standard_w_image", "shape_decoder",
         with_batch_counts(make_decoder_sd(rng, "NN", 4))),
        ("Unet_16_standard_no_STN", "image_encoder", make_unet_encoder_sd(rng)),
        ("Unet_16_standard_enable_code_filter_no_STN", "image_encoder",
         make_unet_encoder_sd(rng, code_filter=True)),
        ("Unet_16_standard_no_STN", "segmentation_decoder",
         make_unet_decoder_sd(rng, 4, conv2=False)),
        ("Unet_16_Unet_im_recon_no_STN", "image_decoder", make_unet_decoder_sd(rng, 1, conv2=True)),
        ("Unet_16_standard_no_STN", "image_decoder", make_decoder_sd(rng, "Conv2", 1)),
    ]


@pytest.mark.parametrize("case", range(8))
def test_every_family_imports_bit_for_bit_as_the_jax_package_does(case):
    """DS, STN and Unet modules: the port's import equals convert.py of the
    JAX import bit for bit, holds exactly the file's tensors (transposed
    convs unflipped), loads strictly into the port's module, and refuses a
    stray key."""
    network_type, name, sd = family_files()[case]
    spec = parse_network_type(network_type)
    ours = tti.convert_module_state_dict(sd, name, spec)
    p, st = jti.convert_module_state_dict({k: v.numpy() for k, v in sd.items()}, name, spec)
    theirs = convert.flax_to_state_dict(p, st)
    assert set(ours) == set(theirs)
    assert all(torch.equal(ours[k], theirs[k]) for k in ours)
    assert _tensors_of(ours) == _tensors_of(sd)
    cfg = tconfig.ExperimentConfig.from_dict({"segmentation_model": {
        "network_type": network_type, "num_classes": 4}})
    TSolver(cfg, device="cpu").build_modules()[name].load_state_dict(ours, strict=True)
    if name == "image_decoder":  # Conv2 ups: the file's taps, unflipped
        key = "up1.up.weight" if "Unet_im_recon" in network_type else "up1.up.conv.weight"
        assert torch.equal(ours[key], sd["up1.up.weight"])
    with pytest.raises(ValueError, match="no counterpart"):
        tti.convert_module_state_dict({**sd, "stray.weight": torch.zeros(1)}, name, spec)


def test_ds_encoder_imports_its_power_iteration_vectors():
    sd = make_ds_encoder_sd(np.random.RandomState(4))
    ours = tti.convert_module_state_dict(sd, "image_encoder")
    q = "general_encoder.down2.conv1"
    assert torch.equal(ours[f"{q}.weight"], sd["general_encoder.down2.conv_1.weight_orig"])
    assert torch.equal(ours[f"{q}.u"], sd["general_encoder.down2.conv_1.weight_u"])
    assert torch.equal(ours[f"{q}.v"], sd["general_encoder.down2.conv_1.weight_v"])
    assert torch.equal(ours["general_encoder.final_norm.bn_domain1.running_var"],
                       sd["general_encoder.final_norm.bns.1.running_var"])


def test_fcn_baseline_imports_as_the_jax_package_does():
    from maxstyle_tpu_torch.basic_solver import build_network
    sd = with_batch_counts(make_fcn_sd(np.random.RandomState(5)))
    ours = tti.convert_fcn(sd)
    theirs = convert.flax_to_state_dict(*jti.convert_fcn({k: v.numpy() for k, v in sd.items()}))
    assert set(ours) == set(theirs) and all(torch.equal(ours[k], theirs[k]) for k in ours)
    assert _tensors_of(ours) == _tensors_of(sd)
    build_network("FCN_16", 4).load_state_dict(ours, strict=True)
    with pytest.raises(ValueError, match="no counterpart"):
        tti.convert_fcn({**sd, "conv6.cbr_unit.0.weight": torch.zeros(1)})


def test_train_cli_starts_from_the_imported_weights(tmp_path, monkeypatch):
    from tests.test_torch_port_train_cli import make_prostate_site, write_config

    files = reference_files(seed=3, num_classes=2)
    ref = tmp_path / "ref"
    ref.mkdir()
    for name in ("image_encoder", "image_decoder"):  # no segmentation decoder file
        torch.save(files[name], str(ref / f"{name}.pth"))
    cfg = write_config(tmp_path, make_prostate_site(str(tmp_path / "site"), n_patients=4))
    seen = {}
    factory = train.make_fused_train_step

    def probe(*a, **kw):
        step = factory(*a, **kw)

        def first(state, *sa, **skw):
            if not seen:
                seen.update({k: {n: t.clone() for n, t in m.state_dict().items()}
                             for k, m in state.modules.items()})
            return step(state, *sa, **skw)
        return first

    monkeypatch.setattr(train, "make_fused_train_step", probe)
    train.main(["--json_config_path", cfg, "--save_dir", str(tmp_path / "saved"),
                "--data_setting", "all", "--cval", "0", "--seed", "1", "--debug",
                "--torch_ckpt_dir", str(ref), "--device", "cpu"])
    for name in ("image_encoder", "image_decoder"):
        want = tti.convert_module_state_dict(files[name], name)
        assert set(seen[name]) == set(want)
        assert all(torch.equal(seen[name][k], want[k]) for k in want), name
    assert torch.equal(seen["image_decoder"]["up2.up.conv.weight"],
                       files["image_decoder"]["up2.up.weight"])
    # the segmentation decoder keeps the run's fresh weights
    with open(cfg) as f:
        tcfg = tconfig.ExperimentConfig.from_dict(json.load(f))
    from maxstyle_tpu_torch import prng
    fresh = TSolver(tcfg, device="cpu").build_modules(prng.stream_seed(1, "init"))
    sd = fresh["segmentation_decoder"].state_dict()
    assert all(torch.equal(seen["segmentation_decoder"][k], sd[k]) for k in sd)
    assert os.path.isdir(tmp_path / "saved")
