"""The port's host tools against the JAX package's.

* ``utils/pairwise_measures.py`` (PairwiseMeasures, RegressionMeasures):
  every measure, the header and the CSV row on 2-D and 3-D pairs — equal.
* ``ops/morphology.py`` (a max pool in NCHW) against the JAX package's
  ``reduce_window`` (NHWC): equal, at the rims too.
* ``data/clahe.py``: equal images for the same RandomState.
* ``data/artefacts.py``: for the same RandomState seed each artefact's
  volume is equal to the JAX package's bit for bit; ``main`` writes a suite
  that ``evaluate.get_testset`` reads, with the JAX package's volumes.
* ``data/preprocess.py``: byte-equal NRRD files (the gzip time stamp fixed);
  N4 raises the same RuntimeError without SimpleITK.
* ``utils/profiling.py``: ``parameter_count``/``parameter_bytes`` equal for
  FCN_16_standard_no_STN in both packages; ``reestimate_batch_stats`` gives
  the JAX package's running statistics (rtol 1e-4 / atol 5e-5, as
  test_torch_port_model's BatchNorm statistics); ``trace`` writes a trace.
* ``utils/features.py``: ``extract_features`` of the image decoder holds
  every activation the JAX package captures, under the same keys, at
  rtol 1e-4 / atol 5e-5.
"""

import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxstyle_tpu.config import (DataConfig, ExperimentConfig, LearningConfig,
                                 SegmentationModelConfig)
from maxstyle_tpu.data import artefacts as jart
from maxstyle_tpu.data import clahe as jclahe
from maxstyle_tpu.data import datasets as jds
from maxstyle_tpu.data import preprocess as jpre
from maxstyle_tpu.ops import morphology as jmorph
from maxstyle_tpu.solver import TripletSegmentationSolver as JSolver
from maxstyle_tpu.utils import features as jfeat
from maxstyle_tpu.utils import pairwise_measures as jpm
from maxstyle_tpu.utils import profiling as jprof
from maxstyle_tpu_torch import config as tconfig
from maxstyle_tpu_torch import convert
from maxstyle_tpu_torch import evaluate as teval
from maxstyle_tpu_torch.data import artefacts as tart
from maxstyle_tpu_torch.data import clahe as tclahe
from maxstyle_tpu_torch.data import medio
from maxstyle_tpu_torch.data import preprocess as tpre
from maxstyle_tpu_torch.ops import morphology as tmorph
from maxstyle_tpu_torch.solver import TripletSegmentationSolver as TSolver
from maxstyle_tpu_torch.utils import features as tfeat
from maxstyle_tpu_torch.utils import pairwise_measures as tpm
from maxstyle_tpu_torch.utils import profiling as tprof
from tests.test_torch_port_evaluate import write_suite

torch.set_num_threads(2)
HW = 32
FWD = dict(rtol=1e-4, atol=5e-5)


def blobs(rng, shape, p=0.3):
    from scipy import ndimage
    return ndimage.binary_opening(rng.rand(*shape) < p)


@pytest.mark.parametrize("shape", [(24, 20), (5, 16, 18)])
def test_pairwise_measures_equal_the_jax_package(shape):
    rng = np.random.RandomState(len(shape))
    seg, ref = blobs(rng, shape, 0.45), blobs(rng, shape, 0.5)
    pixdim = (1.5, 0.7, 2.0)[:len(shape)]
    j = jpm.PairwiseMeasures(seg, ref, pixdim=pixdim, list_labels=[1, 3])
    t = tpm.PairwiseMeasures(seg, ref, pixdim=pixdim, list_labels=[1, 3])
    for name in j.m_dict:
        np.testing.assert_array_equal(np.asarray(t.m_dict[name][0]()),
                                      np.asarray(j.m_dict[name][0]()), err_msg=name)
    assert t.header_str() == j.header_str() and t.to_string() == j.to_string()
    assert t.to_dict() == pytest.approx(j.to_dict(), rel=0, abs=0, nan_ok=True)
    for a, b in zip(t.connected_errormaps(), j.connected_errormaps()):
        np.testing.assert_array_equal(a, b)
    assert t.measured_hausdorff_distance_95() == j.measured_hausdorff_distance_95()
    assert t.relative_volume_difference() == j.relative_volume_difference()
    empty = tpm.PairwiseMeasures(np.zeros(shape), ref)
    assert empty.com_dist() == jpm.PairwiseMeasures(np.zeros(shape), ref).com_dist() == -1.0
    reg, refi = rng.rand(*shape), rng.rand(*shape)
    jr, tr = jpm.RegressionMeasures(reg, refi), tpm.RegressionMeasures(reg, refi)
    assert tr.to_string() == jr.to_string() and tr.header_str() == jr.header_str()
    assert tr.r2() == jr.r2()


@pytest.mark.parametrize("k", [3, 5])
def test_morphology_equals_the_jax_package(k):
    x = np.random.RandomState(k).randn(2, 9, 11, 3).astype(np.float32)
    t = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    for jf, tf in ((jmorph.dilation2d, tmorph.dilation2d), (jmorph.erosion2d, tmorph.erosion2d),
                   (jmorph.morphological_gradient, tmorph.morphological_gradient)):
        want = np.asarray(jf(jnp.asarray(x), k)).transpose(0, 3, 1, 2)
        np.testing.assert_array_equal(tf(t, k).numpy(), want)


def test_clahe_equals_the_jax_package():
    rng = np.random.RandomState(4)
    img = (rng.rand(3, 37, 29) ** 2).astype(np.float32) * 5
    np.testing.assert_array_equal(tclahe.equalize_adapthist(img[0], clip_limit=0.03, nbins=64),
                                  jclahe.equalize_adapthist(img[0], clip_limit=0.03, nbins=64))
    a = jclahe.random_clahe(np.random.RandomState(7), img, label=np.ones(3))
    b = tclahe.random_clahe(np.random.RandomState(7), img, label=np.ones(3))
    np.testing.assert_array_equal(b[0], a[0])
    np.testing.assert_array_equal(tclahe.random_clahe(np.random.RandomState(8), img[1]),
                                  jclahe.random_clahe(np.random.RandomState(8), img[1]))


@pytest.mark.parametrize("kind", sorted(jart.ARTEFACTS))
def test_artefacts_equal_the_jax_package(kind):
    rng = np.random.RandomState(11)
    vol = rng.rand(3, 40, 36).astype(np.float32)
    want = jart.ARTEFACTS[kind](vol, np.random.RandomState(2021))
    got = tart.ARTEFACTS[kind](vol, np.random.RandomState(2021))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_artefacts_main_writes_a_suite_that_get_testset_reads(tmp_path):
    src = write_suite(str(tmp_path / "src"), n=2)
    args = ["--root_dir", src, "--artefact", "spike", "--crop", "32", "32", "--repeats", "2"]
    tart.main(args + ["--out_root", str(tmp_path / "t")])
    jart.main(args + ["--out_root", str(tmp_path / "j")])
    ds = teval.get_testset("RandomSpike", str(tmp_path / "t"), crop_hw=(32, 32))
    assert ds.patient_ids == ["p0_r0", "p0_r1", "p1_r0", "p1_r1"]
    for pid in ds.patient_ids:
        for name in ("img.nii.gz", "seg.nii.gz"):
            a, sa = medio.read_nifti(str(tmp_path / "t" / "RandomSpike" / pid / name))
            b, sb = medio.read_nifti(str(tmp_path / "j" / "RandomSpike" / pid / name))
            np.testing.assert_array_equal(a, b)
            assert sa == sb
    jds_ = jds.build_general_dataset(str(tmp_path / "j" / "RandomSpike"), "{pid}/img.nii.gz",
                                     "{pid}/seg.nii.gz", pad_hw=(32, 32), crop_hw=(32, 32))
    assert jds_.patient_ids == ds.patient_ids


def test_preprocess_writes_the_jax_package_bytes(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    rng = np.random.RandomState(5)
    img = (rng.rand(4, 30, 26) * 900).astype(np.float32)
    lab = rng.randint(0, 4, (4, 30, 26)).astype(np.uint8)
    medio.write_nifti(str(tmp_path / "img.nii.gz"), img, spacing=(1.25, 1.25, 8.0))
    medio.write_nifti(str(tmp_path / "seg.nii.gz"), lab, spacing=(1.25, 1.25, 8.0))
    outs = {}
    for tag, mod in (("j", jpre), ("t", tpre)):
        outs[tag] = [str(tmp_path / f"{tag}_img.nrrd"), str(tmp_path / f"{tag}_seg.nrrd")]
        mod.preprocess_volume(str(tmp_path / "img.nii.gz"), str(tmp_path / "seg.nii.gz"),
                              *outs[tag], swap_lv_rv=True)
    for a, b in zip(outs["t"], outs["j"]):
        assert open(a, "rb").read() == open(b, "rb").read()
    np.testing.assert_array_equal(tpre.percentile_normalize(img), jpre.percentile_normalize(img))
    with pytest.raises(RuntimeError, match="SimpleITK"):
        tpre.n4_bias_correction(img)


@pytest.fixture(scope="module")
def pair():
    cfg = ExperimentConfig(
        data=DataConfig(crop_size=(HW, HW, 1), num_classes=4),
        segmentation_model=SegmentationModelConfig(
            network_type="FCN_16_standard_no_STN", num_classes=4),
        learning=LearningConfig(lr=1e-4, batch_size=4, optimizer_type="AdamW"))
    js = JSolver(cfg)
    state = js.init_state(jax.random.key(0), (HW, HW), batch_size=4)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    stats = jax.tree_util.tree_map(np.asarray, state.batch_stats)
    ts = TSolver(tconfig.ExperimentConfig.from_dict(dataclasses.asdict(cfg)), device="cpu")
    tstate = ts.init_state(state_dicts=convert.convert_train_state(params, stats))
    return js, params, stats, ts, tstate


def test_parameter_count_and_bytes_equal_the_jax_package(pair):
    _, params, _, _, tstate = pair
    n = jprof.parameter_count(params)
    assert tprof.parameter_count(tstate.modules) == n
    assert tprof.parameter_bytes(tstate.modules) == jprof.parameter_bytes(params) == 4 * n
    assert tprof.parameter_count(dict(tstate.modules["image_decoder"].named_parameters())) \
        == jprof.parameter_count(params["image_decoder"])


def test_reestimate_batch_stats_equals_the_jax_package(pair):
    js, params, stats, _, tstate = pair
    rng = np.random.RandomState(6)
    batches = [rng.rand(4, HW, HW, 1).astype(np.float32) for _ in range(3)]
    enc = js.modules["image_encoder"]
    want = jprof.reestimate_batch_stats(
        lambda v, b: enc.apply(v, b, train=True, mutable=["batch_stats"]),
        {"params": params["image_encoder"], "batch_stats": stats["image_encoder"]},
        [jnp.asarray(b) for b in batches])
    got = tprof.reestimate_batch_stats(
        tstate.modules["image_encoder"],
        [torch.from_numpy(b.transpose(0, 3, 1, 2).copy()) for b in batches])
    want_sd = convert.flax_to_state_dict({}, jax.tree_util.tree_map(np.asarray, want))
    assert set(got) == set(want_sd)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want_sd[k].numpy(), **FWD, err_msg=k)


def test_extract_features_equals_the_jax_package(pair):
    js, params, stats, ts, tstate = pair
    code = np.random.RandomState(7).rand(2, HW // 16, HW // 16, 128).astype(np.float32)
    want = jfeat.extract_features(js.modules["image_decoder"],
                                  {"params": params["image_decoder"],
                                   "batch_stats": stats["image_decoder"]},
                                  jnp.asarray(code), train=False)
    got = tfeat.extract_features(tstate.modules["image_decoder"],
                                 torch.from_numpy(code.transpose(0, 3, 1, 2).copy()), "eval")
    # flax also captures its Norm2d wrappers' BatchNorm_0 children, which the port folds
    assert {k for k in want if "BatchNorm_0" not in k} <= set(got)
    assert "up1/up/ConvTranspose_0/__call__" in got and "__call__" in got
    for k, v in want.items():
        if "BatchNorm_0" in k:
            continue
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(v).transpose(0, 3, 1, 2), **FWD, err_msg=k)
    only = tfeat.extract_features(tstate.modules["image_decoder"],
                                  torch.from_numpy(code.transpose(0, 3, 1, 2).copy()), "eval",
                                  filter_names=["conv_input"])
    assert len(only) == 4 and all("conv_input" in k for k in only)


def test_trace_writes_a_trace(tmp_path):
    with tprof.trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
