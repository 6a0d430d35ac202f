"""The port's evaluation against the JAX package's, on the same weights: the
JAX package's ``init_state`` carried over by ``convert.convert_train_state``.

* ``evaluate`` on a synthetic OOD suite (3 patients of 3 slices, resampled,
  cropped to 32^2, chunks of 2 slices so the last one is padded): the
  predictions agree on at least 99.99% of voxels, the per-patient metrics,
  their means and stds, and the CSV reports are equal. Metrics computed
  from the same predictions are equal in any case.
* ``eval_model`` with the no_aug policy (pads equal to crops, so no draw
  moves a pixel) gives the same validation mIoU and accuracy.
* the TensorBoard event files of the two ScalarLoggers are byte-equal for
  the same wall time and metrics.
"""

import dataclasses
import os
import time

import jax
import numpy as np
import pytest
import torch

from maxstyle_tpu import evaluate as jeval
from maxstyle_tpu import train as jtrain
from maxstyle_tpu.config import (DataConfig, ExperimentConfig, LearningConfig,
                                 SegmentationModelConfig)
from maxstyle_tpu.data import augment as jaug
from maxstyle_tpu.data import datasets as jds
from maxstyle_tpu.metrics import SegmentationScore as JScore
from maxstyle_tpu.solver import TripletSegmentationSolver as JSolver
from maxstyle_tpu.utils import tb_events as jtb
from maxstyle_tpu_torch import convert
from maxstyle_tpu_torch import config as tconfig
from maxstyle_tpu_torch import evaluate as teval
from maxstyle_tpu_torch import train as ttrain
from maxstyle_tpu_torch.data import augment as taug
from maxstyle_tpu_torch.data import datasets as tds
from maxstyle_tpu_torch.data import medio
from maxstyle_tpu_torch.metrics import SegmentationScore as TScore
from maxstyle_tpu_torch.solver import TripletSegmentationSolver as TSolver
from maxstyle_tpu_torch.utils import tb_events as ttb

torch.set_num_threads(2)
HW = 32
SPACING = (1.5625, 1.5625, 10.0)
NEW_SPACING = (1.36719, 1.36719, -1)


def write_suite(root, n=3, shape=(3, 40, 36), seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:shape[1], :shape[2]]
    for i in range(n):
        d = os.path.join(root, f"p{i}")
        os.makedirs(d)
        r = np.hypot(yy - shape[1] / 2 - rng.uniform(-3, 3), xx - shape[2] / 2)
        lab = np.zeros(shape, np.uint8)
        for k, rad in ((3, 11.0), (2, 8.0), (1, 4.0)):
            lab[:, r < rad] = k
        img = (np.array([0.1, 0.9, 0.4, 0.6])[lab] + 0.1 * rng.rand(*shape)).astype(np.float32)
        medio.write_nifti(os.path.join(d, "img.nii.gz"), img, SPACING)
        medio.write_nifti(os.path.join(d, "seg.nii.gz"), lab, SPACING)
    return root


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    cfg = ExperimentConfig(
        data=DataConfig(crop_size=(HW, HW, 1), pad_size=(HW, HW, 1), num_classes=4,
                        new_spacing=NEW_SPACING),
        segmentation_model=SegmentationModelConfig(
            network_type="FCN_16_standard_no_STN", num_classes=4),
        learning=LearningConfig(lr=1e-4, batch_size=4, optimizer_type="AdamW"))
    js = JSolver(cfg)
    jstate = js.init_state(jax.random.key(0), (HW, HW), batch_size=4)
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    stats = jax.tree_util.tree_map(np.asarray, jstate.batch_stats)
    ts = TSolver(tconfig.ExperimentConfig.from_dict(dataclasses.asdict(cfg)), device="cpu")
    tstate = ts.init_state(state_dicts=convert.convert_train_state(params, stats))
    root = write_suite(str(tmp_path_factory.mktemp("ood") / "ACDC"))
    return js, jstate, ts, tstate, os.path.dirname(root), tmp_path_factory.mktemp("reports")


def test_evaluate_gives_the_jax_package_metrics_and_reports(pair):
    js, jstate, ts, tstate, root, out = pair
    kw = dict(crop_hw=(HW, HW), new_spacing=NEW_SPACING, maximum_batch_size=2,
              metrics_list=("Dice", "HD95", "ASD", "VS"))
    jmeans, jstds, jdf = jeval.evaluate(js, jstate, "ACDC", root,
                                        save_report_dir=str(out / "j"), **kw)
    tmeans, tstds, trows = teval.evaluate(ts, tstate, "ACDC", root,
                                          save_report_dir=str(out / "t"), **kw)

    # the predictions, volume by volume
    ds = jeval.get_testset("ACDC", root, crop_hw=(HW, HW), new_spacing=NEW_SPACING)
    jnet = jeval.TestSegmentationNetwork(js, jstate, ds, maximum_batch_size=2)
    tnet = teval.TestSegmentationNetwork(ts, tstate, ds, maximum_batch_size=2)
    agree = total = 0
    for pid in ds.patient_ids:
        vol, gt, _ = ds.get_patient_volume(pid)
        jp, tp = jnet.predict_volume(vol), tnet.predict_volume(vol)
        assert jp.shape == tp.shape == gt.shape
        agree += int((jp == tp).sum())
        total += jp.size
        # metrics of the same predictions are equal
        js_, ts_ = JScore(4, None, ("Dice", "HD95", "ASD")), TScore(4, None, ("Dice", "HD95", "ASD"))
        js_.update(pid, jp, gt, voxel_spacing=(10.0, 1.36719, 1.36719))
        ts_.update(pid, jp, gt, voxel_spacing=(10.0, 1.36719, 1.36719))
        assert js_.to_dataframe().to_dict("records") == ts_.records
    assert agree / total >= 0.9999, (agree, total)

    if agree == total:
        assert jdf.to_dict("records") == trows
        np.testing.assert_array_equal(jmeans, tmeans)
        np.testing.assert_array_equal(jstds, tstds)
        for name in ("iter_1_detailed.csv", "iter_1_summary.csv"):
            assert (out / "j" / name).read_bytes() == (out / "t" / name).read_bytes()
    assert [r["patient_id"] for r in trows] == ["p0", "p1", "p2"]


def test_auto_test_writes_the_jax_package_dataset_summary(pair, tmp_path):
    js, jstate, ts, tstate, root, _ = pair
    kw = dict(crop_hw=(HW, HW), new_spacing=NEW_SPACING, maximum_batch_size=4)
    jdf = jeval.auto_test(js, jstate, "ACDC", root, save_dir=str(tmp_path / "j"),
                          method_name="m", **kw)
    trows = teval.auto_test(ts, tstate, "ACDC", root, save_dir=str(tmp_path / "t"),
                            method_name="m", **kw)
    assert list(jdf.columns) == list(trows[0])
    path = os.path.join("report", "dataset_summary.csv")
    jb, tb = ((tmp_path / d / path).read_bytes() for d in ("j", "t"))
    assert jb.splitlines()[0] == tb.splitlines()[0]
    if jdf.to_dict("records") == trows:
        assert jb == tb
    with pytest.raises(FileNotFoundError):
        teval.auto_test(ts, tstate, "ACDC", str(tmp_path / "none"), save_dir=str(tmp_path))
    report = tmp_path / "topk"
    teval.evaluate(ts, tstate, "ACDC", root, save_top_k=1, save_report_dir=str(report), **kw)
    panels = sorted(p.relative_to(report).as_posix() for p in report.rglob("*.png"))
    assert len(panels) == 2 and panels[0].startswith("top1_") and panels[1].startswith("worst1_")


def test_eval_model_with_no_aug_gives_the_jax_package_miou(pair):
    js, jstate, ts, tstate, root, _ = pair
    kw = dict(pad_hw=(HW, HW), crop_hw=(HW, HW), new_spacing=NEW_SPACING)
    suite = os.path.join(root, "ACDC")
    pids = sorted(os.listdir(suite))
    jset = jds.SliceDataset(suite, pids, "{pid}/img.nii.gz", "{pid}/seg.nii.gz", **kw)
    tset = tds.SliceDataset(suite, pids, "{pid}/img.nii.gz", "{pid}/seg.nii.gz", **kw)
    jl = jds.HostBatchLoader(jset, 4, drop_last=False, shuffle=False)
    tl = tds.HostBatchLoader(tset, 4, drop_last=False, shuffle=False)
    jiou, jacc = jtrain.eval_model(js, jstate, jl, jaug.get_policy("no_aug", (HW, HW), (HW, HW)),
                                   (HW, HW), jax.random.key(3))
    tiou, tacc = ttrain.eval_model(ts, tstate, tl, taug.get_policy("no_aug", (HW, HW), (HW, HW)),
                                   (HW, HW), torch.Generator().manual_seed(3))
    assert np.isfinite(tiou)
    np.testing.assert_allclose(tiou, jiou, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tacc, jacc, rtol=0, atol=1e-4)


def test_event_files_are_byte_equal(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    rng = np.random.RandomState(0)
    steps = [{k: np.float32(rng.rand()) for k in ("loss/total", "loss/standard/seg")}
             for _ in range(5)]
    loggers = {"j": jtrain.ScalarLogger(str(tmp_path / "j"), True),
               "t": ttrain.ScalarLogger(str(tmp_path / "t"), True)}
    for epoch in range(2):
        for m in steps:
            loggers["j"].log_step({k: jax.numpy.asarray(v) for k, v in m.items()})
            loggers["t"].log_step({k: torch.tensor(v) for k, v in m.items()})
        for lg in loggers.values():
            lg.log_epoch(epoch, 0.5 + epoch / 8, 0.75)
    loggers["j"].writer.close()
    loggers["t"].close()
    (jf,), (tf,) = (os.listdir(tmp_path / d) for d in ("j", "t"))
    assert jf == tf
    jb, tb = (tmp_path / "j" / jf).read_bytes(), (tmp_path / "t" / tf).read_bytes()
    assert jb == tb
    assert loggers["j"].history == loggers["t"].history
    events = ttb.read_events(str(tmp_path / "t" / tf))
    assert [e["step"] for e in events[1:]] == [0, 1]
    assert ttb.encode_event(1.5, 3, scalars={"a": 0.25}) == jtb.encode_event(1.5, 3,
                                                                             scalars={"a": 0.25})
