"""The port's metrics against the JAX package's: the confusion-matrix score,
the per-patient segmentation score and its CSV files.

The port keeps no pandas: its CSV files are held byte for byte against the
files the JAX package's pandas writes for the same scores, NaN fields and
the summary's empty index header included, and its summary statistics
against pandas' NaN-skipping mean and std, exactly.
"""

import math

import numpy as np
import pandas as pd
import pytest

from maxstyle_tpu import metrics as jm
from maxstyle_tpu_torch import metrics as tm

METRICS = ("Dice", "HD", "HD95", "ASD", "VS", "VolError")


def labelings(seed, n_classes=4, shape=(3, 24, 20), absent=()):
    """A ground truth of blobs and a prediction that moves, grows and drops
    some of them; classes in ``absent`` are missing from both."""
    rng = np.random.RandomState(seed)
    gt = np.zeros(shape, np.int32)
    pred = np.zeros(shape, np.int32)
    for k in range(1, n_classes):
        if k in absent:
            continue
        for vol, jitter in ((gt, 0), (pred, 2)):
            cy, cx = rng.randint(6, shape[1] - 6), rng.randint(6, shape[2] - 6)
            r = rng.randint(2, 5) + jitter * rng.rand()
            yy, xx = np.mgrid[:shape[1], :shape[2]]
            disc = np.hypot(yy - cy, xx - cx) < r
            for s in range(shape[0]):
                if rng.rand() < 0.8:
                    vol[s][disc] = k
    noise = rng.rand(*shape) < 0.02
    pred[noise] = rng.randint(0, n_classes, noise.sum())
    return pred, gt


@pytest.mark.parametrize("absent", [(), (2,), (1, 3)])
def test_running_score_equals_the_jax_package(absent):
    j, t = jm.RunningScore(4), tm.RunningScore(4)
    for seed in range(3):
        pred, gt = labelings(seed, absent=absent)
        j.update(gt, pred)
        t.update(gt, pred)
    js, ts = j.get_scores(), t.get_scores()
    assert np.array_equal(j.confusion_matrix, t.confusion_matrix)
    for k in js:
        if k == "class_iou":
            assert list(js[k]) == list(ts[k])
            np.testing.assert_array_equal(np.array(list(js[k].values())),
                                          np.array(list(ts[k].values())))
        else:
            np.testing.assert_array_equal(js[k], ts[k])


@pytest.mark.parametrize("absent", [(), (2,), (1, 3)])
def test_segmentation_score_and_its_csv_files_equal_the_jax_package(tmp_path, absent):
    names = ["LV", "MYO", "RV"]
    j = jm.SegmentationScore(4, names, METRICS)
    t = tm.SegmentationScore(4, names, METRICS)
    for seed in range(4):
        pred, gt = labelings(seed, absent=absent)
        spacing = (10.0, 1.36719, 1.36719)
        j.update(f"p{seed}", pred, gt, voxel_spacing=spacing)
        t.update(f"p{seed}", pred, gt, voxel_spacing=spacing)
    df = j.to_dataframe()
    assert t.columns() == [c for c in df.columns if c != "patient_id"]
    for rec, (_, row) in zip(t.records, df.iterrows()):
        for c in df.columns:
            a, b = rec[c], row[c]
            assert a == b or (isinstance(a, float) and math.isnan(a) and math.isnan(b)), c
    jc, jmeans, jstds = j.summary()
    tc, tmeans, tstds = t.summary()
    assert jc == tc
    np.testing.assert_array_equal(jmeans, tmeans)
    np.testing.assert_array_equal(jstds, tstds)
    if absent:
        assert any(math.isnan(v) for r in t.records for v in r.values() if isinstance(v, float))

    j.save_csv(str(tmp_path / "j.csv"))
    t.save_csv(str(tmp_path / "t.csv"))
    assert (tmp_path / "j.csv").read_bytes() == (tmp_path / "t.csv").read_bytes()
    pd.DataFrame([dict(zip(jc, jmeans)), dict(zip(jc, jstds))],
                 index=["mean", "std"]).to_csv(str(tmp_path / "js.csv"))
    tm.write_csv(str(tmp_path / "ts.csv"), [dict(zip(tc, tmeans)), dict(zip(tc, tstds))],
                 index=["mean", "std"])
    assert (tmp_path / "js.csv").read_bytes() == (tmp_path / "ts.csv").read_bytes()


def test_nan_mean_std_equals_pandas():
    rng = np.random.RandomState(5)
    cases = [rng.rand(7), rng.randn(50) * 1e3, [1.0], [np.nan, np.nan], [np.nan, 2.0, 3.5],
             [0.1] * 11, rng.rand(33)]
    for vals in cases:
        s = pd.Series(np.asarray(vals, np.float64))
        for ddof in (0, 1):
            mean, std = tm.nan_mean_std(vals, ddof)
            want_mean, want_std = float(s.mean()), float(s.std(ddof=ddof))
            assert (mean == want_mean) or (math.isnan(mean) and math.isnan(want_mean))
            assert (std == want_std) or (math.isnan(std) and math.isnan(want_std))


def test_write_csv_is_byte_identical_to_pandas(tmp_path):
    rows = [{"dataset": "A-ISBI", "method": "", "x (mean)": 0.1, "y": np.nan, "n": 3,
             "z": 1e-5},
            {"dataset": 'quote"d, name', "method": "m", "x (mean)": 1e16, "y": -1.0, "n": 4,
             "z": 0.30000000000000004},
            {"dataset": "late", "method": "m", "x (mean)": 5e-324, "y": 2.0, "n": 5, "z": 7.0,
             "extra": 0.5}]
    pd.DataFrame(rows).to_csv(str(tmp_path / "p.csv"), index=False)
    tm.write_csv(str(tmp_path / "t.csv"), rows)
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "t.csv").read_bytes()
    one = [{"a": np.nan}, {"a": 1.5}]
    pd.DataFrame(one).to_csv(str(tmp_path / "p1.csv"), index=False)
    tm.write_csv(str(tmp_path / "t1.csv"), one)
    assert (tmp_path / "p1.csv").read_bytes() == (tmp_path / "t1.csv").read_bytes()


def test_binary_metrics_equal_the_jax_package():
    for seed in range(4):
        pred, gt = labelings(seed, n_classes=2)
        p, g = pred == 1, gt == 1
        for name in ("dice", "jaccard", "precision", "recall", "specificity", "ravd",
                     "volume_similarity"):
            assert getattr(jm, name)(p, g) == getattr(tm, name)(p, g), name
        sp = (3.0, 1.0, 1.2)
        for name in ("hausdorff_distance", "hd95", "asd", "assd", "obj_asd", "obj_assd"):
            a, b = getattr(jm, name)(p, g, sp), getattr(tm, name)(p, g, sp)
            assert a == b or (math.isnan(a) and math.isnan(b)), name
        assert jm.hd_2d_stack(p, g, sp[1:]) == tm.hd_2d_stack(p, g, sp[1:])
        assert jm.obj_tpr(p, g) == tm.obj_tpr(p, g)
        assert jm.obj_fpr(p, g) == tm.obj_fpr(p, g)


def test_dataset_summary_rows_match_the_jax_package_layout(tmp_path):
    """auto_test's dataset_summary.csv: the JAX rows from a scored suite,
    written by pandas and by the port's writer, byte for byte."""
    names = ["LV", "MYO", "RV"]
    rows = []
    for suite, absent in (("ACDC", ()), ("MM", (2,))):
        t = tm.SegmentationScore(4, names, ("Dice", "HD95", "ASD"))
        for seed in range(3):
            pred, gt = labelings(10 + seed, absent=absent)
            t.update(f"p{seed}", pred, gt, voxel_spacing=(10.0, 1.0, 1.0))
        cols, means, stds = t.summary()
        rec = {"dataset": suite, "method": "MaxStyle"}
        rec.update({f"{c} (mean)": m for c, m in zip(cols, means)})
        rec["Dice AVG"] = float(np.mean([m for c, m in zip(cols, means) if c.endswith("_Dice")]))
        rec.update({f"{c} (std)": sd for c, sd in zip(cols, stds)})
        rows.append(rec)
    pd.DataFrame(rows).to_csv(str(tmp_path / "p.csv"), index=False)
    tm.write_csv(str(tmp_path / "t.csv"), rows)
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "t.csv").read_bytes()
