"""Volumetric evaluation harness (patient-wise OOD benchmark).

Counterpart of ``maxstyle_tpu/evaluate.py`` (the reference's
test_basic_segmentation_solver.py:31-244 ``TestSegmentationNetwork`` and the
dataset wiring of test_ACDC_triplet_segmentation.py:27-182 and
test_prostate_segmentation.py:25-98):

* per patient: volume -> fixed-size slice chunks -> eval-mode predict and
  argmax on the device -> one copy to the host a chunk -> per-patient
  Dice[/HD/ASD] with voxel spacing -> CSV reports (``iter_1_summary.csv`` /
  ``iter_1_detailed.csv`` per suite, ``dataset_summary.csv`` over suites),
  written byte for byte as the JAX package's pandas writes them.
* the last chunk of a volume is padded to the chunk size, as in the JAX
  package, so every chunk has one shape.
* test-set registry: ACDC + artefacted variants + MSCMRSeg C0/LGE + M&M +
  UKBB (cardiac) and the 7 prostate sites A-ISBI..G-MedicalDecathlon.

The top-k panels (``save_top_k``) need ``utils/visualize.py``, which is not
ported yet (ROADMAP Queue 1 item 4), and raise.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from maxstyle_tpu_torch.data import medio
from maxstyle_tpu_torch.data.datasets import SliceDataset, build_general_dataset
from maxstyle_tpu_torch.metrics import SegmentationScore, table_columns, write_csv

CARDIAC_TEST_SUITES = ["ACDC", "RandomBias", "RandomSpike", "RandomMotion",
                       "RandomGhosting", "MSCMRSeg_C0", "MSCMRSeg_LGE", "MM",
                       "UKBB"]
PROSTATE_TEST_SITES = ["G-MedicalDecathlon", "E-BIDMC", "F-HK", "A-ISBI",
                       "B-ISBI_1.5", "C-I2CVB", "D-UCL"]

CARDIAC_CLASS_NAMES = ["LV", "MYO", "RV"]
PROSTATE_CLASS_NAMES = ["Prostate"]

# default file layouts per test suite ({root}/{suite}/... ; override by
# passing format names explicitly)
_DEFAULT_FORMATS = {
    "nii": ("{pid}/img.nii.gz", "{pid}/seg.nii.gz"),
    "nrrd": ("{pid}_img.nrrd", "{pid}_seg.nrrd"),
}


class TestSegmentationNetwork:
    """Patient-wise volumetric evaluation loop."""

    __test__ = False  # not a pytest class (name mirrors the reference API)

    def __init__(self, solver, state, dataset: SliceDataset, *,
                 maximum_batch_size: int = 25, n_iter: int = 1,
                 metrics_list: Sequence[str] = ("Dice",),
                 class_names: Optional[Sequence[str]] = None,
                 save_report_dir: Optional[str] = None,
                 save_predict: bool = False,
                 foreground_only: bool = False,
                 test_set_ratio: float = 1.0,
                 crop_hw: Tuple[int, int] = (192, 192)):
        self.solver = solver
        self.state = state
        self.dataset = dataset
        self.chunk = maximum_batch_size
        self.n_iter = n_iter
        self.crop_hw = crop_hw
        num_classes = 2 if foreground_only else solver.num_classes
        names = (list(class_names) if class_names is not None
                 else [str(i) for i in range(1, num_classes)])
        self.score = SegmentationScore(num_classes, names, metrics_list)
        self.save_report_dir = save_report_dir
        self.save_predict = save_predict
        self.foreground_only = foreground_only
        self.test_set_ratio = test_set_ratio

    def predict_volume(self, volume: np.ndarray) -> np.ndarray:
        """[S,h,w] normalized volume -> [S,h,w] int predictions, in chunks of
        ``maximum_batch_size`` slices (the last one padded with zeros)."""
        s = volume.shape[0]
        dev = self.solver.device
        preds = []
        for start in range(0, s, self.chunk):
            part = volume[start:start + self.chunk]
            n = part.shape[0]
            if n < self.chunk:
                pad = np.zeros((self.chunk - n, *part.shape[1:]), part.dtype)
                part = np.concatenate([part, pad], axis=0)
            x = torch.from_numpy(np.ascontiguousarray(part[..., None])).to(dev)
            logits = self.solver.predict(self.state.modules, x, softmax=False,
                                         n_iter=self.n_iter, normalize_input=False)
            preds.append(logits[:n].argmax(-1).cpu().numpy())
        return np.concatenate(preds, axis=0)

    def run(self) -> Tuple[List[float], List[float]]:
        pids = list(self.dataset.patient_ids)
        if self.test_set_ratio < 1.0:
            k = max(1, int(round(len(pids) * self.test_set_ratio)))
            pids = list(np.random.RandomState(0).choice(pids, k, replace=False))
        for pid in pids:
            vol, gt, spacing = self.dataset.get_patient_volume(pid)
            pred = self.predict_volume(vol)
            if self.foreground_only:
                pred = (pred > 0).astype(np.int32)
                gt = (gt > 0).astype(np.int32)
            # spacing is (sx,sy,sz); metrics expect [S,H,W]-ordered sampling
            vx = (spacing[2], spacing[1], spacing[0])
            self.score.update(pid, pred, gt, voxel_spacing=vx)
            if self.save_predict and self.save_report_dir:
                os.makedirs(self.save_report_dir, exist_ok=True)
                medio.write_nrrd(os.path.join(self.save_report_dir, f"{pid}_pred.nrrd"),
                                 pred.astype(np.uint8), spacing=spacing)
        cols, means, stds = self.score.summary()
        if self.save_report_dir:
            os.makedirs(self.save_report_dir, exist_ok=True)
            self.score.save_csv(os.path.join(self.save_report_dir, "iter_1_detailed.csv"))
            write_csv(os.path.join(self.save_report_dir, "iter_1_summary.csv"),
                      [dict(zip(cols, means)), dict(zip(cols, stds))], index=["mean", "std"])
        return means, stds


def get_testset(test_dataset_name: str, test_root_dir: str,
                crop_hw=(192, 192), pad_hw=(224, 224), new_spacing=None,
                image_format_name: Optional[str] = None,
                label_format_name: Optional[str] = None) -> SliceDataset:
    """Build the OOD test dataset for a named suite. Layout:
    {test_root_dir}/{suite}/{pid}/... (configurable per site)."""
    root = os.path.join(test_root_dir, test_dataset_name)
    if image_format_name is None:
        image_format_name, label_format_name = _DEFAULT_FORMATS["nii"]
    return build_general_dataset(root, image_format_name, label_format_name,
                                 pad_hw=pad_hw, crop_hw=crop_hw,
                                 new_spacing=new_spacing,
                                 dataset_name=test_dataset_name)


def evaluate(solver, state, test_dataset_name: str, test_root_dir: str, *,
             method_name: str = "", maximum_batch_size: int = 25,
             crop_hw=(192, 192), new_spacing=None,
             save_report_dir: Optional[str] = None,
             foreground_only: Optional[bool] = None,
             test_set_ratio: float = 1.0, n_iter: int = 1,
             metrics_list: Sequence[str] = ("Dice", "HD95", "ASD"),
             save_top_k: int = 0):
    """One test suite -> (means, stds, per-patient rows); the cardiac /
    prostate evaluate() wrappers in one function (class set chosen by the
    solver's num_classes)."""
    if save_top_k > 0:
        raise NotImplementedError("save_top_k is not ported yet: its panels need "
                                  "utils/visualize.py, ROADMAP Queue 1 item 4")
    if foreground_only is None:
        foreground_only = solver.num_classes <= 2
    class_names = (PROSTATE_CLASS_NAMES if foreground_only
                   else CARDIAC_CLASS_NAMES[:solver.num_classes - 1])
    dataset = get_testset(test_dataset_name, test_root_dir, crop_hw=crop_hw,
                          new_spacing=new_spacing)
    harness = TestSegmentationNetwork(
        solver, state, dataset, maximum_batch_size=maximum_batch_size,
        metrics_list=metrics_list, class_names=class_names,
        save_report_dir=save_report_dir, foreground_only=foreground_only,
        test_set_ratio=test_set_ratio, crop_hw=crop_hw, n_iter=n_iter)
    means, stds = harness.run()
    return means, stds, harness.score.records


def auto_test(solver, state, dataset_name: str, test_root_dir: str,
              save_dir: str, method_name: str = "", **kwargs) -> List[Dict]:
    """The post-training benchmark sweep (train_adv…:893-959): every suite
    for the task family -> ``{save_dir}/report/dataset_summary.csv`` with
    per-class Dice/HD95/ASD mean+std columns and a Dice AVG column; returns
    its rows. An all-missing test root raises."""
    if dataset_name in ("ACDC", "UKBB"):
        suites = CARDIAC_TEST_SUITES
    elif dataset_name == "Prostate":
        suites = PROSTATE_TEST_SITES
    else:
        raise NotImplementedError(dataset_name)

    rows = []
    skipped = []
    for suite in suites:
        suite_root = os.path.join(test_root_dir, suite)
        if not os.path.isdir(suite_root):
            print(f"skip {suite}: {suite_root} not found")
            skipped.append(suite)
            continue
        report_dir = os.path.join(save_dir, "report", suite)
        means, stds, detailed = evaluate(solver, state, suite, test_root_dir,
                                         save_report_dir=report_dir, **kwargs)
        cols = [c for c in table_columns(detailed) if c != "patient_id"]
        record = {"dataset": suite, "method": method_name}
        record.update({f"{c} (mean)": m for c, m in zip(cols, means)})
        dice_means = [m for c, m in zip(cols, means) if c.endswith("_Dice")]
        if len(dice_means) > 1:
            record["Dice AVG"] = float(np.mean(dice_means))
        record.update({f"{c} (std)": sd for c, sd in zip(cols, stds)})
        rows.append(record)
    if not rows:
        raise FileNotFoundError(
            f"no test suites found under {test_root_dir}: looked for "
            f"{suites}, all missing/skipped: {skipped}")
    os.makedirs(os.path.join(save_dir, "report"), exist_ok=True)
    write_csv(os.path.join(save_dir, "report", "dataset_summary.csv"), rows)
    return rows
