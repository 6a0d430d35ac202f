"""Evaluation metrics: confusion-matrix scores + surface-distance metrics.

The port's own copy of ``maxstyle_tpu/metrics.py``, without pandas: the
per-patient tables are lists of dicts, written by :func:`write_csv` byte for
byte as pandas' ``to_csv`` writes the same frame (NaN as an empty field, the
index column under an empty header), and the summary statistics follow
pandas' NaN-skipping mean and std.

Re-implementation of the reference's metric stack:
* `RunningScore` ≙ common_utils/metrics.runningScore:12-52 (confusion-matrix
  pixel acc / class acc / mIoU / fwavacc) — used for epoch validation model
  selection (train_adv…:548-559).
* binary volume metrics ≙ the vendored medpy-style functions in
  common_utils/measure.py:33-1131 (dc, jc, precision, recall, specificity,
  hd, hd95, asd, assd, ravd, volume similarity) built on scipy
  distance_transform_edt with voxel spacing.
* `SegmentationScore` ≙ metrics.runningMySegmentationScore:134-287:
  per-patient multi-class Dice [+ HD as max over the 2D slice stack, ASD,
  volume similarity/error], CSV reporting.

These run on host numpy (they are per-patient, off the training hot path);
the device side only produces argmax predictions.
"""

from __future__ import annotations

import csv
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy import ndimage


# ---------------------------------------------------------------------------
# confusion-matrix running score
# ---------------------------------------------------------------------------


class RunningScore:
    """Streaming confusion matrix over [N,H,W] int label maps."""

    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.confusion_matrix = np.zeros((n_classes, n_classes), np.float64)

    def _fast_hist(self, true, pred):
        mask = (true >= 0) & (true < self.n_classes)
        hist = np.bincount(
            self.n_classes * true[mask].astype(int) + pred[mask],
            minlength=self.n_classes ** 2,
        ).reshape(self.n_classes, self.n_classes)
        return hist

    def update(self, label_trues, label_preds):
        for lt, lp in zip(label_trues, label_preds):
            self.confusion_matrix += self._fast_hist(lt.flatten(), lp.flatten())

    def get_scores(self) -> Dict[str, object]:
        """Overall acc, mean acc, freq-weighted IoU, mean IoU + per-class
        IoU (keys mirror runningScore.get_scores)."""
        hist = self.confusion_matrix
        with np.errstate(divide="ignore", invalid="ignore"):
            acc = np.diag(hist).sum() / hist.sum()
            acc_cls = np.nanmean(np.diag(hist) / hist.sum(axis=1))
            iu = np.diag(hist) / (hist.sum(axis=1) + hist.sum(axis=0) - np.diag(hist))
            mean_iu = np.nanmean(iu)
            freq = hist.sum(axis=1) / hist.sum()
            fwavacc = (freq[freq > 0] * iu[freq > 0]).sum()
        cls_iu = dict(zip(range(self.n_classes), iu))
        return {
            "Overall Acc: \t": acc,
            "Mean Acc : \t": acc_cls,
            "FreqW Acc : \t": fwavacc,
            "Mean IoU : \t": mean_iu,
            "class_iou": cls_iu,
        }

    def reset(self):
        self.confusion_matrix[:] = 0


def print_metric(running_metric: RunningScore, name: str = "") -> Dict[str, object]:
    score = running_metric.get_scores()
    print(name, {k: v for k, v in score.items() if k != "class_iou"})
    return score


# ---------------------------------------------------------------------------
# binary volume metrics (measure.py equivalents)
# ---------------------------------------------------------------------------


def _as_bool(x) -> np.ndarray:
    return np.atleast_1d(np.asarray(x).astype(bool))


def dice(result, reference) -> float:
    """Dice coefficient DC = 2|A∩B| / (|A|+|B|) (measure.dc)."""
    r, g = _as_bool(result), _as_bool(reference)
    inter = np.count_nonzero(r & g)
    denom = np.count_nonzero(r) + np.count_nonzero(g)
    return 2.0 * inter / denom if denom > 0 else 0.0


def jaccard(result, reference) -> float:
    r, g = _as_bool(result), _as_bool(reference)
    union = np.count_nonzero(r | g)
    return np.count_nonzero(r & g) / union if union > 0 else 0.0


def precision(result, reference) -> float:
    r, g = _as_bool(result), _as_bool(reference)
    tp = np.count_nonzero(r & g)
    return tp / np.count_nonzero(r) if np.count_nonzero(r) else 0.0


def recall(result, reference) -> float:
    r, g = _as_bool(result), _as_bool(reference)
    tp = np.count_nonzero(r & g)
    return tp / np.count_nonzero(g) if np.count_nonzero(g) else 0.0


sensitivity = recall


def specificity(result, reference) -> float:
    r, g = _as_bool(result), _as_bool(reference)
    tn = np.count_nonzero(~r & ~g)
    return tn / np.count_nonzero(~g) if np.count_nonzero(~g) else 0.0


def _surface_distances(result, reference, voxelspacing=None) -> np.ndarray:
    """Distances from result's border voxels to reference's border
    (measure.__surface_distances:1096-1131 semantics: borders via binary
    erosion, edt with anisotropic sampling)."""
    r, g = _as_bool(result), _as_bool(reference)
    if not r.any() or not g.any():
        return np.asarray([np.inf])
    conn = ndimage.generate_binary_structure(r.ndim, 1)
    r_border = r ^ ndimage.binary_erosion(r, structure=conn, iterations=1)
    g_border = g ^ ndimage.binary_erosion(g, structure=conn, iterations=1)
    dt = ndimage.distance_transform_edt(~g_border, sampling=voxelspacing)
    return dt[r_border]


def hausdorff_distance(result, reference, voxelspacing=None) -> float:
    sd1 = _surface_distances(result, reference, voxelspacing)
    sd2 = _surface_distances(reference, result, voxelspacing)
    return float(max(sd1.max(), sd2.max()))


def hd95(result, reference, voxelspacing=None) -> float:
    sd1 = _surface_distances(result, reference, voxelspacing)
    sd2 = _surface_distances(reference, result, voxelspacing)
    return float(np.percentile(np.hstack((sd1, sd2)), 95))


def asd(result, reference, voxelspacing=None) -> float:
    return float(_surface_distances(result, reference, voxelspacing).mean())


def assd(result, reference, voxelspacing=None) -> float:
    return float(np.mean((asd(result, reference, voxelspacing),
                          asd(reference, result, voxelspacing))))


def hd_2d_stack(result, reference, voxelspacing_2d=None) -> float:
    """HD of a 3D volume as the MEAN over per-slice 2D HDs (slices where
    both masks are non-empty), -1 when no slice qualifies — exactly
    measure.hd_2D_stack:381-399, the convention runningMySegmentationScore
    uses for cardiac HD (reference metrics.py:220-227)."""
    hds = []
    for sl in range(result.shape[0]):
        r, g = result[sl], reference[sl]
        if r.any() and g.any():
            hds.append(hausdorff_distance(r, g, voxelspacing_2d))
    return float(np.mean(hds)) if hds else -1.0


def _object_correspondences(reference, result, connectivity: int = 1):
    """Greedy 1-1 correspondence between connected components of two binary
    volumes (measure.__distinct_binary_object_correspondences:1037-1093
    conventions, preserved exactly for parity: `result` is labelled as map1,
    `reference` as map2; map2's objects are scanned for >=1-voxel overlaps;
    ambiguous one-to-many overlaps resolved smallest-candidate-set-first).

    Returns (labels1(result), labels2(reference), n1, n2,
    mapping: {label2 -> label1}).
    """
    r = _as_bool(result)
    g = _as_bool(reference)
    footprint = ndimage.generate_binary_structure(r.ndim, connectivity)
    lab1, n1 = ndimage.label(r, footprint)
    lab2, n2 = ndimage.label(g, footprint)

    mapping: Dict[int, int] = {}
    used: set = set()
    one_to_many = []
    for l2id, slicer in enumerate(ndimage.find_objects(lab2), start=1):
        overlap_ids = np.unique(lab1[slicer][lab2[slicer] == l2id])
        overlap_ids = set(int(i) for i in overlap_ids if i != 0)
        if len(overlap_ids) == 1:
            l1id = overlap_ids.pop()
            if l1id not in used:
                mapping[l2id] = l1id
                used.add(l1id)
        elif len(overlap_ids) > 1:
            one_to_many.append((l2id, overlap_ids))
    while True:
        one_to_many = [(l2id, l1ids - used) for l2id, l1ids in one_to_many]
        one_to_many = sorted((x for x in one_to_many if x[1]),
                             key=lambda x: len(x[1]))
        if not one_to_many:
            break
        l2id, l1ids = one_to_many[0]
        l1id = min(l1ids)  # deterministic pick (reference pops arbitrarily)
        mapping[l2id] = l1id
        used.add(l1id)
        one_to_many = one_to_many[1:]
    return lab1, lab2, n1, n2, mapping


def obj_tpr(result, reference, connectivity: int = 1) -> float:
    """Object-detection true-positive rate (measure.obj_tpr:980-1034):
    matched pairs / number of distinct `result` objects."""
    _, _, n_result, _, mapping = _object_correspondences(reference, result,
                                                         connectivity)
    if n_result == 0:
        raise RuntimeError("no objects in result")
    return len(mapping) / float(n_result)


def obj_fpr(result, reference, connectivity: int = 1) -> float:
    """Object-detection false-positive rate (measure.obj_fpr:922-977):
    (distinct `reference` objects - matched pairs) / reference objects."""
    _, _, _, n_reference, mapping = _object_correspondences(reference, result,
                                                            connectivity)
    if n_reference == 0:
        raise RuntimeError("no objects in reference")
    return (n_reference - len(mapping)) / float(n_reference)


def obj_asd(result, reference, voxelspacing=None, connectivity: int = 1) -> float:
    """Average surface distance restricted to corresponding object pairs
    (measure.obj_asd:851-919; note the reference swaps its arguments into
    the correspondence helper, preserved here)."""
    lab1, lab2, _, _, mapping = _object_correspondences(result, reference,
                                                        connectivity)
    sds: List[np.ndarray] = []
    sl1 = ndimage.find_objects(lab1)
    sl2 = ndimage.find_objects(lab2)
    for l2id, l1id in mapping.items():
        window = tuple(slice(min(a.start, b.start), max(a.stop, b.stop))
                       for a, b in zip(sl1[l1id - 1], sl2[l2id - 1]))
        object1 = lab1[window] == l1id
        object2 = lab2[window] == l2id
        sds.append(_surface_distances(object1, object2, voxelspacing))
    if not sds:
        # reference: np.mean([]) -> nan (measure.py:919)
        return float("nan")
    return float(np.mean(np.concatenate(sds)))


def obj_assd(result, reference, voxelspacing=None, connectivity: int = 1) -> float:
    """Symmetric object-wise ASD (measure.obj_assd:799-848)."""
    return float(np.mean((obj_asd(result, reference, voxelspacing, connectivity),
                          obj_asd(reference, result, voxelspacing, connectivity))))


def ravd(result, reference) -> float:
    r, g = _as_bool(result), _as_bool(reference)
    vg = np.count_nonzero(g)
    if vg == 0:
        return np.nan
    return (np.count_nonzero(r) - vg) / float(vg)


def volume_similarity(result, reference) -> float:
    """VS = 1 - ||A|-|B|| / (|A|+|B|)."""
    r, g = _as_bool(result), _as_bool(reference)
    va, vb = np.count_nonzero(r), np.count_nonzero(g)
    return 1.0 - abs(va - vb) / (va + vb) if (va + vb) > 0 else 0.0


# ---------------------------------------------------------------------------
# CSV tables (pandas' to_csv format)
# ---------------------------------------------------------------------------


def table_columns(rows: Sequence[Dict]) -> List[str]:
    """The columns of a table of dict rows: every key, in order of first
    appearance (pandas' ``DataFrame(rows)`` order)."""
    cols: Dict[str, None] = {}
    for row in rows:
        cols.update(dict.fromkeys(row))
    return list(cols)


def _csv_field(value) -> str:
    """One value as pandas writes it: NaN and missing values empty, floats
    by their shortest repr, everything else by ``str``."""
    if value is None:
        return ""
    if isinstance(value, (float, np.floating)):
        return "" if math.isnan(value) else repr(float(value))
    return str(value)


def write_csv(path: str, rows: Sequence[Dict], index: Optional[Sequence[str]] = None) -> None:
    """Write dict rows as pandas' ``DataFrame(rows, index=index).to_csv(path,
    index=index is not None)`` does: a header of the columns (after an empty
    field when there is an index), then one line a row."""
    cols = table_columns(rows)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(([""] if index is not None else []) + cols)
        for i, row in enumerate(rows):
            fields = [_csv_field(row.get(c)) for c in cols]
            writer.writerow(([str(index[i])] if index is not None else []) + fields)


def nan_mean_std(values: Sequence[float], ddof: int = 0):
    """(mean, std) of ``values`` skipping NaN, in the float64 arithmetic of
    pandas' ``Series.mean()`` and ``Series.std(ddof)``; NaN when no value
    (or, for std, no degree of freedom) is left."""
    v = np.asarray(values, dtype=np.float64)
    mask = np.isnan(v)
    count = int((~mask).sum())
    filled = np.where(mask, 0.0, v)
    mean = filled.sum(dtype=np.float64) / count if count else float("nan")
    if count - ddof <= 0:
        return float(mean), float("nan")
    sqr = (mean - filled) ** 2
    np.putmask(sqr, mask, 0.0)
    return float(mean), float(np.sqrt(sqr.sum(dtype=np.float64) / (count - ddof)))


# ---------------------------------------------------------------------------
# per-patient multi-class aggregation (runningMySegmentationScore)
# ---------------------------------------------------------------------------


class SegmentationScore:
    """Accumulates per-patient, per-class metrics as dict rows.

    `metrics_list` subset of {'Dice','HD','HD95','ASD','VS','VolError'};
    foreground classes only (class ids 1..C-1), matching
    runningMySegmentationScore:134-287.
    """

    def __init__(self, n_classes: int, class_names: Optional[Sequence[str]] = None,
                 metrics_list: Sequence[str] = ("Dice",)):
        self.n_classes = n_classes
        self.class_names = (list(class_names) if class_names is not None
                            else [str(i) for i in range(1, n_classes)])
        assert len(self.class_names) == n_classes - 1
        self.metrics_list = list(metrics_list)
        self.records: List[Dict] = []

    def update(self, patient_id: str, pred: np.ndarray, gt: np.ndarray,
               voxel_spacing: Optional[Sequence[float]] = None):
        """pred/gt: int volumes [S,H,W] (or [H,W])."""
        rec: Dict[str, object] = {"patient_id": patient_id}
        for ci, cname in enumerate(self.class_names, start=1):
            p = pred == ci
            g = gt == ci
            for metric in self.metrics_list:
                key = f"{cname}_{metric}"
                if metric == "Dice":
                    rec[key] = dice(p, g)
                elif metric == "HD":
                    sp2d = voxel_spacing[-2:] if voxel_spacing is not None else None
                    if p.ndim == 3:
                        rec[key] = hd_2d_stack(p, g, sp2d)
                    else:
                        rec[key] = (hausdorff_distance(p, g, sp2d)
                                    if p.any() and g.any() else 0.0)
                elif metric == "HD95":
                    rec[key] = (hd95(p, g, voxel_spacing)
                                if p.any() and g.any() else 0.0)
                elif metric == "ASD":
                    rec[key] = (asd(p, g, voxel_spacing)
                                if p.any() and g.any() else 0.0)
                elif metric == "VS":
                    rec[key] = volume_similarity(p, g)
                elif metric == "VolError":
                    rec[key] = ravd(p, g)
                else:
                    raise ValueError(metric)
        self.records.append(rec)

    def columns(self) -> List[str]:
        """The metric columns (every column but patient_id)."""
        return [c for c in table_columns(self.records) if c != "patient_id"]

    def summary(self):
        """(columns, means, stds) over patients for each class, Dice first —
        the shape consumed by the test wrappers (test_ACDC…:135-182); NaN
        values are skipped, as pandas does."""
        cols = self.columns()
        stats = [nan_mean_std([r.get(c, np.nan) for r in self.records]) for c in cols]
        return cols, [m for m, _ in stats], [sd for _, sd in stats]

    def save_csv(self, path: str):
        write_csv(path, self.records)

    def reset(self):
        self.records = []
