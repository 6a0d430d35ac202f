"""Pairwise binary-segmentation measures — the niftynet-style API surface.

The port's copy of ``maxstyle_tpu/utils/pairwise_measures.py``, over the
port's ``metrics.py``.

≙ common_utils/hausdorff_util.py:14-612 (PairwiseMeasures + the regression
variant) — off the main evaluation path (SURVEY §2.6) but part of the
library surface. Distance/overlap primitives delegate to ``metrics``; the count/rate/center-of-mass/connected-component family is
implemented here with vectorized numpy (the reference's per-label Python
loops become np.isin masks). Selection, header and to_string follow the
reference's `m_dict` protocol so downstream CSV tooling carries over.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from scipy import ndimage

from maxstyle_tpu_torch import metrics


class PairwiseMeasures:
    """All measures of hausdorff_util.PairwiseMeasures:92-563 for a binary
    (seg, ref) pair. `measures` selects the m_dict subset used by
    header_str/to_string; `num_neighbors` sets the connected-component
    connectivity (8 = full 2D neighborhood, as the reference defaults)."""

    def __init__(self, seg: np.ndarray, ref: np.ndarray,
                 measures: Optional[Sequence[str]] = None,
                 num_neighbors: int = 8,
                 pixdim: Optional[Sequence[float]] = None,
                 list_labels: Optional[Sequence[int]] = None):
        self.seg = np.asarray(seg).astype(bool)
        self.ref = np.asarray(ref).astype(bool)
        self.pixdim = tuple(pixdim) if pixdim is not None else None
        self.neigh = num_neighbors
        self._list_labels = list_labels
        self.m_dict = {
            "ref volume": (self.n_pos_ref, "Volume (Ref)"),
            "seg volume": (self.n_pos_seg, "Volume (Seg)"),
            "ref bg volume": (self.n_neg_ref, "Volume (Ref bg)"),
            "seg bg volume": (self.n_neg_seg, "Volume (Seg bg)"),
            "fp": (self.fp, "FP"),
            "fn": (self.fn, "FN"),
            "tp": (self.tp, "TP"),
            "tn": (self.tn, "TN"),
            "n_intersection": (self.n_intersection, "Intersection"),
            "n_union": (self.n_union, "Union"),
            "sensitivity": (self.sensitivity, "Sens"),
            "specificity": (self.specificity, "Spec"),
            "accuracy": (self.accuracy, "Acc"),
            "fpr": (self.false_positive_rate, "FPR"),
            "ppv": (self.positive_predictive_values, "PPV"),
            "npv": (self.negative_predictive_values, "NPV"),
            "dice": (self.dice_score, "Dice"),
            "IoU": (self.intersection_over_union, "IoU"),
            "jaccard": (self.jaccard, "Jaccard"),
            "informedness": (self.informedness, "Informedness"),
            "markedness": (self.markedness, "Markedness"),
            "vol_diff": (self.vol_diff, "VolDiff"),
            "ave_dist": (self.measured_average_distance, "AveDist"),
            "haus_dist": (self.measured_hausdorff_distance, "HausDist"),
            "connected_elements": (self.connected_elements, "TPc,FPc,FNc"),
            "outline_error": (self.outline_error, "OER,OEFP,OEFN"),
            "detection_error": (self.detection_error, "DE,DEFP,DEFN"),
            "com_dist": (self.com_dist, "COM distance"),
            "com_ref": (self.com_ref, "COM reference"),
            "com_seg": (self.com_seg, "COM segmentation"),
            "list_labels": (self.list_labels, "List Labels Seg"),
        }
        self.measures = (list(measures) if measures is not None
                         else list(self.m_dict))

    # --- voxel counts (hausdorff_util:210-247) -----------------------------
    def n_pos_ref(self):
        return int(np.count_nonzero(self.ref))

    def n_neg_ref(self):
        return int(self.ref.size - np.count_nonzero(self.ref))

    def n_pos_seg(self):
        return int(np.count_nonzero(self.seg))

    def n_neg_seg(self):
        return int(self.seg.size - np.count_nonzero(self.seg))

    def tp(self):
        return int(np.count_nonzero(self.seg & self.ref))

    def tn(self):
        return int(np.count_nonzero(~self.seg & ~self.ref))

    def fp(self):
        return int(np.count_nonzero(self.seg & ~self.ref))

    def fn(self):
        return int(np.count_nonzero(~self.seg & self.ref))

    def n_intersection(self):
        return self.tp()

    def n_union(self):
        return int(np.count_nonzero(self.seg | self.ref))

    # --- rates (:250-320) ---------------------------------------------------
    def sensitivity(self):
        return metrics.sensitivity(self.seg, self.ref)

    def specificity(self):
        return metrics.specificity(self.seg, self.ref)

    def accuracy(self):
        return (self.tp() + self.tn()) / self.seg.size

    def false_positive_rate(self):
        n = self.n_neg_ref()
        return self.fp() / n if n else np.nan

    def positive_predictive_values(self):
        n = self.n_pos_seg()
        return self.tp() / n if n else np.nan

    def negative_predictive_values(self):
        n = self.n_neg_seg()
        return self.tn() / n if n else np.nan

    def precision(self):
        return metrics.precision(self.seg, self.ref)

    def dice_score(self):
        return metrics.dice(self.seg, self.ref)

    def jaccard(self):
        return metrics.jaccard(self.seg, self.ref)

    def intersection_over_union(self):
        u = self.n_union()
        return self.n_intersection() / u if u else np.nan

    def informedness(self):
        return self.sensitivity() + self.specificity() - 1.0

    def markedness(self):
        return (self.positive_predictive_values()
                + self.negative_predictive_values() - 1.0)

    # --- volume / center of mass (:321-370) ----------------------------------
    def vol_diff(self):
        vr = self.n_pos_ref()
        return abs(self.n_pos_seg() - vr) / vr if vr else np.nan

    def relative_volume_difference(self):
        return metrics.ravd(self.seg, self.ref)

    def _raw_coms(self):
        """Cached voxel-space centers of mass (one pass per mask)."""
        if not hasattr(self, "_coms"):
            cr = np.asarray(ndimage.center_of_mass(self.ref), np.float64)
            cs = (np.asarray(ndimage.center_of_mass(self.seg), np.float64)
                  if self.seg.any() else np.full(self.seg.ndim, np.nan))
            self._coms = (cr, cs)
        return self._coms

    def com_ref(self):
        """pixdim-scaled (physical units), as the reference (:337-344 —
        note the reference scales com_ref but NOT com_seg; both behaviors
        are preserved here for CSV comparability)."""
        com = self._raw_coms()[0]
        if self.pixdim is not None:
            com = com * np.asarray(self.pixdim[:self.seg.ndim])
        return tuple(com)

    def com_seg(self):
        """Voxel units (the reference does not scale this one, :346-354)."""
        return tuple(self._raw_coms()[1])

    def com_dist(self):
        """Euclidean COM distance, pixdim-scaled (:321-336); computed from
        the raw (unscaled) centers like the reference."""
        if not (self.seg.any() and self.ref.any()):
            return -1.0
        cr, cs = self._raw_coms()
        scale = (np.asarray(self.pixdim[:self.seg.ndim])
                 if self.pixdim is not None else 1.0)
        return float(np.sqrt(np.sum((scale * (cr - cs)) ** 2)))

    def list_labels(self):
        """The label ids this binary pair was extracted from — supplied by
        the caller like the reference's constructor argument
        (hausdorff_util.py:94-136, 356-360); empty when not provided."""
        if self._list_labels is None:
            return ()
        return tuple(np.unique(np.asarray(self._list_labels)))

    # --- border / distance (:381-442) ----------------------------------------
    def border_map(self, binary: np.ndarray) -> np.ndarray:
        """Voxels of the mask with at least one orthogonal background
        neighbor — equivalent to the reference's 6-neighbor shift-sum trick
        (MorphologyOps.border_map:25-38: `cumulative < 6` on zero-filled
        shifts == erosion complement with the cross structure and
        border_value=0)."""
        conn = ndimage.generate_binary_structure(binary.ndim, 1)
        return binary ^ ndimage.binary_erosion(binary, conn)

    def _border_distances(self):
        """(ref_border_dist, seg_border_dist) per the reference's niftynet
        formulation (border_distance:381-399): UNSCALED euclidean distance
        transforms of each mask's complement, masked by the OTHER mask's
        border. Note the reference applies no pixdim scaling here — kept
        for CSV parity."""
        if not hasattr(self, "_bd"):
            border_ref = self.border_map(self.ref)
            border_seg = self.border_map(self.seg)
            distance_ref = ndimage.distance_transform_edt(~self.ref)
            distance_seg = ndimage.distance_transform_edt(~self.seg)
            self._bd = (border_seg * distance_ref, border_ref * distance_seg,
                        border_ref, border_seg)
        return self._bd

    def measured_hausdorff_distance(self):
        """max over both directed border-distance maps (measured_distance
        :401-413)."""
        ref_bd, seg_bd, _, _ = self._border_distances()
        return float(np.max([np.max(ref_bd), np.max(seg_bd)]))

    def measured_hausdorff_distance_95(self):
        """95th-percentile variant (niftynet convention; the reference's
        vendored copy dropped it — retained as the same border formulation
        over the nonzero directed distances)."""
        ref_bd, seg_bd, border_ref, border_seg = self._border_distances()
        a = ref_bd[border_seg > 0]
        b = seg_bd[border_ref > 0]
        if a.size == 0 or b.size == 0:
            return -1.0
        return float(np.max([np.percentile(a, 95), np.percentile(b, 95)]))

    def measured_average_distance(self):
        """(sum of both directed maps) / (sum of BOTH MASK VOLUMES) — the
        reference's exact (idiosyncratic) normalizer, measured_distance
        :408-410: np.sum(self.ref + self.seg)."""
        ref_bd, seg_bd, _, _ = self._border_distances()
        denom = float(np.sum(self.ref.astype(np.int64)
                             + self.seg.astype(np.int64)))
        if denom == 0:
            return -1.0
        return float((np.sum(ref_bd) + np.sum(seg_bd)) / denom)

    # --- connected-component errors (:443-543, Wack et al.) ------------------
    # NOTE one deliberate deviation: the reference enumerates components
    # with range(1, n_blobs) (:469-470), silently dropping the
    # highest-numbered component from the FP/FN counts — an off-by-one.
    # Here ALL components are counted.
    def _connectivity(self):
        # neigh=8 -> full connectivity; otherwise orthogonal-only
        order = self.seg.ndim if self.neigh >= 8 else 1
        return ndimage.generate_binary_structure(self.seg.ndim, order)

    def _connected(self):
        """Cached (labeled_ref, labeled_seg, intersection, tp_ref_labels,
        tp_seg_labels) — the reference memoizes via CacheFunctionOutput;
        every CC measure reuses one labeling pass."""
        if not hasattr(self, "_cc"):
            conn = self._connectivity()
            blobs_ref, _ = ndimage.label(self.ref, conn)
            blobs_seg, _ = ndimage.label(self.seg, conn)
            init = self.seg & self.ref
            tp_ref = np.unique(blobs_ref[init])
            tp_seg = np.unique(blobs_seg[init])
            self._cc = (blobs_ref, blobs_seg, init,
                        tp_ref[tp_ref > 0], tp_seg[tp_seg > 0])
        return self._cc

    def connected_errormaps(self):
        """(TPc, FNc, FPc) component maps: a component counts as TP if it
        touches the intersection; FN/FP components touch nothing. Cached."""
        if not hasattr(self, "_cc_maps"):
            blobs_ref, blobs_seg, init, tp_ref, tp_seg = self._connected()
            tpc = (np.isin(blobs_ref, tp_ref) & self.ref) | \
                  (np.isin(blobs_seg, tp_seg) & self.seg)
            fnc = self.ref & ~np.isin(blobs_ref, tp_ref)
            fpc = self.seg & ~np.isin(blobs_seg, tp_seg)
            self._cc_maps = (tpc.astype(np.int32), fnc.astype(np.int32),
                             fpc.astype(np.int32))
        # copies: callers may mutate without poisoning the cache
        return tuple(m.copy() for m in self._cc_maps)

    def connected_elements(self):
        """(#TP, #FP, #FN) counted as whole components (:461-480)."""
        blobs_ref, blobs_seg, _, tp_ref, tp_seg = self._connected()
        return (len(tp_ref), int(blobs_seg.max() - len(tp_seg)),
                int(blobs_ref.max() - len(tp_ref)))

    def outline_error(self):
        """(OER, OEFP, OEFN) outline error of Wack et al. (:513-530)."""
        tpc, _, _ = self.connected_errormaps()
        oef = self.ref.astype(np.int32) - tpc * self.seg.astype(np.int32)
        oefn = int(np.count_nonzero(oef == 1))
        oefp = int(np.count_nonzero(oef == -1))
        denom = self.n_pos_seg() + self.n_pos_ref()
        oer = 2.0 * (oefn + oefp) / denom if denom else np.nan
        return oer, oefp, oefn

    def detection_error(self):
        """(DE, DEFP, DEFN) detection error of Wack et al. (:532-543)."""
        _, fnc, fpc = self.connected_errormaps()
        defn = int(fnc.sum())
        defp = int(fpc.sum())
        return defn + defp, defp, defn

    # --- reporting protocol (:545-563) ----------------------------------------
    def header_str(self) -> str:
        return "," + ",".join(self.m_dict[m][1] for m in self.measures)

    # tuple measures whose HEADER is a single cell: joined with spaces so
    # row cells always align with header_str (the reference comma-joins
    # these too, misaligning its own CSVs — deliberate fix)
    _SINGLE_CELL = frozenset({"com_ref", "com_seg", "list_labels"})

    # count-type measures: the reference prints these as raw python ints
    # (connected_elements/detection_error counts, label lists) rather than
    # float-formatting them — match that in CSV rows
    _INT_MEASURES = frozenset({"connected_elements", "detection_error",
                               "list_labels"})

    def to_string(self, fmt: str = "{:.4f}") -> str:
        def cell(m, v):
            v = float(v)
            if m in self._INT_MEASURES and v.is_integer():
                return str(int(v))
            return fmt.format(v)

        cells = []
        for m in self.measures:
            val = self.m_dict[m][0]()
            if isinstance(val, (tuple, list, np.ndarray)):
                sep = " " if m in self._SINGLE_CELL else ","
                cells.append(sep.join(cell(m, v) for v in val))
            else:
                cells.append(cell(m, val))
        return "," + ",".join(cells)

    def to_dict(self) -> dict:
        return {
            "dice": self.dice_score(), "jaccard": self.jaccard(),
            "sensitivity": self.sensitivity(),
            "specificity": self.specificity(), "precision": self.precision(),
            "hd": self.measured_hausdorff_distance(),
            "hd95": self.measured_hausdorff_distance_95(),
            "assd": self.measured_average_distance(),
            "vol_diff": self.vol_diff(),
        }


class RegressionMeasures:
    """hausdorff_util.PairwiseMeasuresRegression:566-607 — intensity
    regression metrics between a registered/reconstructed image and its
    reference."""

    def __init__(self, reg: np.ndarray, ref: np.ndarray,
                 measures: Optional[Sequence[str]] = None):
        self.reg = np.asarray(reg, np.float64)
        self.ref = np.asarray(ref, np.float64)
        self.m_dict = {
            "mse": (self.mse, "MSE"),
            "rmse": (self.rmse, "RMSE"),
            "mae": (self.mae, "MAE"),
            "r2": (self.r2, "R2"),
        }
        self.measures = (list(measures) if measures is not None
                         else list(self.m_dict))

    def mse(self):
        return float(np.mean((self.reg - self.ref) ** 2))

    def rmse(self):
        return float(np.sqrt(self.mse()))

    def mae(self):
        return float(np.mean(np.abs(self.reg - self.ref)))

    def r2(self):
        """Squared Pearson correlation — the reference's formula
        (hausdorff_util.py:584-591), NOT the coefficient of determination:
        a constant intensity bias still yields r2 ~= 1."""
        ref_c = self.ref - np.mean(self.ref)
        reg_c = self.reg - np.mean(self.reg)
        denom = np.sqrt(np.sum(ref_c ** 2) * np.sum(reg_c ** 2) + 1e-5)
        return float(np.square(np.sum(ref_c * reg_c) / denom))

    def header_str(self) -> str:
        return "," + ",".join(self.m_dict[m][1] for m in self.measures)

    def to_string(self, fmt: str = "{:.4f}") -> str:
        return "," + ",".join(fmt.format(self.m_dict[m][0]())
                              for m in self.measures)
