"""Offline dataset preprocessing (host, CLI).

The port's copy of ``maxstyle_tpu/data/preprocess.py``, over the port's
``medio`` (the same NRRD bytes). ≙ dataset_loader/acdc_preprocess.py:17-153: per-frame (ED/ES) resampling to
1.36719 mm in-plane, 2/98-percentile min-max normalization, the ACDC LV/RV
label swap (:137-138), NRRD output `{out}/{frame}/{pid}_img.nrrd` +
`{pid}_seg.nrrd`. N4 bias correction (disabled in the reference main too)
requires SimpleITK and is gated.

Usage:
  python -m maxstyle_tpu_torch.data.preprocess --src raw/ --out preprocessed/ \
      [--spacing 1.36719 1.36719 -1] [--swap_lv_rv]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from maxstyle_tpu_torch.data import medio


def percentile_normalize(volume: np.ndarray, lo: float = 2.0,
                         hi: float = 98.0) -> np.ndarray:
    """Volume-level percentile clip + min-max to [0,1]
    (dataset_utils.py:15-35)."""
    v = volume.astype(np.float32)
    mn, mx = np.percentile(v, [lo, hi])
    return np.clip((v - mn) / max(mx - mn, 1e-8), 0.0, 1.0)


def swap_labels(label: np.ndarray, a: int = 1, b: int = 3) -> np.ndarray:
    """ACDC LV/RV convention swap (acdc_preprocess.py:137-138)."""
    out = label.copy()
    out[label == a] = b
    out[label == b] = a
    return out


def n4_bias_correction(volume: np.ndarray) -> np.ndarray:
    """Optional N4 (acdc_preprocess.py:72-81 — disabled there as well);
    needs SimpleITK."""
    try:
        import SimpleITK as sitk
    except ImportError as e:
        raise RuntimeError("N4 bias correction requires SimpleITK") from e
    img = sitk.GetImageFromArray(volume.astype(np.float32))
    mask = sitk.OtsuThreshold(img, 0, 1, 200)
    corrected = sitk.N4BiasFieldCorrection(img, mask)
    return sitk.GetArrayFromImage(corrected)


def preprocess_volume(img_path: str, lab_path: str, out_img: str, out_lab: str,
                      new_spacing=(1.36719, 1.36719, -1.0),
                      swap_lv_rv: bool = False, n4: bool = False) -> None:
    img, spacing = medio.read_volume(img_path)
    lab, _ = medio.read_volume(lab_path)
    if n4:
        img = n4_bias_correction(img)
    img, out_spacing = medio.resample_by_spacing(img, spacing, new_spacing)
    lab, _ = medio.resample_by_spacing(lab, spacing, new_spacing, label=True)
    img = percentile_normalize(img)
    lab = lab.astype(np.uint8)
    if swap_lv_rv:
        lab = swap_labels(lab)
    medio.write_nrrd(out_img, img, spacing=out_spacing)
    medio.write_nrrd(out_lab, lab, spacing=out_spacing)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", required=True,
                        help="root with {pid}/{frame}_img.nii.gz pairs")
    parser.add_argument("--out", required=True)
    parser.add_argument("--image_suffix", default="img.nii.gz")
    parser.add_argument("--label_suffix", default="seg.nii.gz")
    parser.add_argument("--frames", nargs="*", default=["ED", "ES"])
    parser.add_argument("--spacing", nargs=3, type=float,
                        default=[1.36719, 1.36719, -1.0])
    parser.add_argument("--swap_lv_rv", action="store_true")
    parser.add_argument("--n4", action="store_true")
    opt = parser.parse_args(argv)

    for pid in sorted(os.listdir(opt.src)):
        pdir = os.path.join(opt.src, pid)
        if not os.path.isdir(pdir):
            continue
        for frame in opt.frames:
            img_path = os.path.join(pdir, f"{frame}_{opt.image_suffix}")
            lab_path = os.path.join(pdir, f"{frame}_{opt.label_suffix}")
            if not (os.path.exists(img_path) and os.path.exists(lab_path)):
                continue
            out_dir = os.path.join(opt.out, frame)
            os.makedirs(out_dir, exist_ok=True)
            preprocess_volume(img_path, lab_path,
                              os.path.join(out_dir, f"{pid}_img.nrrd"),
                              os.path.join(out_dir, f"{pid}_seg.nrrd"),
                              new_spacing=tuple(opt.spacing),
                              swap_lv_rv=opt.swap_lv_rv, n4=opt.n4)
            print(f"preprocessed {pid} {frame}")


if __name__ == "__main__":
    main()
