"""MR artefact simulation for robustness test-set generation (numpy, host).

The port's copy of ``maxstyle_tpu/data/artefacts.py``, which replaces the
torchio transforms of the reference's artefacted-ACDC benchmark generator
(dataset_loader/generate_artefacted_data.py:39-111: RandomMotion(degrees=30,
translation=10), RandomSpike, RandomGhosting, RandomBiasField applied to the
test patients). Each artefact is implemented from its k-space definition:

* motion  — the acquisition is split into time bins; each bin's k-space
  lines come from a rigidly-moved copy of the volume.
* spike   — random high-intensity points added in k-space.
* ghosting— every n-th k-space line along one axis attenuated/modulated,
  producing fold-over ghosts.
* bias    — smooth multiplicative polynomial bias field.

Like ``preprocess`` and ``clahe``, this is a host tool: numpy and scipy on
the host on every machine, the JAX package's arithmetic bit for bit, with no
``--device`` flag.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import ndimage


def _rigid_move(sl: np.ndarray, angle_deg: float, shift: Tuple[float, float]
                ) -> np.ndarray:
    out = ndimage.rotate(sl, angle_deg, reshape=False, order=1, mode="nearest")
    return ndimage.shift(out, shift, order=1, mode="nearest")


def random_motion(volume: np.ndarray, rng: np.random.RandomState,
                  degrees: float = 30.0, translation: float = 10.0,
                  num_transforms: int = 2) -> np.ndarray:
    """Per-slice k-space mixture of rigidly-moved copies."""
    out = np.empty_like(volume, dtype=np.float32)
    for s in range(volume.shape[0]):
        sl = volume[s].astype(np.float32)
        ks = [np.fft.fft2(sl)]
        for _ in range(num_transforms):
            ang = rng.uniform(-degrees, degrees)
            sh = rng.uniform(-translation, translation, size=2)
            ks.append(np.fft.fft2(_rigid_move(sl, ang, tuple(sh))))
        h = sl.shape[0]
        # contiguous phase-encode bins assigned to successive positions
        bins = np.sort(rng.choice(np.arange(1, h), size=len(ks) - 1,
                                  replace=False))
        composite = np.empty_like(ks[0])
        start = 0
        for k, stop in zip(ks, list(bins) + [h]):
            composite[start:stop] = k[start:stop]
            start = stop
        out[s] = np.abs(np.fft.ifft2(composite))
    return out


def random_spike(volume: np.ndarray, rng: np.random.RandomState,
                 num_spikes: int = 1, intensity: float = 0.3) -> np.ndarray:
    """High-intensity k-space points -> striping artefacts."""
    out = np.empty_like(volume, dtype=np.float32)
    for s in range(volume.shape[0]):
        sl = volume[s].astype(np.float32)
        k = np.fft.fftshift(np.fft.fft2(sl))
        h, w = k.shape
        mag = np.abs(k).max()
        for _ in range(num_spikes):
            # spikes away from DC
            y = rng.randint(h // 8, h - h // 8)
            x = rng.randint(w // 8, w - w // 8)
            phase = rng.uniform(0, 2 * np.pi)
            k[y, x] += intensity * mag * np.exp(1j * phase)
        out[s] = np.abs(np.fft.ifft2(np.fft.ifftshift(k)))
    return out


def random_ghosting(volume: np.ndarray, rng: np.random.RandomState,
                    num_ghosts: int = 4, intensity: float = 0.5,
                    axis: Optional[int] = None) -> np.ndarray:
    """Attenuate every n-th k-space line -> fold-over ghosts."""
    out = np.empty_like(volume, dtype=np.float32)
    ax = axis if axis is not None else rng.randint(0, 2)
    for s in range(volume.shape[0]):
        sl = volume[s].astype(np.float32)
        k = np.fft.fft2(sl)
        idx = np.arange(k.shape[ax])
        mask = np.ones(k.shape[ax], np.complex64)
        sel = (idx % num_ghosts == 0) & (idx != 0)
        mask[sel] = 1.0 - intensity
        k = k * (mask[:, None] if ax == 0 else mask[None, :])
        out[s] = np.abs(np.fft.ifft2(k))
    return out


def random_bias_field(volume: np.ndarray, rng: np.random.RandomState,
                      coefficients: float = 0.5, order: int = 3) -> np.ndarray:
    """Smooth polynomial multiplicative bias field (log-linear combination
    of monomials up to `order`)."""
    s, h, w = volume.shape
    y = np.linspace(-1, 1, h)[:, None]
    x = np.linspace(-1, 1, w)[None, :]
    field = np.zeros((h, w), np.float32)
    for i in range(order + 1):
        for j in range(order + 1 - i):
            if i == 0 and j == 0:
                continue
            c = rng.uniform(-coefficients, coefficients)
            field += c * (y ** i) * (x ** j)
    bias = np.exp(field)[None]
    return (volume.astype(np.float32) * bias).astype(np.float32)


ARTEFACTS = {
    "RandomMotion": random_motion,
    "RandomSpike": random_spike,
    "RandomGhosting": random_ghosting,
    "RandomBias": random_bias_field,
}


def generate_artefacted_suite(src_dataset, out_root: str, artefact: str,
                              seed: int = 2021, repeats: int = 3) -> None:
    """Write an artefacted copy of a dataset's test patients
    ({out_root}/{pid}/img.nii.gz + seg.nii.gz), `repeats` corrupted copies
    per patient (generate_artefacted_data.py:57-111)."""
    import os

    from maxstyle_tpu_torch.data import medio
    rng = np.random.RandomState(seed)
    fn = ARTEFACTS[artefact]
    for pid in src_dataset.patient_ids:
        vol, lab, spacing = src_dataset.get_patient_volume(pid,
                                                           normalize_2d=False)
        for r in range(repeats):
            out_pid = f"{pid}_r{r}"
            out_dir = os.path.join(out_root, out_pid)
            os.makedirs(out_dir, exist_ok=True)
            corrupted = fn(vol, rng)
            medio.write_nifti(os.path.join(out_dir, "img.nii.gz"), corrupted,
                              spacing=spacing)
            medio.write_nifti(os.path.join(out_dir, "seg.nii.gz"),
                              lab.astype(np.uint8), spacing=spacing)


def main(argv=None):
    """CLI mirror of generate_artefacted_data.py: corrupt a test set's
    patients with one artefact family (or all four) and write an
    artefacted copy under --out_root/<artefact>/.

    Usage: python -m maxstyle_tpu_torch.data.artefacts --root_dir <test_set> \
             --image_format "{pid}/img.nii.gz" --label_format "{pid}/seg.nii.gz" \
             --out_root <dir> \
             [--artefact all|RandomMotion|RandomSpike|RandomGhosting|RandomBias]
    (lowercase aliases motion/spike/ghosting/bias are accepted too)
    """
    import argparse
    import os

    from maxstyle_tpu_torch.data.datasets import build_general_dataset

    ap = argparse.ArgumentParser()
    ap.add_argument("--root_dir", type=str, required=True)
    ap.add_argument("--image_format", type=str, default="{pid}/img.nii.gz")
    ap.add_argument("--label_format", type=str, default="{pid}/seg.nii.gz")
    ap.add_argument("--out_root", type=str, required=True)
    aliases = {k.replace("Random", "").lower(): k for k in ARTEFACTS}
    ap.add_argument("--artefact", type=str, default="all",
                    choices=["all", *ARTEFACTS, *aliases])
    ap.add_argument("--crop", type=int, nargs=2, default=(192, 192))
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=2021)
    opt = ap.parse_args(argv)

    ds = build_general_dataset(opt.root_dir, opt.image_format,
                               opt.label_format, pad_hw=tuple(opt.crop),
                               crop_hw=tuple(opt.crop))
    kinds = (list(ARTEFACTS) if opt.artefact == "all"
             else [aliases.get(opt.artefact, opt.artefact)])
    for kind in kinds:
        out = os.path.join(opt.out_root, kind)
        generate_artefacted_suite(ds, out, kind, seed=opt.seed,
                                  repeats=opt.repeats)
        print(f"{kind}: wrote {len(ds.patient_ids) * opt.repeats} volumes "
              f"-> {out}")


if __name__ == "__main__":
    main()
