"""Device-resident dataset training — no host work a step.

Counterpart of ``maxstyle_tpu/data/device_data.py``. The reference's
headline regimes are low-data (10-subject ACDC is a few hundred 224^2
slices, about 0.1 GB with labels), so the whole training set fits on the
card. :class:`DeviceDataset` uploads every raw padded slice once; a call of
:func:`make_device_train_loop`'s loop then runs ``steps_per_call`` steps of
``make_fused_train_step`` — batch sampling, augmentation, the MaxStyle
inner loop and the optimizer update — with no copy from the host. Each step
draws ``half_batch`` distinct slice indices from a fresh permutation on the
device (``torch.randperm`` from the caller's generator) and gathers them
with ``index_select``. The mean metrics of a call stay on the device until
the caller reads them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from maxstyle_tpu_torch import native
from maxstyle_tpu_torch.solver import resolve_device


def _pack_slices(ds):
    """Bulk-pack a SliceDataset's training slices: pad each cached volume
    once, then gather every indexed slice with one native ``gather_pack``
    call. Returns None for dataset types without the raw-volume interface
    (a ConcatSliceDataset packs each part; parts of different pad sizes
    give None)."""
    if not (hasattr(ds, "slice_index") and hasattr(ds, "_load_volume")):
        if hasattr(ds, "datasets"):
            parts = [_pack_slices(d) for d in ds.datasets]
            if any(p is None for p in parts) or len({p[0].shape[1:] for p in parts}) != 1:
                return None
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        return None
    pids = list(dict.fromkeys(pid for pid, _ in ds.slice_index))
    pid_pos = {pid: i for i, pid in enumerate(pids)}
    img_vols, lab_vols = [], []
    for pid in pids:
        img, lab, _ = ds._load_volume(pid)
        img_vols.append(native.crop_or_pad(img.astype(np.float32), ds.pad_hw))
        lab_vols.append(native.crop_or_pad(lab.astype(np.int32), ds.pad_hw))
    vol_idx = np.asarray([pid_pos[pid] for pid, _ in ds.slice_index], np.int64)
    sl_idx = np.asarray([s for _, s in ds.slice_index], np.int64)
    return (native.gather_pack(img_vols, vol_idx, sl_idx),
            native.gather_pack(lab_vols, vol_idx, sl_idx))


class DeviceDataset:
    """All (padded) training slices as tensors on one device: images
    float32 [n,H,W], labels int32 [n,H,W]."""

    def __init__(self, images: torch.Tensor, labels: torch.Tensor):
        if images.dim() != 3 or labels.shape != images.shape:
            raise ValueError(f"expected images and labels of one [n,H,W] shape, got "
                             f"{tuple(images.shape)} and {tuple(labels.shape)}")
        self.images = images
        self.labels = labels

    @classmethod
    def from_slice_dataset(cls, ds, device=None) -> "DeviceDataset":
        """Upload a slice dataset's raw padded slices to ``device`` (the GPU
        by default; without one the caller has to ask for the CPU)."""
        dev = resolve_device(device)
        packed = _pack_slices(ds)
        if packed is None:
            rows = [ds.get_raw_slice(i) for i in range(len(ds))]
            packed = (np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows]))
        imgs, labs = packed
        return cls(torch.from_numpy(imgs).to(dev), torch.from_numpy(labs).to(dev))

    def __len__(self):
        return int(self.images.shape[0])

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.images, self.labels))


def make_device_train_loop(solver, policy, keep_orig: bool, half_batch: int,
                           steps_per_call: int = 32) -> Callable:
    """``run(state, images, labels, generator, overrides=None) -> (state,
    mean metrics)``: ``steps_per_call`` optimizer steps, each on
    ``half_batch`` slices sampled on the device from the resident
    ``images``/``labels``. ``overrides`` pins the draws, to hold the loop
    against a reference: {"indices": one [half_batch] index tensor a step,
    "steps": one ``make_fused_train_step`` overrides dict a step}."""
    from maxstyle_tpu_torch.train_step import make_fused_train_step
    fused = make_fused_train_step(solver, policy, keep_orig)

    def run(state, images: torch.Tensor, labels: torch.Tensor, generator: torch.Generator,
            overrides: Optional[Dict[str, Any]] = None):
        ov = overrides or {}
        n = images.shape[0]
        history = []
        for k in range(steps_per_call):
            if "indices" in ov:
                idx = ov["indices"][k].to(images.device)
            else:
                idx = torch.randperm(n, generator=generator, device=images.device)[:half_batch]
            raw = {"image": images.index_select(0, idx), "label": labels.index_select(0, idx)}
            step_ov = ov["steps"][k] if "steps" in ov else None
            state, metrics = fused(state, raw, generator, overrides=step_ov)
            history.append(metrics)
        return state, {key: torch.stack([h[key] for h in history]).mean()
                       for key in history[0]}

    return run


def train_device_resident(solver, state, dataset: DeviceDataset, policy, keep_orig: bool,
                          half_batch: int, total_steps: int, generator: torch.Generator,
                          steps_per_call: int = 32, log_fn=None):
    """Drive ``total_steps`` steps (rounded up to whole calls) of
    device-resident training; returns the final state and the last call's
    mean metrics. ``log_fn(call, metrics)`` sees each call's metrics, on
    the device."""
    if dataset.images.device.type != solver.device.type:
        raise ValueError(f"the dataset lies on {dataset.images.device}, the solver runs on "
                         f"{solver.device}")
    run = make_device_train_loop(solver, policy, keep_orig, half_batch, steps_per_call)
    metrics = None
    for c in range(-(-total_steps // steps_per_call)):
        state, metrics = run(state, dataset.images, dataset.labels, generator)
        if log_fn is not None:
            log_fn(c, metrics)
    return state, metrics
