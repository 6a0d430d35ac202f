"""Batch inference / serving CLI.

Counterpart of ``maxstyle_tpu/infer.py``: load a checkpoint, segment every
volume under a directory in fixed-size chunks of slices, write NRRD
predictions (+ optional entropy uncertainty maps) and print slices/s. The
softmax, argmax and entropy run on the device; a chunk's outputs come to the
host in one copy each.

Usage:
  python -m maxstyle_tpu_torch.infer --ckpt_dir saved/.../model --ckpt best \\
      --input_dir data/site --image_format "{pid}/img.nii.gz" \\
      --out_dir predictions [--uncertainty] [--keep_largest_cc] [--device cpu]

It runs on the GPU unless ``--device`` names another device.
``--torch_ckpt_dir`` takes the reference's per-module ``.pth`` files instead
of a checkpoint (a module without a file keeps its seed-0 weights).
``--data_parallel`` is not ported yet (ROADMAP Queue 1 item 8) and raises.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def main(argv=None):
    from maxstyle_tpu_torch.config import ExperimentConfig
    from maxstyle_tpu_torch.data import medio
    from maxstyle_tpu_torch.data.datasets import SliceDataset
    from maxstyle_tpu_torch.flagship import config_solver
    from maxstyle_tpu_torch.train import not_ported
    from maxstyle_tpu_torch.utils import checkpoint as ckpt
    from maxstyle_tpu_torch.utils.postprocess import keep_largest_connected_components
    from maxstyle_tpu_torch.utils.torch_import import import_module_checkpoints
    from maxstyle_tpu_torch.utils.uncertainty import entropy_map

    parser = argparse.ArgumentParser()
    parser.add_argument("--json_config_path", type=str, default=None,
                        help="experiment config (defaults to the flagship)")
    parser.add_argument("--ckpt_dir", type=str, default=None)
    parser.add_argument("--ckpt", type=str, default="best")
    parser.add_argument("--torch_ckpt_dir", type=str, default=None,
                        help="directory of reference per-module .pth files")
    parser.add_argument("--input_dir", type=str, required=True)
    parser.add_argument("--image_format", type=str, default="{pid}/img.nii.gz")
    parser.add_argument("--label_format", type=str, default=None,
                        help="optional labels: report Dice when provided")
    parser.add_argument("--out_dir", type=str, required=True)
    parser.add_argument("--chunk", type=int, default=25)
    parser.add_argument("--crop", type=int, nargs=2, default=None)
    parser.add_argument("--uncertainty", action="store_true")
    parser.add_argument("--keep_largest_cc", action="store_true")
    parser.add_argument("--data_parallel", action="store_true",
                        help="shard slice chunks over all devices (not ported yet)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; the GPU by default ('cpu' to run on the CPU)")
    opt = parser.parse_args(argv)
    if opt.data_parallel:
        raise not_ported("--data_parallel", 8, "parallelism")

    cfg = (ExperimentConfig.from_json(opt.json_config_path) if opt.json_config_path
           else ExperimentConfig())
    solver = config_solver(cfg, opt.device)
    dev = solver.device
    crop_hw = tuple(opt.crop) if opt.crop else cfg.crop_hw

    state = solver.init_state(0)
    if opt.ckpt_dir:
        state, _ = ckpt.load_checkpoint(opt.ckpt_dir, opt.ckpt, state)
    elif opt.torch_ckpt_dir:
        import_module_checkpoints(state.modules, opt.torch_ckpt_dir, solver.spec)

    label_format = opt.label_format or opt.image_format  # labels optional
    ds = SliceDataset(opt.input_dir, sorted(os.listdir(opt.input_dir)),
                      opt.image_format, label_format, pad_hw=crop_hw, crop_hw=crop_hw,
                      ignore_black_slice=False)

    os.makedirs(opt.out_dir, exist_ok=True)
    t0 = time.time()
    n_slices = 0
    for pid in ds.patient_ids:
        vol, _, spacing = ds.get_patient_volume(pid)
        s = vol.shape[0]
        pred_parts, ent_parts = [], []
        for start in range(0, s, opt.chunk):
            part = vol[start:start + opt.chunk]
            n = part.shape[0]
            if n < opt.chunk:
                part = np.concatenate(
                    [part, np.zeros((opt.chunk - n, *part.shape[1:]), part.dtype)], 0)
            x = torch.from_numpy(np.ascontiguousarray(part[..., None])).to(dev)
            probs = solver.predict(state.modules, x, softmax=True, normalize_input=False)[:n]
            pred_parts.append(probs.argmax(-1).to(torch.uint8).cpu().numpy())
            if opt.uncertainty:
                ent = entropy_map(torch.log(torch.clamp(probs, 1e-8, 1.0)))
                ent_parts.append(ent.float().cpu().numpy())
        pred = np.concatenate(pred_parts, 0)
        if opt.keep_largest_cc:
            pred = keep_largest_connected_components(pred).astype(np.uint8)
        medio.write_nrrd(os.path.join(opt.out_dir, f"{pid}_pred.nrrd"), pred,
                         spacing=spacing)
        if opt.uncertainty:
            medio.write_nrrd(os.path.join(opt.out_dir, f"{pid}_entropy.nrrd"),
                             np.concatenate(ent_parts, 0), spacing=spacing)
        n_slices += s
        print(f"{pid}: {s} slices")
    dt = time.time() - t0
    print(f"segmented {len(ds.patient_ids)} volumes ({n_slices} slices) "
          f"in {dt:.2f}s ({n_slices / dt:.1f} slices/s)")


if __name__ == "__main__":
    main()
