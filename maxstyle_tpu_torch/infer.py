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
``--data_parallel`` under ``python -m torch.distributed.run
--nproc_per_node=N -m maxstyle_tpu_torch.infer --data_parallel ...`` rounds
the chunk up to a multiple of the ranks; each rank predicts its rows of a
chunk, the probabilities are gathered, and rank 0 writes (NCCL on
``cuda:LOCAL_RANK``, gloo with ``--device cpu``; outside such a launch the
flag runs on one device).
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
    from maxstyle_tpu_torch.parallel import mesh as pmesh
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
                        help="shard slice chunks over the ranks of a torch.distributed.run "
                             "launch")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; the GPU by default ('cpu' to run on the CPU)")
    opt = parser.parse_args(argv)

    cfg = (ExperimentConfig.from_json(opt.json_config_path) if opt.json_config_path
           else ExperimentConfig())
    grid = pmesh.init_from_env(opt.device) if opt.data_parallel else None
    solver = config_solver(cfg, pmesh.device_of(grid, opt.device))
    writer = pmesh.is_writer(grid)
    if grid is not None:
        opt.chunk = -(-opt.chunk // grid.data_parallel) * grid.data_parallel
        if writer:
            print(f"data-parallel inference over {grid.data_parallel} ranks, "
                  f"chunk {opt.chunk}")
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
            with pmesh.sharded(grid):
                probs = pmesh.gather_rows(solver.predict(
                    state.modules, pmesh.local_rows(x), softmax=True,
                    normalize_input=False))[:n]
            pred_parts.append(probs.argmax(-1).to(torch.uint8).cpu().numpy())
            if opt.uncertainty:
                ent = entropy_map(torch.log(torch.clamp(probs, 1e-8, 1.0)))
                ent_parts.append(ent.float().cpu().numpy())
        pred = np.concatenate(pred_parts, 0)
        n_slices += s
        if not writer:
            continue
        if opt.keep_largest_cc:
            pred = keep_largest_connected_components(pred).astype(np.uint8)
        medio.write_nrrd(os.path.join(opt.out_dir, f"{pid}_pred.nrrd"), pred,
                         spacing=spacing)
        if opt.uncertainty:
            medio.write_nrrd(os.path.join(opt.out_dir, f"{pid}_entropy.nrrd"),
                             np.concatenate(ent_parts, 0), spacing=spacing)
        print(f"{pid}: {s} slices")
    dt = time.time() - t0
    pmesh.barrier(grid)
    if writer:
        print(f"segmented {len(ds.patient_ids)} volumes ({n_slices} slices) "
              f"in {dt:.2f}s ({n_slices / dt:.1f} slices/s)")


if __name__ == "__main__":
    main()
