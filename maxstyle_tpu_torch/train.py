"""Training entry point + CLI.

Counterpart of ``maxstyle_tpu/train.py`` (the reference's
train_adv_supervised_segmentation_triplet.py :92-584 ``train_network`` and
:588-959 ``__main__``): the same argparse surface, the same run-directory
layout ``{save_dir}/train_{dataset}_{setting}_n_cls_{K}/{config}/{cval}/{log,model}``
and the same per-epoch validation-mIoU model selection. The loop:

  host loader (raw padded slices) -> prefetch thread (pinned copy to the
  device, non-blocking) -> fused step (augmentation on the device, the
  aug+orig pairing, one training step).

The step's metrics stay on the device until the epoch ends, so the loop adds
no host sync to a step. Random streams are named (``prng.stream``): the
weights from (seed, "init"), one generator for every step from
(seed, "step"), and each epoch's validation draws from (seed, "val", epoch),
so that they do not depend on how many steps ran.

``python3 -m maxstyle_tpu_torch.train --json_config_path <config> ...`` runs
on the GPU; ``--device cpu`` runs on the CPU. ``--torch_ckpt_dir`` imports
the reference's per-module ``.pth`` files before training
(``utils/torch_import.py``; a module without a file keeps its fresh
weights). SGD configs get their StepLR schedule from the epoch's step
count.

``--data_parallel`` trains over the ranks of a launch of
``python -m torch.distributed.run --nproc_per_node=N -m
maxstyle_tpu_torch.train --data_parallel ...`` (NCCL on ``cuda:LOCAL_RANK``;
gloo with ``--device cpu``), with the global-batch semantics of
``parallel/mesh.py``: every rank's loader uses the one seed and takes its
rows of each global batch (which must divide over the ranks), the step is
``mesh.shard_train_step`` of the fused step, and only rank 0 writes
checkpoints, event files and CSVs. As in the JAX package it takes
precedence over ``--inner_steps``. Outside such a launch, or with one rank,
the flag runs the single-device step.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time
from typing import Dict, Optional

import numpy as np
import torch

from maxstyle_tpu_torch import prng
from maxstyle_tpu_torch.config import ExperimentConfig
from maxstyle_tpu_torch.data import augment as A
from maxstyle_tpu_torch.data.datasets import (HostBatchLoader, build_acdc_dataset,
                                              build_prostate_dataset)
from maxstyle_tpu_torch.data.prefetch import prefetch
from maxstyle_tpu_torch.flagship import config_solver
from maxstyle_tpu_torch.metrics import RunningScore
from maxstyle_tpu_torch.parallel import mesh as pmesh
from maxstyle_tpu_torch.solver import TripletSegmentationSolver
from maxstyle_tpu_torch.train_step import make_fused_train_step, make_multi_step
from maxstyle_tpu_torch.utils import checkpoint as ckpt
from maxstyle_tpu_torch.utils.tb_events import EventFileWriter
from maxstyle_tpu_torch.utils.torch_import import import_module_checkpoints


def build_datasets(cfg: ExperimentConfig, data_setting: str, cval: int):
    d = cfg.data
    pad_hw = (d.pad_size[0], d.pad_size[1])
    crop_hw = (d.crop_size[0], d.crop_size[1])
    common = dict(pad_hw=pad_hw, crop_hw=crop_hw, new_spacing=d.new_spacing,
                  image_format_name=d.image_format_name,
                  label_format_name=d.label_format_name)
    if "ACDC" in d.dataset_name:
        acdc = dict(common, frames=d.frame, myocardium_only=d.myocardium_only,
                    right_ventricle_only=d.right_ventricle_only)
        return tuple(build_acdc_dataset(d.root_dir, split, data_setting, cval, **acdc)
                     for split in ("train", "validate"))
    if "Prostate" in d.dataset_name:
        return tuple(build_prostate_dataset(d.root_dir, split, data_setting, cval, **common)
                     for split in ("train", "validate"))
    raise NotImplementedError(d.dataset_name)


def to_device(raw: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A host batch on ``device``: on a GPU through pinned memory with a
    non-blocking copy, so the caller's stream does not wait for it."""
    out = {}
    for k, v in raw.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t
    return out


def make_device_batch(raw_batch: Dict[str, torch.Tensor], generator: torch.Generator,
                      policy: A.AugPolicy, crop_hw, keep_orig: bool):
    """Raw padded slices (tensors on the generator's device) -> training
    batch: the augmented pair (+ the norm-only original pair concatenated,
    when keep_orig)."""
    images, labels = raw_batch["image"], raw_batch["label"]
    aug_img, aug_lab = A.augment_batch_inner(generator, images, labels, policy)
    if keep_orig:
        orig_img, orig_lab = A.norm_batch(images, labels, crop_hw)
        return {"image": torch.cat([aug_img, orig_img], 0),
                "label": torch.cat([aug_lab, orig_lab], 0)}
    return {"image": aug_img, "label": aug_lab}


def eval_model(solver: TripletSegmentationSolver, state, val_loader, policy, crop_hw,
               generator: torch.Generator, n_iter: int = 2):
    """Per-epoch validation: augmented val batches -> RunningScore mIoU
    (train_adv…eval_model:76-89; the reference also evaluates on randomly
    augmented validation samples). The argmax runs on the device; the
    labels and predictions of a batch come to the host in one copy each."""
    running = RunningScore(solver.num_classes)
    for raw in val_loader:
        batch = make_device_batch(to_device(raw, solver.device), generator, policy, crop_hw,
                                  keep_orig=False)
        pred = solver.predict(state.modules, batch["image"], n_iter=n_iter,
                              normalize_input=True).argmax(-1)
        running.update(batch["label"].cpu().numpy(), pred.cpu().numpy())
    score = running.get_scores()
    return score["Mean IoU : \t"], score["Mean Acc : \t"]


class ScalarLogger:
    """Loss-channel logging: cumulative-average scalars like the reference
    TensorBoard writer (train_adv…:538-541) + JSON export (:574-579), event
    files by ``utils/tb_events.py``. A step's metrics stay on the device;
    an epoch's come to the host in one copy when the epoch is logged."""

    def __init__(self, log_dir: Optional[str], enabled: bool):
        # the metrics of a data-parallel step are already summed over its
        # ranks; only rank 0 passes enabled=True
        self.totals: Dict[str, float] = {}
        self.count = 0
        self.history = []
        self._pending = []
        self.writer = None
        self.log_dir = None
        if enabled and log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self.writer = EventFileWriter(log_dir)
            self.log_dir = log_dir

    def log_step(self, metrics: Dict[str, torch.Tensor]):
        self.count += 1
        self._pending.append(metrics)

    def _drain(self):
        if self._pending:
            keys = sorted(self._pending[0])  # the JAX package's order (its pytrees sort keys)
            host = torch.stack([torch.stack([m[k] for k in keys])
                                for m in self._pending]).cpu().tolist()
            for row in host:
                for k, v in zip(keys, row):
                    self.totals[k] = self.totals.get(k, 0.0) + v
            self._pending = []

    def log_epoch(self, epoch: int, val_iou: float, val_acc: float):
        self._drain()
        means = {k: v / max(self.count, 1) for k, v in self.totals.items()}
        if self.writer is not None:
            self.writer.add_scalars({**means, "iou/val_iou": val_iou, "acc/val_acc": val_acc},
                                    epoch)
        self.history.append({"epoch": epoch, "val_iou": val_iou, "val_acc": val_acc, **means})

    def export(self, name: str):
        if self.log_dir:
            with open(os.path.join(self.log_dir, f"{name}.json"), "w") as f:
                json.dump(self.history, f, indent=1)

    def close(self):
        if self.writer is not None:
            self.writer.close()
            self.writer = None


def steps_per_epoch(train_set, cfg: ExperimentConfig) -> int:
    """Optimizer steps an epoch: the training loader's batches, which SGD's
    StepLR boundaries count in."""
    return len(HostBatchLoader(train_set, cfg.train_batch_size))


def train_network(experiment_name: str, solver: TripletSegmentationSolver, train_set,
                  validate_set, cfg: ExperimentConfig, *, model_dir: str,
                  log_dir: Optional[str] = None, seed: Optional[int] = None, log: bool = False,
                  debug: bool = False, start_epoch: int = 0, state,
                  max_epochs: Optional[int] = None, inner_steps: int = 1, grid=None):
    """The epoch loop (train_adv…train_network:92-584) from ``state``, an
    ``init_state`` built with ``steps_per_epoch(train_set, cfg)``. Returns
    (final state, best validation mIoU). ``grid`` (``parallel/mesh``)
    trains data-parallel over its ranks (module docstring)."""
    L = cfg.learning
    d = cfg.data
    dev = solver.device
    crop_hw = (d.crop_size[0], d.crop_size[1])
    pad_hw = (d.pad_size[0], d.pad_size[1])
    keep_orig = d.keep_orig_image_label_pair_for_training
    policy = A.get_policy(d.data_aug_policy, pad_hw, crop_hw, image_interp=d.image_interp)

    loader = HostBatchLoader(train_set, cfg.train_batch_size, seed=seed)
    writer = pmesh.is_writer(grid)
    if grid is not None and grid.data_parallel > 1:
        if cfg.train_batch_size % grid.data_parallel:
            raise ValueError(f"train batch {cfg.train_batch_size} must divide over "
                             f"{grid.data_parallel} ranks")
        step = pmesh.shard_train_step(make_fused_train_step(solver, policy, keep_orig), grid)
    elif inner_steps > 1:
        multi = make_multi_step(solver, policy, keep_orig, n_inner=inner_steps)

        def step(st, raw_list, gen):
            return multi(st, {k: torch.stack([r[k] for r in raw_list]) for k in raw_list[0]},
                         gen)
    else:
        step = make_fused_train_step(solver, policy, keep_orig)
    step_gen = prng.stream(seed, "step", device=dev)
    val_loader = HostBatchLoader(validate_set, L.batch_size, seed=seed, drop_last=False,
                                 shuffle=False)
    logger = ScalarLogger(log_dir, log and writer)

    best_score = -1e9
    stop = False
    n_epochs = max_epochs if max_epochs is not None else L.n_epochs
    last_epoch = start_epoch
    try:
        for epoch in range(start_epoch, n_epochs):
            last_epoch = epoch
            t0 = time.time()
            pending = []
            for i_iter, raw in enumerate(prefetch(loader, depth=2,
                                                  transform=lambda r: to_device(
                                                      pmesh.shard_batch(r, grid), dev))):
                if debug and i_iter > 20:
                    break
                if inner_steps > 1:
                    pending.append(raw)
                    if len(pending) < inner_steps:
                        continue
                    state, metrics = step(state, pending, step_gen)
                    pending = []
                else:
                    state, metrics = step(state, raw, step_gen)
                logger.log_step(metrics)
                if i_iter > L.max_iteration:
                    stop = True
            dt = time.time() - t0
            val_iou, val_acc = eval_model(solver, state, val_loader, policy, crop_hw,
                                          prng.stream(seed, "val", epoch, device=dev))
            logger.log_epoch(epoch, val_iou, val_acc)
            print(f"{experiment_name} epoch {epoch}: val mIoU {val_iou:.4f} "
                  f"acc {val_acc:.4f} ({dt:.1f}s)")

            if val_iou > best_score:
                best_score = val_iou
                if writer:
                    ckpt.save_checkpoint(model_dir, "best", state, epoch, best_score,
                                         solver.spec.network_type)
            if writer and ((epoch + 1) % cfg.output.save_epoch_every_num_epochs == 0
                           or epoch == 0):
                ckpt.save_checkpoint(model_dir, f"epoch_{epoch}", state, epoch, best_score,
                                     solver.spec.network_type)
            if stop:
                break
        logger.export(experiment_name.replace("/", "_"))
    except (KeyboardInterrupt, Exception):
        # interrupt snapshot + resume path: the reference wraps the whole
        # loop in a catch-all that saves a snapshot (train_adv…:580-584)
        if last_epoch > start_epoch and writer:
            path = ckpt.save_checkpoint(model_dir, "interrupted", state, last_epoch,
                                        best_score, solver.spec.network_type)
            print(f"interrupted at epoch {last_epoch}; snapshot at {path}")
        raise
    finally:
        logger.close()
    pmesh.barrier(grid)  # rank 0's checkpoints are on disk for every rank
    return state, best_score


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="adversarial-style robust segmentation training (PyTorch/CUDA port)")
    parser.add_argument("--json_config_path", type=str, required=True)
    parser.add_argument("--dataset_name", type=str, default=None)
    parser.add_argument("--cval", type=int, default=0)
    parser.add_argument("--data_setting", type=str, default="10")
    parser.add_argument("--resume_ckpt_path", type=str, default=None,
                        help="model_dir holding an 'interrupted' checkpoint to resume")
    parser.add_argument("--test_model_dir_path", type=str, default=None)
    parser.add_argument("--torch_ckpt_dir", type=str, default=None,
                        help="directory of reference per-module .pth files to import")
    parser.add_argument("--save_dir", type=str, default="./saved/")
    parser.add_argument("--log", action="store_true", default=True)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--debug", action="store_true", default=False)
    parser.add_argument("--auto_test", action="store_true", default=False)
    parser.add_argument("--test_root_dir", type=str, default=None,
                        help="root containing the OOD test suites")
    parser.add_argument("--test_batch_size", type=int, default=25)
    parser.add_argument("--no_train", action="store_true", default=False)
    parser.add_argument("--use_last_epoch", action="store_true", default=False)
    parser.add_argument("--inner_steps", type=int, default=1,
                        help="optimizer steps a call of the step (make_multi_step)")
    parser.add_argument("--data_parallel", action="store_true", default=False,
                        help="shard the batch over the ranks of a torch.distributed.run "
                             "launch")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; the GPU by default ('cpu' to run on the CPU)")
    opt = parser.parse_args(argv)

    cfg = ExperimentConfig.from_json(opt.json_config_path)
    grid = pmesh.init_from_env(opt.device) if opt.data_parallel else None
    solver = config_solver(cfg, pmesh.device_of(grid, opt.device))
    writer = pmesh.is_writer(grid)

    project = (f"train_{cfg.data.dataset_name}_{opt.data_setting}"
               f"_n_cls_{cfg.segmentation_model.num_classes}")
    config_name = os.path.splitext(os.path.basename(opt.json_config_path))[0]
    experiment_name = f"{config_name}/{opt.cval}"
    run_dir = os.path.join(opt.save_dir, project, config_name, str(opt.cval))
    log_dir = os.path.join(run_dir, "log")
    model_dir = os.path.join(run_dir, "model")
    if writer:
        os.makedirs(log_dir, exist_ok=True)
        os.makedirs(model_dir, exist_ok=True)
        shutil.copyfile(opt.json_config_path, os.path.join(run_dir, "config.json"))

    n_steps = None
    if not opt.no_train:
        train_set, validate_set = build_datasets(cfg, opt.data_setting, opt.cval)
        n_steps = steps_per_epoch(train_set, cfg)
    # one initial state for a fresh start, an import and a resume
    state = None
    if not opt.no_train or opt.torch_ckpt_dir or opt.resume_ckpt_path:
        state = solver.init_state(prng.stream_seed(opt.seed, "init"), steps_per_epoch=n_steps)
    start_epoch = 0
    if opt.torch_ckpt_dir:
        for name in import_module_checkpoints(state.modules, opt.torch_ckpt_dir, solver.spec):
            print(f"imported torch weights for {name}")
    if opt.resume_ckpt_path:
        state, meta = ckpt.load_checkpoint(opt.resume_ckpt_path, "interrupted", state)
        start_epoch = meta.get("epoch", 0)
        print(f"resumed from {opt.resume_ckpt_path} at epoch {start_epoch}")
    if state is not None:
        pmesh.replicate(state, grid)

    if not opt.no_train:
        state, _ = train_network(experiment_name, solver, train_set, validate_set, cfg,
                                 model_dir=model_dir, log_dir=log_dir, seed=opt.seed,
                                 log=opt.log, debug=opt.debug, start_epoch=start_epoch,
                                 state=state, inner_steps=opt.inner_steps, grid=grid)

    if opt.auto_test:
        from maxstyle_tpu_torch.evaluate import auto_test
        name = None
        if opt.test_model_dir_path:
            load_dir, name = os.path.split(opt.test_model_dir_path)
        elif opt.use_last_epoch:
            load_dir = model_dir
            name = ckpt.latest_epoch_checkpoint(model_dir)
        else:
            load_dir, name = model_dir, "best"
        if name:
            state, _ = ckpt.load_checkpoint(load_dir, name, solver.init_state(0))
        if state is None:
            raise FileNotFoundError(f"no checkpoint to test in {model_dir}")
        rows = auto_test(solver, state, cfg.data.dataset_name,
                         opt.test_root_dir or cfg.data.root_dir, save_dir=model_dir,
                         method_name=config_name, crop_hw=cfg.crop_hw,
                         new_spacing=cfg.data.new_spacing,
                         maximum_batch_size=opt.test_batch_size, mesh=grid)
        if writer:
            for row in rows:
                print(json.dumps(row))
    pmesh.barrier(grid)


if __name__ == "__main__":
    main()
