"""Checkpoint / resume with ``torch.save``.

Counterpart of ``maxstyle_tpu/utils/checkpoint.py`` (orbax there). The
reference's two formats (SURVEY §5) — per-module best / every-N-epoch
checkpoints and monolithic interrupt snapshots with optimizer state and
epoch — are one thing here too: ``{directory}/{name}/state.pt`` holds every
module's ``state_dict`` (weights and BatchNorm buffers), every optimizer's
``state_dict`` and the step count, beside the same ``meta.json``
{epoch, best_score, network_type} as the JAX package's, under the names
'best', 'epoch_<N>' and 'interrupted'.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional, Tuple

import torch

from maxstyle_tpu_torch.solver import TrainState

STATE_FILE = "state.pt"


def save_checkpoint(directory: str, name: str, state: TrainState, epoch: int = 0,
                    best_score: float = float("-inf"), network_type: str = "") -> str:
    """Save ``state`` under {directory}/{name}, replacing what was there;
    returns the path."""
    path = os.path.abspath(os.path.join(directory, name))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save({"modules": {k: m.state_dict() for k, m in state.modules.items()},
                "optimizers": {k: o.state_dict() for k, o in state.optimizers.items()},
                "step": int(state.step)},
               os.path.join(path, STATE_FILE))
    meta = {"epoch": int(epoch), "best_score": float(best_score),
            "network_type": network_type}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    return path


def load_checkpoint(directory: str, name: str, template: TrainState) -> Tuple[TrainState, dict]:
    """Restore (state, meta) from {directory}/{name} into ``template`` (an
    ``init_state`` result of the same network, whose device it keeps): every
    module strictly, every optimizer and the step, with each learning-rate
    schedule moved to that step. Returns the template.

    The file is read to the CPU: ``load_state_dict`` copies weights and
    moments to their parameters' devices, and leaves the optimizers' step
    counts on the CPU, where torch keeps them (one on the GPU would cost a
    host sync a parameter a step)."""
    path = os.path.abspath(os.path.join(directory, name))
    saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    if set(saved["modules"]) != set(template.modules) or \
            set(saved["optimizers"]) != set(template.optimizers):
        raise ValueError(f"{path}: modules {sorted(saved['modules'])} do not match the "
                         f"template's {sorted(template.modules)}")
    for k, sd in saved["modules"].items():
        template.modules[k].load_state_dict(sd, strict=True)
    for k, sd in saved["optimizers"].items():
        template.optimizers[k].load_state_dict(sd)
    template.step = int(saved["step"])
    for sched in template.schedulers.values():
        sched.seek(template.step)
    meta_path = os.path.join(path, "meta.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return template, meta


def latest_epoch_checkpoint(directory: str) -> Optional[str]:
    """Name of the highest-numbered 'epoch_*' checkpoint, if any."""
    if not os.path.isdir(directory):
        return None
    epochs = []
    for entry in os.listdir(directory):
        if entry.startswith("epoch_"):
            try:
                epochs.append((int(entry.split("_", 1)[1]), entry))
            except ValueError:
                pass
    return max(epochs)[1] if epochs else None
