"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` reads ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``limits/<cell>.json``, and its network from
``reference/families/<family>.py``, the family the configuration names; a
metric ``<name>`` is read by ``metrics/<name>.py``'s ``read(run)``. Adding a
cell, a network or a metric is adding files and an entry.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    here: Path = HERE

    def experiment(self) -> dict:
        """The program's config: the configuration's blocks with the job's
        merged over them."""
        out = copy.deepcopy(self.config["experiment"])
        for key, block in self.traffic["experiment"].items():
            out[key] = {**out.get(key, {}), **block}
        return out

    def job(self) -> dict:
        """What the reference needs of the job: the learning rate and, with
        MaxStyle, its block with the hooks' channels, p and eps."""
        exp = self.experiment()
        out = {"lr": exp["learning"]["lr"], "max_style": None}
        if exp["learning"].get("max_style"):
            ms = dict(exp["max_style"])
            ms["hook_channels"] = self.config["style_hook_channels"]
            ms["p"] = self.traffic["style_p"]
            ms["eps"] = self.traffic["style_eps"]
            out["max_style"] = ms
        return out

    def net(self):
        """The reference's network of the configuration's ``"family"``."""
        from perfbench.reference.nets import Net
        return Net(self.config["family"],
                   self.experiment()["segmentation_model"]["num_classes"], here=self.here)


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, manifest: Optional[dict] = None, here: Path = HERE) -> Cell:
    manifest = manifest if manifest is not None else load_manifest()
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    return Cell(name=name, chips=int(w["chips"]),
                config=load_json(here / "configs" / f"{w['config']}.json"),
                traffic=load_json(here / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(here / "limits" / f"{name}.json")["limits"],
                end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in manifest["per_layer"] if _applies(m, name)],
                here=here)


def reader(metric: str, here: Path = HERE) -> Callable[[dict], Optional[float]]:
    """``metrics/<metric>.py``'s ``read``."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], run: dict, here: Path = HERE) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of each metric whose reader finds something."""
    out = {}
    for m in metrics:
        value = reader(m["name"], here)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
