"""BENCHMARK.json against the benchmark's contract, and the files it names."""

from __future__ import annotations

import json
import re
import shutil
import time

import pytest

from perfbench_helpers import ROOT, tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys_and_paths(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert all(not w.startswith("/") and ".." not in w for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43200 s
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_and_units(bench):
    names = ([c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}


def test_every_cell_finds_its_files(bench):
    from perfbench.manifest import HERE, load_cell
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        with open(ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"]
        assert (HERE / "reference" / "families" / f"{cfg['family']}.py").is_file()
    for w in bench["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
        cell = load_cell(w["name"], bench)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer and cell.limits
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_moves_is_reported_in_its_cells(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)


def test_configs_match_the_shipped_jobs(bench):
    """Each cell's experiment is the shipped job file's, and the
    configuration's augmentation block is the port's policy of that name."""
    import dataclasses

    from maxstyle_tpu_torch.data.augment import get_policy
    from perfbench.manifest import load_cell
    shipped = {"maxstyle": "MICCAI2022_MaxStyle.json", "standard": "standard_training.json"}
    for w in bench["workloads"]:
        cell = load_cell(w["name"], bench)
        with open(ROOT / "configs" / "ACDC" / "1500_epoch" / shipped[w["traffic"]]) as f:
            job = json.load(f)
        exp = cell.experiment()
        for block in ("learning", "max_style"):
            for key, value in job.get(block, {}).items():
                assert exp[block][key] == value, (w["name"], block, key)
        for key, value in exp["data"].items():
            assert job["data"][key] == value, (w["name"], key)
        pol = dataclasses.asdict(get_policy(exp["data"]["data_aug_policy"]))
        for key, value in cell.config["augmentation"].items():
            got = pol[key]
            assert (list(got) if isinstance(got, tuple) else got) == value, key


# A network family of its own file: a stride-2 convolution encoder, a 1x1
# segmentation head after nearest upsampling, and an image decoder whose
# style hooks 1-5 sit at the full crop (its own hook_side).
TOY_FAMILY = '''
import torch

from perfbench.reference.nets import batch_norm, conv, conv_t2, lrelu


def encode(P, x):
    z = lrelu(batch_norm(P, "image_encoder.norm", conv(P, "image_encoder.conv", x, 8, 3, stride=2)))
    return z, z


def segment(P, z_s, num_classes):
    up = z_s.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return conv(P, "segmentation_decoder.head", up, num_classes, 1)


def decode_image(P, z_i, style_fns=None, start=0, stop_before=None):
    x = z_i
    for i in range(start, 6):
        if not (start > 0 and i == start):
            if i == 1:
                x = conv_t2(P, "image_decoder.up", x, 16)
            elif 2 <= i <= 4:
                x = lrelu(conv(P, f"image_decoder.conv{i}", x, 16, 3))
            elif i == 5:
                x = torch.sigmoid(conv(P, "image_decoder.head", x, 1, 1))
        if stop_before is not None and i == stop_before:
            return x
        if style_fns and i in style_fns:
            x = style_fns[i](x)
    return x


def hook_side(crop, hook):
    return crop // 2 if hook == 0 else crop
'''


def _files(folder):
    return {p.relative_to(folder): p.read_bytes() for p in sorted(folder.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_added_by_files_and_an_entry(tmp_path, bench):
    """A new configuration, traffic mix, limits file and metric reader,
    and one entry each in BENCHMARK.json: the harness finds and runs them
    without an edit to any file it had. A new network is one file more:
    a family under ``reference/families/`` gives its parameters, its FLOPs,
    its style hooks' sides and a reference step."""
    import torch

    from perfbench import harness
    from perfbench.manifest import load_cell, read_metrics, reader
    from perfbench.reference import nets as N
    from perfbench.roofline import style_bound_s
    from perfbench_helpers import reference_run
    here = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", here, ignore=shutil.ignore_patterns("__pycache__"))
    had = _files(here)
    with open(here / "configs" / "fcn16_acdc.json") as f:
        cfg = json.load(f)
    cfg["name"] = "fcn16_small"
    cfg["experiment"]["data"]["pad_size"] = [40, 40, 1]
    cfg["experiment"]["data"]["crop_size"] = [32, 32, 1]
    (here / "configs" / "fcn16_small.json").write_text(json.dumps(cfg))
    with open(here / "traffic" / "standard.json") as f:
        tr = json.load(f)
    tr["name"] = "tiny_batch"
    tr["experiment"]["learning"]["batch_size"] = 4
    tr["pool_slices"] = 12
    (here / "traffic" / "tiny_batch.json").write_text(json.dumps(tr))
    (here / "limits" / "fcn16_small.tiny_batch.json").write_text(
        json.dumps({"limits": {"grad_gap_median": 1e-3}}))
    (here / "metrics" / "steps_in_window.py").write_text(
        "def read(run):\n    return run['window']['steps']\n")
    bench = json.loads(json.dumps(bench))
    bench["workloads"].append({"name": "fcn16_small.tiny_batch", "config": "fcn16_small",
                               "traffic": "tiny_batch", "chips": 1, "why": "test"})
    rate = next(m for m in bench["end_to_end"] if m["name"] == "slices_per_s")
    rate["workloads"].append("fcn16_small.tiny_batch")
    bench["per_layer"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "the loop",
                               "moves": "slices_per_s",
                               "workloads": ["fcn16_small.tiny_batch"]})
    cell = load_cell("fcn16_small.tiny_batch", bench, here=here)
    run = harness.run_cell(cell, 3, 0.5, False, "cpu", time.perf_counter())
    assert "error" not in run["check"]
    got = read_metrics(cell.per_layer, run, here)
    assert got["steps_in_window"]["value"] == run["window"]["steps"] >= 1
    assert set(read_metrics(cell.end_to_end, run, here)) == {m["name"] for m in cell.end_to_end}
    assert {"slices_per_s", "setup_s"} <= {m["name"] for m in cell.end_to_end}

    (here / "reference" / "families" / "toy.py").write_text(TOY_FAMILY)
    cfg["name"], cfg["family"] = "toy_small", "toy"
    (here / "configs" / "toy_small.json").write_text(json.dumps(cfg))
    with open(here / "traffic" / "maxstyle.json") as f:
        tr = json.load(f)
    tr["name"] = "tiny_maxstyle"
    tr["experiment"]["learning"]["batch_size"] = 4
    tr["experiment"]["max_style"]["n_iter"] = 1
    tr["pool_slices"] = 12
    (here / "traffic" / "tiny_maxstyle.json").write_text(json.dumps(tr))
    (here / "limits" / "toy_small.tiny_maxstyle.json").write_text(
        json.dumps({"limits": {"change_gap": 0.1}}))
    bench["configs"].append({"name": "toy_small", "source": "test",
                             "file": "perfbench/configs/toy_small.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "toy_small.tiny_maxstyle", "config": "toy_small",
                               "traffic": "tiny_maxstyle", "chips": 1, "why": "test"})
    toy = load_cell("toy_small.tiny_maxstyle", bench, here=here)
    net = toy.net()
    assert net.module.__file__ == str(here / "reference" / "families" / "toy.py")
    specs = N.param_specs(net, 32)
    assert specs["image_encoder.conv.weight"] == ((8, 1, 3, 3), "conv")
    assert specs["image_decoder.up.weight"] == ((8, 16, 2, 2), "conv_t")
    assert specs["segmentation_decoder.head.weight"] == ((4, 8, 1, 1), "conv")
    assert len(specs) == 18
    assert harness.count_flops(toy) > 0
    assert [net.hook_side(32, h) for h in (0, 3, 4, 5)] == [16, 32, 32, 32]
    trace = {"steps": 1, "by_name": {"maxstyle_stats_kernel": [3, 1e-3]}}
    roofline = reader("style_kernels_roofline", here)({"cell": toy, "crop": 32,
                                                       "slices_per_step": 4, "trace": trace})
    bound = sum(style_bound_s("maxstyle_stats", *s)
                for s in ((4, 16, 32, 32), (4, 16, 32, 32), (4, 1, 32, 32)))
    assert roofline == pytest.approx(100 * bound / 1e-3)
    out = reference_run(toy, 5, 1)
    assert torch.isfinite(torch.tensor(out["loss"])).all()
    assert set(out["grad_norm"]) == {k for k in specs if not N.is_buffer(k)}
    assert all(v > 0 for v in out["grad_norm"].values())
    now = _files(here)
    assert {k: now[k] for k in had} == had


def test_tiny_cell_helper_cuts_only_sizes():
    cell = tiny_cell("fcn16_acdc.maxstyle")
    assert cell.config["experiment"]["segmentation_model"]["network_type"] == \
        "FCN_16_standard_no_STN"
