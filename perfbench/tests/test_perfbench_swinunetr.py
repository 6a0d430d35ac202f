"""The ``swinunetr`` network family and the ``swinunetr_acdc.maxstyle`` cell:
its parameters against the program's modules, its FLOPs, its agreement
with the repository's dense-attention reference, a reference run of the
tiny cell, the style hooks' sides, and the four readers of the Swin
trunk's spans, which read nothing where the trace lost its launch
records."""

from __future__ import annotations

import hashlib
import json

import pytest
import torch

from perfbench_helpers import reference_run, tiny_cell

CELL = "swinunetr_acdc.maxstyle"
SEED = 3900000020

# At the cell's own size (crop 192, batch 20): the number of parameters and
# buffers, the sha256 of their [name, shape, kind] rows in order, and the
# FLOPs of one step (harness.count_flops).
PINNED = {"n_specs": 328,
          "specs": "59a06dfebc2518a1f805952b5b622b26bd26e62c591cd26c8625c207c50f57b2",
          "flops": 6700237931520}


def specs_digest(specs) -> str:
    rows = [[name, list(shape), kind] for name, (shape, kind) in specs.items()]
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


@pytest.fixture(scope="module")
def cell():
    from perfbench.manifest import load_cell
    return load_cell(CELL)


def test_param_specs_and_flops_as_pinned(cell):
    from perfbench.harness import count_flops
    from perfbench.reference import nets as N
    specs = N.param_specs(cell.net(), 192)
    assert len(specs) == PINNED["n_specs"]
    assert specs_digest(specs) == PINNED["specs"]
    assert count_flops(cell) == PINNED["flops"]


def test_the_weights_load_strictly_into_the_programs_modules(cell):
    """The family's parameters and buffers are the program's state dicts,
    name for name and shape for shape, and load with ``strict=True``."""
    from maxstyle_tpu_torch.config import ExperimentConfig
    from maxstyle_tpu_torch.solver import TripletSegmentationSolver
    from perfbench import inputs
    from perfbench.reference import nets as N
    specs = N.param_specs(cell.net(), 64)
    exp = cell.experiment()
    exp["data"]["crop_size"] = [64, 64, 1]
    solver = TripletSegmentationSolver(ExperimentConfig.from_dict(exp), device="cpu")
    weights = inputs.make_weights(specs, SEED, "cpu")
    state = solver.init_state(0, state_dicts=inputs.by_module(weights))
    got = {f"{m}.{k}": v for m, mod in state.modules.items() for k, v in mod.state_dict().items()}
    assert set(got) == set(specs)
    assert all(tuple(got[k].shape) == specs[k][0] for k in specs)
    assert all(torch.equal(got[k], weights[k]) for k in specs)


def test_the_family_agrees_with_the_dense_reference_in_float64(cell):
    """The family's window-by-window attention against
    ``tests/swin_unetr_reference.py``'s one dense attention a block, at crop
    64 (stage 1 padded 32 -> 35, stage 4 one window of 4): logits and
    reconstruction within 1e-10 of their largest values."""
    from perfbench import inputs
    from perfbench.reference import nets as N
    from tests import swin_unetr_reference as R
    net = cell.net()
    weights = {k: t.double() for k, t in
               inputs.make_weights(N.param_specs(net, 64), SEED, "cpu").items()}
    x = torch.rand((2, 1, 64, 64), generator=torch.Generator().manual_seed(1),
                   dtype=torch.float64)
    P = N.Params(weights)
    z_i, z_s = net.encode(P, x)
    logits, recon = net.segment(P, z_s), net.decode_image(P, z_i)
    r_logits, r_recon = R.forward(weights, x)
    for a, b in ((logits, r_logits), (recon, r_recon)):
        assert float((a - b).abs().max() / b.abs().max()) < 1e-10


def test_a_tiny_reference_run_completes():
    from perfbench.reference import nets as N
    cell = tiny_cell(CELL, n_iter=1)
    out = reference_run(cell, SEED, 2)
    assert torch.isfinite(torch.tensor(out["loss"])).all()
    specs = N.param_specs(cell.net(), 32)
    assert set(out["grad_norm"]) == {k for k in specs if not N.is_buffer(k)}
    assert all(v > 0 for v in out["grad_norm"].values())


def test_hook_sides_are_the_fcn_decoders(cell):
    """The style hooks sit at the FCN image decoder's sides over the 1/16
    level: [20,16,96^2], [20,16,192^2], [20,1,192^2]."""
    from test_perfbench_families import hook_shapes
    assert not hasattr(cell.net().module, "hook_side")
    run = {"cell": cell, "crop": 192, "slices_per_step": 20}
    assert hook_shapes(run) == [(20, 16, 96, 96), (20, 16, 192, 192), (20, 1, 192, 192)]


# ---------------------------------------------------------------------------
# the readers of the trunk's spans
# ---------------------------------------------------------------------------

READERS = ("swin_trunk_ms", "window_attention_ms", "window_attention_roofline",
           "swin_trunk_launches")


def _row(calls, busy_ms, launches):
    return {"calls": calls, "host_ms": 1.0, "self_ms": 0.5, "busy_ms": busy_ms,
            "launches": launches, "idle_ms": 0.0}


def span_fixture():
    """Two passes' paths: each stage's own work and its window attention,
    and paths outside the trunk."""
    paths = {"step > standard_pass > net/image_encoder": _row(1, 5.0, 40),
             "step > backward": _row(1, 50.0, 900),
             "step > hard_pass > net/segmentation_decoder": _row(1, 7.0, 60)}
    for phase in ("standard_pass", "hard_pass"):
        for k in range(1, 5):
            stage = f"step > {phase} > net/image_encoder > swin/stage{k}"
            paths[stage] = _row(1, 0.5 * k, 10 * k)
            paths[stage + " > swin/window_attention"] = _row(2, 1.0 * k, 20 * k)
    return {"steps": 4, "spans": {"unlinked": 0, "phases": {}, "paths": paths},
            "launches": 4000, "busy_s": 1.0,
            "by_name": {"a kernel": [4000, 0.9], "Memcpy DtoD (Device -> Device)": [1000, 0.1]}}


@pytest.mark.parametrize("name", READERS)
def test_the_readers_find_nothing_without_a_trace_or_the_spans(name, cell):
    from perfbench.manifest import reader
    read = reader(name)
    assert read({"cell": cell, "window": {}}) is None
    t = span_fixture()
    t["spans"]["paths"] = {p: r for p, r in t["spans"]["paths"].items() if "swin" not in p}
    assert read({"cell": cell, "crop": 192, "slices_per_step": 20, "trace": t}) is None


@pytest.mark.parametrize("name", READERS)
def test_the_readers_read_a_stretch_that_lost_its_launch_records(name, cell):
    """A traced run of the cell reports all four, however many of the
    stretch's device events lost their launch record: the span table
    places those by their time on the device, and the readers read it."""
    from perfbench.manifest import reader
    read = reader(name)
    run = {"cell": cell, "crop": 192, "slices_per_step": 20, "trace": span_fixture()}
    whole = read(run)
    run["trace"]["spans"]["unlinked"] = 5000
    assert whole is not None and read(run) == whole


def test_the_readers_on_a_span_table(cell):
    import importlib.util

    from perfbench.manifest import HERE, reader
    run = {"cell": cell, "crop": 192, "slices_per_step": 20, "trace": span_fixture()}
    stage_busy = sum(0.5 * k + 1.0 * k for k in range(1, 5))  # a pass
    assert reader("swin_trunk_ms")(run) == pytest.approx(2 * stage_busy)
    assert reader("window_attention_ms")(run) == pytest.approx(2 * sum(range(1, 5)))
    assert reader("swin_trunk_launches")(run) == pytest.approx(2 * sum(30 * k
                                                                       for k in range(1, 5)))
    spec = importlib.util.spec_from_file_location(
        "window_attention_roofline", HERE / "metrics" / "window_attention_roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    bound = 2 * sum(2 * mod.stage_bound_s(20, 192, k, cell.net()) for k in range(1, 5))
    assert reader("window_attention_roofline")(run) == pytest.approx(
        100 * bound / (1e-3 * 2 * sum(range(1, 5))))


def test_window_attention_bounds_by_hand():
    """Stage 1 at crop 192, batch 20: a 96^2 grid padded to 98^2, 196
    windows of 49 tokens a slice, C 48, 3 heads; the operations bound it."""
    import importlib.util

    from perfbench.manifest import HERE
    from perfbench.roofline import FP32_FLOP_PER_S, HBM_BYTES_PER_S
    spec = importlib.util.spec_from_file_location(
        "window_attention_roofline", HERE / "metrics" / "window_attention_roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    nw, n, c = 20 * 196, 49, 48
    ops = 2 * nw * n * 4 * c * c + 4 * nw * n * n * c
    shifted_bytes = 4 * (2 * nw * n * c + 4 * c * c + 4 * c + 169 * 3 + 196 * n * n)
    assert mod.call_bound_s(20, 192, 1, True, 48, 3, 7) == pytest.approx(
        max(shifted_bytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S))
    assert ops / FP32_FLOP_PER_S > shifted_bytes / HBM_BYTES_PER_S
    # stage 4 of a 64^2 crop: a 4^2 grid is one unshifted window of 16 tokens
    assert mod.call_bound_s(1, 64, 4, True, 48, 24, 7) == mod.call_bound_s(1, 64, 4, False,
                                                                           48, 24, 7)


@pytest.mark.card
def test_limits_on_the_card():
    """On the card, at the cell's own size: the program's checked steps pass
    the limits on three seeds; each of the TF32 control, the program with
    TF32 on and the half-batch fault fails one of them."""
    from perfbench import check
    from perfbench.calibrate import calibrate
    from perfbench.manifest import load_cell
    cell = load_cell(CELL)
    for seed in (101, 102, 103):
        r = calibrate(cell, seed, "cuda")
        assert check.verdict(r["program"], cell.limits), (seed, r["program"])
        for wrong in ("control_tf32", "program_tf32", "fault_half_batch"):
            assert not check.verdict(r[wrong], cell.limits), (seed, wrong, r[wrong])
