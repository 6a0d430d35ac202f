"""The network families loaded by file: the two cells' networks as pinned
before they moved out of ``nets.py`` (their parameters, FLOPs, weights and
reference losses), an unknown family, and the style hooks' sides."""

from __future__ import annotations

import hashlib
import json

import pytest
import torch

from perfbench_helpers import reference_run, tiny_cell

from perfbench.spans import PHASES

CELLS = ("fcn16_acdc.maxstyle", "unetr_acdc.maxstyle")
SEED = 3900000019

# Read from the code before the families moved to their files, at the
# cells' own size (crop 192, batch 20): the number of parameters and
# buffers, the sha256 of their [name, shape, kind] rows in order, the FLOPs
# of one step (harness.count_flops) and the sha256 of make_weights(seed
# SEED) on the CPU, names and bytes in order.
PINNED = {
    "fcn16_acdc.maxstyle": {
        "n_specs": 216,
        "specs": "988c459ba1a8539074437326ad341c7ad79fde58fc4e5d888b29041f72659d59",
        "flops": 872090173440,
        "weights": "1e7e9c3980d178b076bc46d8fd1dcfe1675912993e83ebf548c8141f3c6792e2"},
    "unetr_acdc.maxstyle": {
        "n_specs": 331,
        "specs": "c9daa00a24afba2c9c9b0b1bb920746e9a7fd30918a1c7024d16a2daf7ba3e07",
        "flops": 9678634352640,
        "weights": "ff904c666e1ad883e8117353033d54cd589cd82d431bddc10ad8583e3d0f2b3a"},
}

# The same code's float32 reference over two steps of each tiny cell
# (tiny_cell(n_iter=1), seed SEED, perfbench_helpers.reference_run) on one
# CPU thread, torch 2.13 for the CPU: each step's loss and standard-pass
# parts, and the sum of the first gradient's norms by leaf. Another
# thread count or BLAS build may round otherwise.
PINNED_TINY = {
    "fcn16_acdc.maxstyle": {
        "loss": ["0x1.581a6e0000000p+1", "0x1.eeefec0000000p+1"],
        "std_parts": [["0x1.42f31a0000000p+0", "0x1.9b73ae0000000p-5"],
                      ["0x1.ca09540000000p+0", "0x1.0f98000000000p-4"]],
        "grad_norm_sum": "0x1.c5dcf06c6f288p+6"},
    "unetr_acdc.maxstyle": {
        "loss": ["0x1.5078980000000p+1", "0x1.7849860000000p+1"],
        "std_parts": [["0x1.1fda6e0000000p+0", "0x1.889c840000000p-5"],
                      ["0x1.4ac37c0000000p+0", "0x1.36667c0000000p-4"]],
        "grad_norm_sum": "0x1.4d1ba61a3a0ffp+4"},
}


def specs_digest(specs) -> str:
    rows = [[name, list(shape), kind] for name, (shape, kind) in specs.items()]
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


@pytest.fixture
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("name", CELLS)
def test_param_specs_and_flops_as_pinned(name):
    from perfbench.harness import count_flops
    from perfbench.manifest import load_cell
    from perfbench.reference import nets as N
    cell = load_cell(name)
    specs = N.param_specs(cell.net(), 192)
    assert len(specs) == PINNED[name]["n_specs"]
    assert specs_digest(specs) == PINNED[name]["specs"]
    assert count_flops(cell) == PINNED[name]["flops"]


@pytest.mark.parametrize("name", CELLS)
def test_weights_as_pinned(name):
    from perfbench import inputs
    from perfbench.manifest import load_cell
    from perfbench.reference import nets as N
    weights = inputs.make_weights(N.param_specs(load_cell(name).net(), 192), SEED, "cpu")
    h = hashlib.sha256()
    for key, t in weights.items():
        h.update(key.encode())
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == PINNED[name]["weights"]


@pytest.mark.parametrize("name", CELLS)
def test_reference_losses_as_pinned(name, one_thread):
    out = reference_run(tiny_cell(name, n_iter=1), SEED, 2)
    pin = PINNED_TINY[name]
    assert [float(x).hex() for x in out["loss"]] == pin["loss"]
    assert [[float(x).hex() for x in p] for p in out["std_parts"]] == pin["std_parts"]
    assert float(sum(out["grad_norm"].values())).hex() == pin["grad_norm_sum"]


def test_an_unknown_family_names_its_file(tmp_path):
    from perfbench.reference import nets as N
    with pytest.raises(ValueError, match=r"families/swin_unetr2d\.py"):
        N.Net("swin_unetr2d", 4)
    with pytest.raises(ValueError, match=str(tmp_path / "reference" / "families" / "fcn16.py")):
        N.load_family("fcn16", here=tmp_path)


def hook_shapes(run):
    """``metrics/style_kernels_roofline.py``'s ``hook_shapes``."""
    import importlib.util

    from perfbench.manifest import HERE
    spec = importlib.util.spec_from_file_location(
        "style_kernels_roofline", HERE / "metrics" / "style_kernels_roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.hook_shapes(run)


@pytest.mark.parametrize("name", CELLS)
def test_hook_sides_are_the_fcn_decoders(name):
    """Neither family defines ``hook_side``: the style hooks sit at the
    FCN image decoder's sides, [20,16,96^2], [20,16,192^2], [20,1,192^2]."""
    from perfbench.manifest import load_cell
    cell = load_cell(name)
    assert not hasattr(cell.net().module, "hook_side")
    run = {"cell": cell, "crop": 192, "slices_per_step": 20}
    assert hook_shapes(run) == [(20, 16, 96, 96), (20, 16, 192, 192), (20, 1, 192, 192)]


@pytest.mark.parametrize("phase", PHASES)
def test_phase_metrics_read_the_kept_spans(phase):
    """Each of the six readers returns its phase's busy ms from
    ``run["trace"]["spans"]``, and nothing without a trace or a span."""
    from perfbench.manifest import reader
    read = reader(f"{phase}_ms")
    spans = {"phases": {p: {"calls": 1.0, "busy_ms": 1.5 + i}
                        for i, p in enumerate(PHASES)}}
    assert read({"trace": {"steps": 4, "spans": spans}}) == 1.5 + PHASES.index(phase)
    assert read({"window": {}}) is None
    assert read({"trace": {"steps": 4, "spans": {"phases": {}}}}) is None
