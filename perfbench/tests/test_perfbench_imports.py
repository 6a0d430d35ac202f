"""What the harness and the reference load, by whole top-level names."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from perfbench_helpers import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "maxstyle_tpu"}


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """A whole run of a small cell on the CPU, the port included, leaves no
    module of JAX or the JAX package loaded."""
    loaded = _loaded_after(
        "import sys, time; sys.path.insert(0, 'perfbench/tests')\n"
        "from perfbench_helpers import tiny_cell\n"
        "from perfbench import harness, run\n"
        "cell = tiny_cell('fcn16_acdc.maxstyle')\n"
        "r = harness.run_cell(cell, 5, 0.2, False, 'cpu', time.perf_counter())\n"
        "run.result(cell, r, False)\n"
        "from perfbench.manifest import load_manifest, reader\n"
        "[reader(m['name']) for m in load_manifest()['per_layer']]\n")
    assert "maxstyle_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    """The reference, every network family loaded by file and the
    arithmetic beside them load nothing of the program and no JAX."""
    families = sorted(p.stem for p in (ROOT / "perfbench" / "reference" / "families").glob("*.py"))
    assert len(families) >= 2
    loaded = _loaded_after("import perfbench.reference.step, perfbench.reference.nets, "
                           "perfbench.reference.augment, perfbench.check, perfbench.inputs, "
                           "perfbench.roofline\n"
                           f"[perfbench.reference.nets.load_family(f) for f in {families!r}]")
    assert not loaded & (FORBIDDEN | {"maxstyle_tpu_torch"})


def test_no_source_imports_jax():
    for path in (ROOT / "perfbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)
                if "reference" in path.parts:
                    assert n.split(".")[0] != "maxstyle_tpu_torch", (path, n)
