"""maxstyle_tpu_torch/scripts/ood_table.py prints, on every OOD record of
the repository, the bytes that scripts/ood_table.py prints: the JAX
package's records under benchmarks/, each alone, and its ood_*.jsonl all at
once (grouped and ungrouped workloads in one table run), and the port's own
records under maxstyle_tpu_torch/scripts/records/."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import ood_table as j_table  # noqa: E402
from maxstyle_tpu_torch.scripts import ood_table as t_table  # noqa: E402

JAX_OOD = sorted((ROOT / "benchmarks").glob("ood_*.jsonl"))
FILES = (JAX_OOD + [ROOT / "benchmarks" / "gamma_probe_r5.jsonl"]
         + sorted((ROOT / "maxstyle_tpu_torch" / "scripts" / "records").glob("ood_*.jsonl")))


@pytest.mark.parametrize("paths", [[p] for p in FILES] + [JAX_OOD],
                         ids=[p.name for p in FILES] + ["all"])
def test_table_bytes_equal_the_jax_scripts(paths, capsys):
    args = [str(p) for p in paths]
    j_table.main(args)
    want = capsys.readouterr().out
    t_table.main(args)
    got = capsys.readouterr().out
    assert want.count("### steps=") >= 1
    assert got.encode() == want.encode()
