"""Kernel launches a step under the Swin trunk's stage spans
(``maxstyle/swin/stage{k}`` and the spans inside them; copies and fills
left out, as ``launches_per_step`` counts), over the traced stretch: the
count that fusing the trunk's small operations moves. Nothing without a
trace or where no such span ran; placed as ``swin_trunk_ms`` places its
work."""

import re

from perfbench.spans import PATH_SEP

STAGE = re.compile(r"swin/stage\d+")


def read(run):
    spans = (run.get("trace") or {}).get("spans")
    if spans is None:
        return None
    rows = [r for p, r in spans["paths"].items()
            if any(STAGE.fullmatch(n) for n in p.split(PATH_SEP))]
    return sum(r["launches"] for r in rows) if rows else None
