"""Device milliseconds a step of the work launched under the Swin trunk's
stage spans (``maxstyle/swin/stage{k}``, each stage's blocks and merge, and
the spans inside them): the busy time of each span path that passes
through a stage, the union of its device intervals, summed over those
paths (``spans.reduce_spans``), over the traced stretch. Forward passes
only: the backward's kernels run under ``backward`` and ``inner_grad``.
Nothing without a trace or where no such span ran. A stretch whose device
events lost most of their launch records reads long: ``reduce_spans``
then places them by their time on the device (PERF.md, section 7)."""

import re

from perfbench.spans import PATH_SEP

STAGE = re.compile(r"swin/stage\d+")


def read(run):
    spans = (run.get("trace") or {}).get("spans")
    if spans is None:
        return None
    rows = [r for p, r in spans["paths"].items()
            if any(STAGE.fullmatch(n) for n in p.split(PATH_SEP))]
    return sum(r["busy_ms"] for r in rows) if rows else None
