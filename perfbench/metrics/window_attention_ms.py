"""Device milliseconds a step of the work launched under the Swin blocks'
``maxstyle/swin/window_attention`` spans (each block's padding, roll,
window partition, attention, reverse and crop): the busy time of each
span path that ends in such a span, summed over those paths
(``spans.reduce_spans``), over the traced stretch. Forward passes only.
Nothing without a trace or where no such span ran; placed as
``swin_trunk_ms`` places its work."""

from perfbench.spans import PATH_SEP

SPAN = "swin/window_attention"


def read(run):
    spans = (run.get("trace") or {}).get("spans")
    if spans is None:
        return None
    rows = [r for p, r in spans["paths"].items() if p.split(PATH_SEP)[-1] == SPAN]
    return sum(r["busy_ms"] for r in rows) if rows else None
