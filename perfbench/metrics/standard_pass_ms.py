"""Device milliseconds a step of the training step's ``standard_pass`` phase: the
union of the device intervals launched under the program's
``maxstyle/standard_pass`` span and the spans inside it, over the traced
stretch (``spans.reduce_spans``)."""

from perfbench.spans import phase_reader

read = phase_reader("standard_pass")
