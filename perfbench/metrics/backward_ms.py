"""Device milliseconds a step of the training step's ``backward`` phase: the
union of the device intervals launched under the program's
``maxstyle/backward`` span and the spans inside it, over the traced
stretch (``spans.reduce_spans``)."""

from perfbench.spans import phase_reader

read = phase_reader("backward")
