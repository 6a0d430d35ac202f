"""Device milliseconds a step of the training step's ``augment`` phase: the
union of the device intervals launched under the program's
``maxstyle/augment`` span and the spans inside it, over the traced
stretch (``spans.reduce_spans``)."""

from perfbench.spans import phase_reader

read = phase_reader("augment")
