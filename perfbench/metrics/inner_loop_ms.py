"""Device milliseconds a step of the training step's ``inner_loop`` phase: the
union of the device intervals launched under the program's
``maxstyle/inner_loop`` span and the spans inside it, over the traced
stretch (``spans.reduce_spans``)."""

from perfbench.spans import phase_reader

read = phase_reader("inner_loop")
