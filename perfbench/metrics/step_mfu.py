"""The whole step's share of the float32 peak: the reference's counted
convolution and matrix-product FLOPs a step, times the steps of the traced
run's untraced window, over that window's seconds on the host's clock and
67 TFLOP/s."""

from perfbench.roofline import FP32_FLOP_PER_S


def read(run):
    w = run["window"]
    return 100.0 * run["flops_per_step"] * w["steps"] / w["seconds"] / FP32_FLOP_PER_S
