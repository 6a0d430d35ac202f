"""The whole step's share of the float32 peak on the device's clock: the
reference's counted convolution and matrix-product FLOPs a step over the
traced steps' device busy time a step and 67 TFLOP/s. It bounds the
kernels' rooflines that move ``step_device_ms``."""

from perfbench.roofline import FP32_FLOP_PER_S


def read(run):
    t = run.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * run["flops_per_step"] * t["steps"] / t["busy_s"] / FP32_FLOP_PER_S
