"""The composed bilinear warp's bound time over its traced device time: a
launch warps the step's raw slices from the pad to the crop."""

from perfbench.roofline import KERNELS, warp_bound_s


def read(run):
    t = run.get("trace")
    if not t:
        return None
    frag = KERNELS["warp_bilinear_nearest"]
    hits = [v for k, v in t["by_name"].items() if frag in k]
    count, secs = sum(v[0] for v in hits), sum(v[1] for v in hits)
    if not count or secs <= 0:
        return None
    return 100.0 * count * warp_bound_s(run["n_raw"], run["pad"], run["crop"]) / secs
