"""The share of the measured window in which nothing ran on the device:
1 - the device's busy time a step over the window's mean step. The busy
time a step is the union of the device intervals over the traced steps,
divided by their number; the traced steps do the window's work, and the
profiler slows the host's side of them, not the device's, so their own
idle share would mostly measure the profiler."""


def read(run):
    t = run.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    w = run["window"]
    return 100.0 * (1.0 - (t["busy_s"] / t["steps"]) / (w["seconds"] / w["steps"]))
