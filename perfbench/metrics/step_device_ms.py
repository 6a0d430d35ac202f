"""The card's busy time a training step, in ms: the union of the intervals
in which a kernel, a copy or a fill ran on the device over the steps that
``harness.device_stretch`` profiles just after the window, over their
number. What a step costs the card, on the device's clock: a host that
stands still leaves the card idle and does not lengthen it."""


def read(run):
    d = run.get("device_stretch")
    if not d or d["busy_s"] <= 0:
        return None
    return 1e3 * d["busy_s"] / d["steps"]
