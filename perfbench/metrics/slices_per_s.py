"""Slices trained a second: effective batch x steps over the window, from
its start to its closing synchronize (host clock)."""


def read(run):
    w = run["window"]
    return run["slices_per_step"] * w["steps"] / w["seconds"]
