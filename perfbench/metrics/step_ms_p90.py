"""The 90th percentile (nearest rank) of every step's time in the window,
each the interval between CUDA events recorded at consecutive step
boundaries."""

from perfbench.harness import percentile


def read(run):
    return percentile(run["window"]["step_ms"], 90.0)
