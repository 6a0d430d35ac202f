"""Host milliseconds a step spent waiting in ``next()`` on the prefetch
iterator, over the untraced window of the traced run."""


def read(run):
    w = run["window"]
    return 1e3 * w["loader_wait_s"] / w["steps"]
