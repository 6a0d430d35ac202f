"""Process start to the first timed step: imports, the kernel build or
load, the pool, the weights, the work count, the checked and warm-up
steps."""


def read(run):
    return run["setup_s"]
