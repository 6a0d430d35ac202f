"""``torch.cuda.max_memory_allocated()`` over the window, in GiB."""


def read(run):
    peak = run["window"]["peak_bytes"]
    return peak / 2 ** 30 if peak else None
