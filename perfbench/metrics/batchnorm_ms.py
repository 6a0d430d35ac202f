"""Device milliseconds a step in BatchNorm's "train" and "frozen" passes,
forward and backward: the traced seconds of every kernel whose name holds
cuDNN's training BatchNorm symbols (``bn_fw_tr_``, ``bn_bw_`` for NCHW and
NHWC alike, ``batchnorm_fwtr_``, ``batchnorm_bwtr_`` for NHWC's persistent
ones), ATen's native ones (``batch_norm_``) or the port's own BatchNorm
kernels (``batchnorm_fwd``, ``batchnorm_bwd``: the NCHW pair and the
channels-last ``_rows`` pair), over the traced steps. It reads the same
work whichever of them implements the layer."""

SYMBOLS = ("bn_fw_tr_", "bn_bw_", "batchnorm_fwtr_", "batchnorm_bwtr_", "batch_norm_",
           "batchnorm_fwd", "batchnorm_bwd")


def read(run):
    t = run.get("trace")
    if not t:
        return None
    secs = sum(v[1] for k, v in t["by_name"].items() if any(s in k for s in SYMBOLS))
    if secs <= 0:
        return None
    return 1e3 * secs / t["steps"]
