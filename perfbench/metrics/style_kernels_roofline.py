"""The MaxStyle kernels' (moments, apply, backward) summed bound time over
their summed traced device time. Each kind's launches are spread evenly
over the style hooks, as the inner loop runs them; a launch's bound is
that of its hook's [batch, channels, side, side] activations, the side the
network family's (``nets.Net.hook_side``)."""

from perfbench.roofline import KERNELS, STYLE_KERNELS, style_bound_s


def hook_shapes(run):
    cell = run["cell"]
    ms = cell.job()["max_style"]
    if not ms:
        return []
    crop, b = run["crop"], run["slices_per_step"]
    net = cell.net()
    out = []
    for h in ms["decoder_layers_indexes"]:
        side = net.hook_side(crop, h)
        out.append((b, cell.config["style_hook_channels"][str(h)], side, side))
    return out


def read(run):
    t = run.get("trace")
    shapes = hook_shapes(run)
    if not t or not shapes:
        return None
    bound = secs = 0.0
    for kind in STYLE_KERNELS:
        hits = [v for k, v in t["by_name"].items() if KERNELS[kind] in k]
        count = sum(v[0] for v in hits)
        secs += sum(v[1] for v in hits)
        bound += count / len(shapes) * sum(style_bound_s(kind, *s) for s in shapes)
    if secs <= 0:
        return None
    return 100.0 * bound / secs
