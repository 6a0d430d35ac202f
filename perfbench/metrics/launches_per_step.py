"""Device kernels (copies and fills left out) in the traced stretch, a step."""


def read(run):
    t = run.get("trace")
    if not t or not t["launches"]:
        return None
    return t["launches"] / t["steps"]
