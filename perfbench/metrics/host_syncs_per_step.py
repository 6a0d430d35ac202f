"""Host waits for the device a step: ``set_sync_debug_mode("warn")``
warnings over a stretch of steps."""


def read(run):
    s = run.get("host_syncs")
    if not s:
        return None
    return s["syncs"] / s["steps"]
