"""Advisory single-card lock: serialize the processes that time the GPU.

Counterpart of ``maxstyle_tpu/utils/tpulock.py``. Two measurements on one
card at once read each other's load as their own, so every entry point
that times the card (``flagship``, ``profile_slice``, ``bench_style``)
holds ``chip_lock(tag)`` around its chip work. The lock is an
``fcntl.flock`` on a file, so it serializes unrelated processes and the
kernel releases it if the holder dies. It lives under the checkout's
``build/`` unless ``MAXSTYLE_GPU_LOCK`` names another path.

Priority: a benchmark matters more than a sweep. While a caller with
``bench_priority`` waits for the lock it raises a flag file
(``MAXSTYLE_GPU_BENCH_FLAG``, by default beside the lock); a sweep calls
:func:`yield_to_bench` between its arms and sleeps until the flag clears.
"""

from __future__ import annotations

import fcntl
import json
import os
import sys
import time
from contextlib import contextmanager
from pathlib import Path

_BUILD = Path(__file__).resolve().parents[2] / "build"
LOCK_PATH = os.environ.get("MAXSTYLE_GPU_LOCK", str(_BUILD / "gpu_chip.lock"))
BENCH_FLAG = os.environ.get("MAXSTYLE_GPU_BENCH_FLAG", str(_BUILD / "gpu_bench_waiting"))


def _log(msg: str) -> None:
    print(f"[gpulock] {msg}", file=sys.stderr, flush=True)


def lock_holder() -> dict | None:
    """Who holds (or last held) the lock, as far as the file says."""
    try:
        with open(LOCK_PATH) as f:
            return json.loads(f.read() or "{}")
    except (OSError, ValueError):
        return None


@contextmanager
def chip_lock(tag: str, timeout_s: float = 3600.0, poll_s: float = 5.0,
              bench_priority: bool = False):
    """Hold the card exclusively; yields {"waited_s", "contended",
    "acquired"}. On timeout the block still runs (an advisory lock must not
    turn a measurement into no result) with ``acquired`` False, so the
    caller can label its number contended. ``bench_priority`` raises
    BENCH_FLAG while waiting."""
    os.makedirs(os.path.dirname(LOCK_PATH) or ".", exist_ok=True)
    fd = os.open(LOCK_PATH, os.O_RDWR | os.O_CREAT, 0o666)
    info = {"waited_s": 0.0, "contended": False, "acquired": False}
    flag_raised = False
    t0 = time.monotonic()
    try:
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                info["acquired"] = True
                break
            except OSError:
                info["contended"] = True
                waited = time.monotonic() - t0
                if waited >= timeout_s:
                    _log(f"{tag}: lock timeout after {waited:.0f}s "
                         f"(holder: {lock_holder()}) — proceeding UNLOCKED")
                    break
                if bench_priority and not flag_raised:
                    try:
                        with open(BENCH_FLAG, "w") as f:
                            f.write(json.dumps({"tag": tag, "pid": os.getpid(),
                                                "since": time.time()}))
                        flag_raised = True
                    except OSError:
                        pass
                if int(waited) % 60 < poll_s:
                    _log(f"{tag}: waiting for the card (holder: {lock_holder()}, "
                         f"{waited:.0f}s)")
                time.sleep(poll_s)
        info["waited_s"] = round(time.monotonic() - t0, 1)
        if info["acquired"]:
            try:
                os.ftruncate(fd, 0)
                os.write(fd, json.dumps({"tag": tag, "pid": os.getpid(),
                                         "since": time.time()}).encode())
                os.fsync(fd)
            except OSError:
                pass
        yield info
    finally:
        if flag_raised:
            try:
                os.unlink(BENCH_FLAG)
            except OSError:
                pass
        try:
            if info["acquired"]:
                os.ftruncate(fd, 0)
                fcntl.flock(fd, fcntl.LOCK_UN)
        except OSError:
            pass
        os.close(fd)


def yield_to_bench(max_wait_s: float = 900.0, poll_s: float = 5.0) -> float:
    """A sweep's courtesy between arms: while a benchmark waits for the card
    (its flag exists), sleep with the lock released. Returns the seconds
    yielded."""
    t0 = time.monotonic()
    while os.path.exists(BENCH_FLAG):
        if time.monotonic() - t0 > max_wait_s:
            break
        if time.monotonic() - t0 < poll_s:
            _log("a benchmark is waiting for the card — pausing between arms")
        time.sleep(poll_s)
    return round(time.monotonic() - t0, 1)
