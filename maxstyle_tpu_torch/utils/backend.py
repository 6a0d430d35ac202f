"""The CUDA device probe.

Counterpart of the probe role of ``maxstyle_tpu/utils/backend.py``, which
initialises the JAX backend in a throwaway subprocess so that a backend
that fails or hangs at initialisation cannot take the caller down with it.
:func:`probe_cuda` does the same for the CUDA device: a child process
imports torch and names the card, and a failure or a hang past the
timeout raises ``RuntimeError`` with what the child said. There is no
counterpart of JAX's ``default_backend(fallback="cpu")``: falling back to
the CPU would hide the device; a caller that wants the CPU names it.
"""

from __future__ import annotations

import subprocess
import sys

_PROBE = ("import torch\n"
          "assert torch.cuda.is_available(), 'torch.cuda.is_available() is false'\n"
          "print(torch.cuda.get_device_name(0), torch.cuda.device_count(), sep='; ')\n")


def probe_cuda(timeout_s: float = 120.0, env=None, python: str = sys.executable) -> str:
    """"<card name>; <device count>" from a child process that initialises
    CUDA; raises RuntimeError if it fails or is still running after
    ``timeout_s`` (the child is then killed)."""
    try:
        r = subprocess.run([python, "-c", _PROBE], env=env, capture_output=True, text=True,
                           timeout=timeout_s)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"CUDA probe still running after {timeout_s:.0f} s "
                           "(device initialisation hung)") from e
    if r.returncode != 0:
        tail = (r.stderr or "").strip().splitlines()
        raise RuntimeError("CUDA probe failed: "
                           + (tail[-1] if tail else f"exit code {r.returncode}"))
    return r.stdout.strip()
