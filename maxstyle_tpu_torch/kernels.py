"""Build, load and count the port's hand-written CUDA kernels.

The sources live in ``maxstyle_tpu_torch/csrc/``: ``maxstyle.cu`` (the
MaxStyle moments, style map and backward; ``ops/maxstyle_kernels``),
``warp.cu`` and ``warp_cubic.cu`` (the augmentation warps;
``ops/warp_kernels``), ``conv_bn_stats.cu`` (``proto_conv_bn_fusion``) and
``batchnorm.cu`` (BatchNorm's "train" and "frozen" forward and backward;
``ops/batchnorm_kernels``). Each ``.cu`` file is
compiled by ``nvcc`` for ``sm_90a`` into its own shared library with a plain
C interface, loaded with ``ctypes``. Builds go to ``build/kernels/`` at the
root of the checkout, named by a hash of the source, so an edited source is
rebuilt and an unchanged one is reused. Nothing is built or loaded when this
module is imported: the first kernel call builds what it needs, and
:func:`build_all` builds every source at once with one ``nvcc`` process per
source, all started together.

``LAUNCHES`` counts the launches of each kernel: ``maxstyle_stats``,
``maxstyle_apply``, ``maxstyle_bwd``, ``warp_bilinear_nearest``,
``warp_cubic_nearest``, ``conv3x3_bn_stats``, ``batchnorm_fwd`` and
``batchnorm_bwd``. A wrapper adds one right after its kernel was launched
and nowhere else, so a run can show that its main path went through the
kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every entry point: (source, function, argtypes)
_SIGNATURES = {
    "ms_moments": ("maxstyle", (_P, _P, _P, _I, _I, _I, _I, _F, _P)),
    "ms_style_apply": ("maxstyle", (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I,
                                    _I, _I, _I, _I, _I, _P)),
    "ms_bwd": ("maxstyle", (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "warp_bilinear_nearest": ("warp", (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "warp_bilinear_nearest_affine": ("warp", (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                              _I, _I, _P)),
    "warp_cubic_nearest": ("warp_cubic", (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "conv3x3_bn_stats": ("conv_bn_stats", (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "bn_fwd": ("batchnorm", (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P)),
    "bn_bwd": ("batchnorm", (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "bn_max_clusters": ("batchnorm", (_I, _P)),
    "bn_fwd_rows": ("batchnorm", (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P)),
    "bn_bwd_rows": ("batchnorm", (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P)),
    "bn_rows_max_blocks": ("batchnorm", (_P,)),
}
SOURCES = tuple(sorted({src for src, _ in _SIGNATURES.values()}))

LAUNCHES: Dict[str, int] = {name: 0 for name in
                            ("maxstyle_stats", "maxstyle_apply", "maxstyle_bwd",
                             "warp_bilinear_nearest", "warp_cubic_nearest",
                             "conv3x3_bn_stats", "batchnorm_fwd", "batchnorm_bwd")}

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(source: str) -> Path:
    text = (CSRC / f"{source}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha1(text).hexdigest()[:12]
    return BUILD_DIR / f"lib{source}_{digest}.so"


def build_all(sources=SOURCES) -> float:
    """Compile every missing library, one nvcc per source, all in parallel.
    Returns the wall seconds spent; raises with nvcc's output on failure."""
    todo = [s for s in sources if not _lib_path(s).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for src in todo:
        tmp = _lib_path(src).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{src}.cu")]
        procs[src] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    failed = []
    for src, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[src] = out
        if proc.returncode != 0:
            failed.append(f"{src}.cu (nvcc exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, _lib_path(src))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def _lib(source: str) -> ctypes.CDLL:
    if source not in _LIBS:
        build_all((source,))
        lib = ctypes.CDLL(str(_lib_path(source)))
        for fn, (src, argtypes) in _SIGNATURES.items():
            if src == source:
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
        _LIBS[source] = lib
    return _LIBS[source]


def launch(fn: str, *args) -> None:
    """Call C entry point ``fn`` with ``args`` (tensors are passed by data
    pointer; the current CUDA stream is appended) and raise if the launch
    reported an error."""
    source, _ = _SIGNATURES[fn]
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    # the current stream's handle without building a torch.cuda.Stream
    # object: a launch is on the step's critical path
    stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
    rc = getattr(_lib(source), fn)(*c_args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {fn} failed to launch: cudaError {rc}")


def query(fn: str, *args) -> None:
    """Call C entry point ``fn``, which launches nothing (no stream is
    appended), and raise if it reported an error."""
    source, _ = _SIGNATURES[fn]
    rc = getattr(_lib(source), fn)(*args)
    if rc != 0:
        raise RuntimeError(f"CUDA query {fn} failed: cudaError {rc}")


def check_cuda_f32(name: str, *tensors: torch.Tensor) -> None:
    """Kernel inputs must be contiguous float32 tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: tensors must share one CUDA device, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
