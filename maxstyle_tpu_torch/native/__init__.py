"""Host-side data-path helpers in C++ (``fastpack.cpp``), loaded with ctypes.

The port's copy of ``maxstyle_tpu/native``: center crop-or-pad, per-slice
min-max normalisation and slice packing, the host work left once
augmentation runs on the device. The library is built with ``g++`` at first
use into ``build/native/`` at the root of the checkout (named by a hash of
the source, so an edited source is rebuilt) and a failed build raises.
Each entry point has a numpy plain version with the same arithmetic
(``*_plain``; that of crop-or-pad is ``data/medio.crop_or_pad``); the
tests hold the two against each other.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

# the numpy version of crop_or_pad
from maxstyle_tpu_torch.data.medio import crop_or_pad as crop_or_pad_plain  # noqa: F401

SOURCE = Path(__file__).resolve().parent / "fastpack.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None


def _lib_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libfastpack_{digest}.so"


def _build(path: Path) -> None:
    """Compile the library to a temporary name and move it into place, so
    that processes building at once never load a half-written file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SOURCE.name} (exit {r.returncode}):\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, path)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _LIB
    if _LIB is None:
        path = _lib_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        i64 = ctypes.c_int64
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.crop_or_pad_f32.argtypes = [f32p, i64, i64, i64, f32p, i64, i64, ctypes.c_float]
        lib.crop_or_pad_i32.argtypes = [i32p, i64, i64, i64, i32p, i64, i64, ctypes.c_int32]
        lib.minmax_norm_slices_f32.argtypes = [f32p, i64, i64, ctypes.c_float]
        lib.gather_pack_f32.argtypes = [ctypes.POINTER(ctypes.POINTER(ctypes.c_float)), i64p,
                                        i64p, i64, i64, i64, f32p]
        for fn in (lib.crop_or_pad_f32, lib.crop_or_pad_i32, lib.minmax_norm_slices_f32,
                   lib.gather_pack_f32):
            fn.restype = None
        _LIB = lib
    return _LIB


def _check_3d(volume: np.ndarray, dtypes) -> None:
    if volume.ndim != 3:
        raise ValueError(f"expected an [S,H,W] volume, got shape {volume.shape}")
    if volume.dtype not in dtypes:
        raise TypeError(f"expected one of {[np.dtype(d).name for d in dtypes]}, "
                        f"got {volume.dtype}")


def crop_or_pad(volume: np.ndarray, target_hw, pad_value: float = 0.0) -> np.ndarray:
    """Center crop-or-pad of a float32 or int32 [S,H,W] volume to [S,TH,TW]."""
    _check_3d(volume, (np.float32, np.int32))
    s, h, w = volume.shape
    th, tw = target_hw
    vol = np.ascontiguousarray(volume)
    out = np.empty((s, th, tw), vol.dtype)
    if vol.dtype == np.float32:
        get_lib().crop_or_pad_f32(vol, s, h, w, out, th, tw, float(pad_value))
    else:
        get_lib().crop_or_pad_i32(vol, s, h, w, out, th, tw, int(pad_value))
    return out


def minmax_norm_slices(volume: np.ndarray, eps: float = 1e-20) -> np.ndarray:
    """Per-slice min-max normalisation of a float32 [S,H,W] volume to [0, 1],
    in place (a non-contiguous input is copied first); returns the result."""
    _check_3d(volume, (np.float32,))
    vol = np.ascontiguousarray(volume)
    get_lib().minmax_norm_slices_f32(vol, vol.shape[0], vol.shape[1] * vol.shape[2], eps)
    return vol


def minmax_norm_slices_plain(volume: np.ndarray, eps: float = 1e-20) -> np.ndarray:
    """The numpy version of :func:`minmax_norm_slices`, in the C++ order of
    float32 operations: (x - min) * (1 / (max - min + eps))."""
    v = volume.astype(np.float32)
    mn = v.min(axis=(1, 2), keepdims=True)
    mx = v.max(axis=(1, 2), keepdims=True)
    inv = np.float32(1.0) / (mx - mn + np.float32(eps))
    return (v - mn) * inv


def gather_pack(volumes: Sequence[np.ndarray], vol_idx, slice_idx) -> np.ndarray:
    """out[i] = volumes[vol_idx[i]][slice_idx[i]] from equally shaped
    float32 or int32 [S,H,W] volumes, one memcpy a slice (int32 goes through
    the float32 entry as a bit-preserving view)."""
    vols = [np.ascontiguousarray(v) for v in volumes]
    dtype = vols[0].dtype
    for v in vols:
        _check_3d(v, (np.float32, np.int32))
        if v.dtype != dtype or v.shape[1:] != vols[0].shape[1:]:
            raise ValueError("gather_pack needs volumes of one dtype and slice shape")
    h, w = vols[0].shape[1:]
    vol_idx = np.ascontiguousarray(vol_idx, np.int64)
    slice_idx = np.ascontiguousarray(slice_idx, np.int64)
    n = vol_idx.shape[0]
    if slice_idx.shape != (n,) or n and (vol_idx.min() < 0 or vol_idx.max() >= len(vols)):
        raise IndexError("vol_idx out of range or slice_idx of another length")
    if n and any(not 0 <= s < vols[v].shape[0] for v, s in zip(vol_idx, slice_idx)):
        raise IndexError("slice_idx out of range")
    out = np.empty((n, h, w), dtype)
    fptr = ctypes.POINTER(ctypes.c_float)
    ptrs = (fptr * len(vols))(*[v.ctypes.data_as(fptr) for v in vols])
    get_lib().gather_pack_f32(ptrs, vol_idx, slice_idx, n, h, w, out.view(np.float32))
    return out


def gather_pack_plain(volumes: Sequence[np.ndarray], vol_idx, slice_idx) -> np.ndarray:
    """The numpy version of :func:`gather_pack`."""
    return np.stack([volumes[v][s] for v, s in zip(vol_idx, slice_idx)])
