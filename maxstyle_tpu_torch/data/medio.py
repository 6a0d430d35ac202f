"""Native medical-image IO: NIfTI-1 and NRRD readers/writers (pure numpy).

The port's own copy of ``maxstyle_tpu/data/medio.py``, byte for byte in
what it reads and writes.

The reference reads volumes with SimpleITK
(common_utils/basic_operations.load_img_label_from_path:314-345,
dataset_utils.resample_by_spacing:38-70). SimpleITK is not available here, so
this module implements the two formats the reference actually uses —
`.nii`/`.nii.gz` (NIfTI-1) and `.nrrd` (detached-free NRRD, raw or gzip
encoding) — from their public specifications, plus spacing-aware resampling
via scipy.

Conventions: arrays are returned as [S, H, W] (slice-major, matching the
reference's sitk GetArrayFromImage z,y,x order) with `spacing` as
(sx, sy, sz) in x,y,z order like sitk's GetSpacing.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Tuple

import numpy as np
from scipy import ndimage

# NIfTI-1 datatype codes -> numpy dtypes
_NIFTI_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_NIFTI_CODES = {np.dtype(v): k for k, v in _NIFTI_DTYPES.items()}


def _open_maybe_gz(path: str, mode: str = "rb"):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path: str) -> Tuple[np.ndarray, Tuple[float, float, float]]:
    """Read a NIfTI-1 file -> (volume [S,H,W], spacing (sx,sy,sz))."""
    with _open_maybe_gz(path) as f:
        hdr = f.read(352)
        sizeof_hdr = struct.unpack("<i", hdr[0:4])[0]
        if sizeof_hdr != 348:
            raise ValueError(f"{path}: not a little-endian NIfTI-1 file")
        dim = struct.unpack("<8h", hdr[40:56])
        datatype = struct.unpack("<h", hdr[70:72])[0]
        pixdim = struct.unpack("<8f", hdr[76:108])
        vox_offset = int(struct.unpack("<f", hdr[108:112])[0])
        scl_slope = struct.unpack("<f", hdr[112:116])[0]
        scl_inter = struct.unpack("<f", hdr[116:120])[0]
        ndim = dim[0]
        shape_xyz = dim[1:1 + max(ndim, 3)]
        if datatype not in _NIFTI_DTYPES:
            raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
        dtype = np.dtype(_NIFTI_DTYPES[datatype])
        f.seek(vox_offset)
        n_items = int(np.prod(shape_xyz))
        data = np.frombuffer(f.read(n_items * dtype.itemsize), dtype=dtype)
    vol = data.reshape(shape_xyz[::-1])  # fortran order on disk -> [.., z, y, x]
    while vol.ndim > 3 and vol.shape[0] == 1:
        vol = vol[0]
    if vol.ndim == 2:
        vol = vol[None]
    if scl_slope not in (0.0, 1.0):
        vol = vol * scl_slope + scl_inter
    spacing = (float(pixdim[1]), float(pixdim[2]), float(pixdim[3]) or 1.0)
    return np.ascontiguousarray(vol), spacing


def write_nifti(path: str, volume: np.ndarray,
                spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)) -> None:
    """Write [S,H,W] volume as minimal single-file NIfTI-1 (.nii / .nii.gz)."""
    vol = np.asarray(volume)
    if vol.ndim == 2:
        vol = vol[None]
    if vol.dtype == np.float64:
        vol = vol.astype(np.float32)
    if vol.dtype == np.int64:
        vol = vol.astype(np.int32)
    if vol.dtype == bool:
        vol = vol.astype(np.uint8)
    code = _NIFTI_CODES.get(vol.dtype)
    if code is None:
        vol = vol.astype(np.float32)
        code = _NIFTI_CODES[np.dtype(np.float32)]
    s, h, w = vol.shape
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, w, h, s, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, vol.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<8f", hdr, 76, 1.0, spacing[0], spacing[1], spacing[2],
                     0, 0, 0, 0)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)    # scl_slope
    # sform identity-ish with spacing so readers reconstruct geometry
    struct.pack_into("<h", hdr, 254, 1)      # sform_code
    struct.pack_into("<4f", hdr, 280, spacing[0], 0, 0, 0)  # srow_x
    struct.pack_into("<4f", hdr, 296, 0, spacing[1], 0, 0)  # srow_y
    struct.pack_into("<4f", hdr, 312, 0, 0, spacing[2], 0)  # srow_z
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + vol.tobytes()
    with _open_maybe_gz(path, "wb") as f:
        f.write(payload)


def read_nrrd(path: str) -> Tuple[np.ndarray, Tuple[float, float, float]]:
    """Read an attached NRRD file -> (volume [S,H,W], spacing (sx,sy,sz))."""
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"NRRD"):
            raise ValueError(f"{path}: not an NRRD file")
        fields = {}
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n", b""):
                break
            text = line.decode("ascii", "replace").strip()
            if text.startswith("#") or ":" not in text:
                continue
            key, _, value = text.partition(":")
            fields[key.strip().lower()] = value.lstrip("=").strip()
        raw = f.read()

    sizes = [int(v) for v in fields["sizes"].split()]
    dtype = np.dtype({
        "uchar": np.uint8, "unsigned char": np.uint8, "uint8": np.uint8,
        "short": np.int16, "int16": np.int16, "ushort": np.uint16,
        "int": np.int32, "int32": np.int32, "uint": np.uint32,
        "float": np.float32, "double": np.float64,
        "long": np.int64, "int64": np.int64,
    }[fields.get("type", "float")])
    encoding = fields.get("encoding", "raw")
    if encoding in ("gzip", "gz"):
        raw = gzip.decompress(raw)
    elif encoding != "raw":
        raise ValueError(f"{path}: unsupported NRRD encoding {encoding}")
    data = np.frombuffer(raw, dtype=dtype, count=int(np.prod(sizes)))
    vol = data.reshape(sizes[::-1])  # fastest axis first on disk
    if vol.ndim == 2:
        vol = vol[None]

    spacing = (1.0, 1.0, 1.0)
    if "space directions" in fields:
        vecs = []
        for token in fields["space directions"].replace("(", " ").split(")"):
            token = token.strip().strip(",")
            if not token or token == "none":
                continue
            vecs.append([float(x) for x in token.split(",")])
        if vecs:
            norms = [float(np.linalg.norm(v)) for v in vecs]
            while len(norms) < 3:
                norms.append(1.0)
            spacing = tuple(norms[:3])
    elif "spacings" in fields:
        sp = [float(v) for v in fields["spacings"].split()]
        while len(sp) < 3:
            sp.append(1.0)
        spacing = tuple(sp[:3])
    return np.ascontiguousarray(vol), spacing


def write_nrrd(path: str, volume: np.ndarray,
               spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
               compress: bool = True) -> None:
    """Write [S,H,W] as attached NRRD (gzip encoding by default)."""
    vol = np.asarray(volume)
    if vol.ndim == 2:
        vol = vol[None]
    type_name = {
        np.dtype(np.uint8): "uint8", np.dtype(np.int16): "int16",
        np.dtype(np.uint16): "ushort", np.dtype(np.int32): "int32",
        np.dtype(np.float32): "float", np.dtype(np.float64): "double",
        np.dtype(np.int64): "int64",
    }.get(vol.dtype)
    if type_name is None:
        vol = vol.astype(np.float32)
        type_name = "float"
    s, h, w = vol.shape
    sx, sy, sz = spacing
    header = (
        "NRRD0004\n"
        f"type: {type_name}\n"
        "dimension: 3\n"
        "space: left-posterior-superior\n"
        f"sizes: {w} {h} {s}\n"
        f"space directions: ({sx},0,0) (0,{sy},0) (0,0,{sz})\n"
        "kinds: domain domain domain\n"
        "endian: little\n"
        f"encoding: {'gzip' if compress else 'raw'}\n"
        "space origin: (0,0,0)\n\n"
    )
    payload = vol.tobytes()
    if compress:
        payload = gzip.compress(payload)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(payload)


def read_volume(path: str) -> Tuple[np.ndarray, Tuple[float, float, float]]:
    """Format dispatch by extension."""
    if path.endswith((".nii", ".nii.gz")):
        return read_nifti(path)
    if path.endswith(".nrrd"):
        return read_nrrd(path)
    if path.endswith(".npy"):
        return np.load(path), (1.0, 1.0, 1.0)
    raise ValueError(f"unsupported volume format: {path}")


def resample_by_spacing(volume: np.ndarray, spacing: Tuple[float, float, float],
                        new_spacing, order: int = 1,
                        label: bool = False) -> Tuple[np.ndarray, Tuple[float, ...]]:
    """In-plane (and optionally through-plane) resampling
    (dataset_utils.resample_by_spacing:38-70). `new_spacing` entries <= 0
    keep the original spacing on that axis (the reference's -1 convention,
    e.g. new_spacing [1.36719, 1.36719, -1])."""
    sx, sy, sz = spacing
    tx = new_spacing[0] if new_spacing[0] and new_spacing[0] > 0 else sx
    ty = new_spacing[1] if len(new_spacing) > 1 and new_spacing[1] and new_spacing[1] > 0 else sy
    tz = new_spacing[2] if len(new_spacing) > 2 and new_spacing[2] and new_spacing[2] > 0 else sz
    zoom = (sz / tz, sy / ty, sx / tx)  # volume is [S,H,W] = [z,y,x]
    if np.allclose(zoom, 1.0):
        return volume, (tx, ty, tz)
    if label:
        out = ndimage.zoom(volume, zoom, order=0)
    else:
        out = ndimage.zoom(volume.astype(np.float32), zoom, order=order)
    return out, (tx, ty, tz)


def crop_or_pad(volume: np.ndarray, target_hw: Tuple[int, int],
                pad_value: float = 0.0) -> np.ndarray:
    """Center crop/pad each slice to target (H, W)
    (basic_operations.crop_or_pad:188-234)."""
    s, h, w = volume.shape
    th, tw = target_hw
    out = np.full((s, th, tw), pad_value, dtype=volume.dtype)
    src_y0 = max((h - th) // 2, 0)
    src_x0 = max((w - tw) // 2, 0)
    dst_y0 = max((th - h) // 2, 0)
    dst_x0 = max((tw - w) // 2, 0)
    cy = min(h, th)
    cx = min(w, tw)
    out[:, dst_y0:dst_y0 + cy, dst_x0:dst_x0 + cx] = \
        volume[:, src_y0:src_y0 + cy, src_x0:src_x0 + cx]
    return out
