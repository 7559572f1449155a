"""NIfTI import/export utilities (numpy only; a copy of
``qbold_vi_tpu/io/nifti.py``, which the port cannot import).

Mirrors the reference's artifact layout (reference: model.py:792-802,
loglinear.py:53-65): per-map ``<name>_oef/_dbv/_r2p/_logstds/...`` NIfTI
files where the subject axis is folded into the last (volume) dimension.

nibabel is used when available; otherwise a minimal built-in NIfTI-1
reader/writer (float32/float64, identity affine, gzip via stdlib) keeps
the framework fully standalone -- the reference hard-depends on nibabel
(requirements.txt), we degrade gracefully.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional

import numpy as np

__all__ = ["save_im_data", "load_nifti", "save_nifti", "have_nibabel"]

_DTYPES = {16: np.float32, 64: np.float64, 4: np.int16, 8: np.int32,
           2: np.uint8}
_CODES = {np.dtype(np.float32): (16, 32), np.dtype(np.float64): (64, 64),
          np.dtype(np.int16): (4, 16), np.dtype(np.int32): (8, 32),
          np.dtype(np.uint8): (2, 8)}


def have_nibabel() -> bool:
    try:
        import nibabel  # noqa: F401
        return True
    except ImportError:
        return False


def _write_nifti1(data: np.ndarray, path: str) -> None:
    """Minimal NIfTI-1 writer: 348-byte header + 4 pad bytes + raw data,
    gzipped when the path ends in .gz. Identity affine (sform)."""
    data = np.asarray(data)
    if data.dtype not in _CODES:
        data = data.astype(np.float32)
    code, bitpix = _CODES[data.dtype]
    ndim = data.ndim
    assert 1 <= ndim <= 7, f"NIfTI supports <=7 dims, got {ndim}"

    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)                    # sizeof_hdr
    dims = [ndim] + list(data.shape) + [1] * (7 - ndim)
    struct.pack_into("<8h", hdr, 40, *dims)                # dim
    struct.pack_into("<h", hdr, 70, code)                  # datatype
    struct.pack_into("<h", hdr, 72, bitpix)                # bitpix
    struct.pack_into("<8f", hdr, 76, 1.0, *([1.0] * 7))    # pixdim
    struct.pack_into("<f", hdr, 108, 352.0)                # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)                  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)                  # scl_inter
    struct.pack_into("<h", hdr, 252, 0)                    # qform_code
    struct.pack_into("<h", hdr, 254, 1)                    # sform_code
    struct.pack_into("<4f", hdr, 280, 1.0, 0.0, 0.0, 0.0)  # srow_x
    struct.pack_into("<4f", hdr, 296, 0.0, 1.0, 0.0, 0.0)  # srow_y
    struct.pack_into("<4f", hdr, 312, 0.0, 0.0, 1.0, 0.0)  # srow_z
    hdr[344:348] = b"n+1\x00"                              # magic

    payload = bytes(hdr) + np.ascontiguousarray(data, data.dtype).tobytes(
        order="F")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)


def _read_nifti1(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    (sizeof_hdr,) = struct.unpack_from("<i", raw, 0)
    assert sizeof_hdr == 348, f"not a NIfTI-1 file: {path}"
    dims = struct.unpack_from("<8h", raw, 40)
    ndim = dims[0]
    shape = dims[1:1 + ndim]
    (code,) = struct.unpack_from("<h", raw, 70)
    (vox_offset,) = struct.unpack_from("<f", raw, 108)
    dtype = _DTYPES[code]
    n = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=n, offset=int(vox_offset))
    data = data.reshape(shape, order="F")
    # Apply the header's affine scaling exactly like nibabel's
    # get_fdata: scanner exports commonly store int16 with
    # scl_slope/inter set, and returning the raw integers would be
    # silently ~1/slope x wrong (slope 0 means "no scaling" per spec)
    (scl_slope,) = struct.unpack_from("<f", raw, 112)
    (scl_inter,) = struct.unpack_from("<f", raw, 116)
    if not np.isfinite(scl_slope):
        scl_slope = 1.0
    if not np.isfinite(scl_inter):
        scl_inter = 0.0
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        return (data.astype(np.float64)
                * (scl_slope if scl_slope != 0.0 else 1.0) + scl_inter)
    return data.copy()


def load_nifti(path: str) -> np.ndarray:
    if have_nibabel():
        import nibabel as nib
        return np.asarray(nib.load(path).get_fdata())
    return _read_nifti1(path)


def save_nifti(data: np.ndarray, path: str, header=None) -> None:
    # a fresh output prefix (`infer -o new_dir/maps`) must not crash
    # after the whole compute because new_dir does not exist yet
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    if have_nibabel():
        import nibabel as nib
        nib.save(nib.Nifti1Image(np.asarray(data), affine=None,
                                 header=header), path)
        return
    if header is not None:
        import warnings
        warnings.warn(
            f"nibabel unavailable: writing {path} with the built-in "
            "NIfTI-1 writer, which cannot copy the provided header -- "
            "affine/orientation metadata will be identity", stacklevel=2)
    _write_nifti1(np.asarray(data), path)


def save_im_data(im_data: np.ndarray, filename: str,
                 transform_directory: Optional[str] = None) -> None:
    """Save a (S, X, Y, Z, C) map as ``<filename>.nii.gz`` with subjects
    folded into the last axis (reference: model.py:792-802). When a
    transform directory is given (and nibabel is available), the header
    is copied from its ``example.nii.gz``."""
    images = np.split(np.asarray(im_data), im_data.shape[0], axis=0)
    images = np.squeeze(np.concatenate(images, axis=-1), 0)
    header = None
    if transform_directory is not None and have_nibabel():
        import nibabel as nib
        example = os.path.join(transform_directory, "example.nii.gz")
        if os.path.isfile(example):
            header = nib.load(example).header.copy()
    save_nifti(images, filename + ".nii.gz", header=header)
