"""FSL shell-out adapter: the MNI-space export.

The counterpart of ``qbold_vi_tpu/io/fsl.py`` (reference model.py:849-879,
loglinear.py:34-52): the FSL binaries run through explicit argument lists
behind this one module; ``have_fsl()`` says whether they are installed,
and the training and inference paths never depend on them.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from typing import Sequence

import numpy as np

__all__ = ["have_fsl", "applywarp", "fslmerge", "warp_maps_to_mni"]


def have_fsl() -> bool:
    return shutil.which("applywarp") is not None


def _run(cmd: Sequence[str]) -> None:
    """Run a tool with its output on this process's stderr, as it happens:
    ``serve`` speaks JSON lines on stdout, which FSL's chatter must never
    interleave, while a long tool (fsl_anat runs minutes) still shows its
    progress. Where sys.stderr has no file descriptor (a capture
    wrapper), the output is captured and replayed there. Raises
    CalledProcessError on a non-zero exit."""
    try:
        sys.stderr.flush()
        stderr_fd = sys.stderr.fileno()
    except (OSError, ValueError, AttributeError):
        res = subprocess.run(list(cmd), capture_output=True, text=True)
        if res.stdout:
            print(res.stdout, end="", file=sys.stderr)
        if res.stderr:
            print(res.stderr, end="", file=sys.stderr)
        if res.returncode:
            raise subprocess.CalledProcessError(
                res.returncode, list(cmd), res.stdout, res.stderr)
        return
    res = subprocess.run(list(cmd), stdout=stderr_fd,
                         stderr=subprocess.STDOUT)
    if res.returncode:
        raise subprocess.CalledProcessError(res.returncode, list(cmd))


def applywarp(in_path: str, out_path: str, warp: str, ref: str) -> None:
    _run(["applywarp", f"--in={in_path}", f"--out={out_path}",
          f"--warp={warp}", f"--ref={ref}"])


def fslmerge(out_path: str, in_paths: Sequence[str]) -> None:
    _run(["fslmerge", "-t", out_path, *in_paths])


def warp_maps_to_mni(oef: np.ndarray, dbv: np.ndarray, r2p: np.ndarray,
                     filename: str, transform_directory: str) -> None:
    """Warp each subject's (OEF, DBV, R2') maps to MNI space with its
    nonlinear warp, merge them and split the merged series by map
    (reference model.py:849-879): ``<filename>_{oef,dbv,r2p}_mni.nii.gz``.
    ``transform_directory`` holds ``nonlin<i>.nii.gz`` a subject and
    ``MNI152_T1_2mm.nii.gz``. Needs nibabel: the built-in NIfTI writer
    carries identity affines, on which applywarp would give silently
    misoriented maps, so it refuses before any FSL command runs."""
    from . import nifti

    if not nifti.have_nibabel():
        raise RuntimeError(
            "MNI-space export requires nibabel (the built-in NIfTI "
            "fallback cannot carry the affine/orientation metadata "
            "applywarp needs)")

    ref_image = os.path.join(transform_directory, "MNI152_T1_2mm.nii.gz")
    merged = filename + "_merged.nii.gz"
    mni_parts = []
    for i in range(oef.shape[0]):
        warp = os.path.join(transform_directory, f"nonlin{i}.nii.gz")
        subj_ims = np.stack([oef[i], dbv[i], r2p[i]], 0)
        subj_im = f"{filename}_subj{i}"
        nifti.save_im_data(subj_ims, subj_im,
                           transform_directory=transform_directory)
        applywarp(subj_im, subj_im + "mni", warp, ref_image)
        mni_parts.append(subj_im + "mni")
    fslmerge(merged, mni_parts)

    import nibabel as nib
    merged_nib = nib.load(merged)
    merged_data = merged_nib.get_fdata()
    for t_idx, t in enumerate(["_oef_mni", "_dbv_mni", "_r2p_mni"]):
        nifti.save_nifti(merged_data[:, :, :, t_idx::3],
                         filename + t + ".nii.gz",
                         header=merged_nib.header.copy())
