"""Offline data preprocessing: raw ASE NIfTI -> the 5-D
``[subject, X, Y, Z, taus + gm_mask + brain_mask]`` ``.npy`` contract.

The port's own copy of ``qbold_vi_tpu/preprocess.py`` (reference
data_preprocessing.py:10-367; the port imports nothing of the JAX
package):

* every FSL invocation (mcflirt / fslmaths / bet / flirt / fsl_anat /
  convert_xfm / convertwarp / invwarp / applywarp / fslmerge) is an
  explicit argument list run by ``io.fsl._run`` (the tools' output on
  stderr), cached on output existence like the reference;
* NIfTI volumes are read by ``io.nifti.load_nifti`` (nibabel where
  installed, else the built-in NIfTI-1 reader);
* the numeric steps (SNR-profile estimation, slice averaging, stacking)
  are pure numpy;
* nothing runs on import.
"""

from __future__ import annotations

import os
import tarfile
from glob import glob
from os import path
from typing import Optional

import numpy as np

from .io import nifti
from .io.fsl import _run, fslmerge

__all__ = [
    "estimate_norm_snr",
    "average_slices",
    "average_fieldmaps",
    "prepare_image",
    "register_to_t1",
    "prepare_data",
    "reslice_images",
]


# ---- pure-numpy numeric steps ----------------------------------------------------


def estimate_norm_snr(data: np.ndarray, mask: np.ndarray,
                      se_idx: int = 3, corner: int = 12) -> np.ndarray:
    """Per-tau normalised SNR profile from image-corner noise
    (reference: data_preprocessing.py:10-63 -- the source of the
    hard-coded profile at signals.py:119).

    data: (X, Y, Z, n_taus) magnitudes; mask: (X, Y, Z) brain mask.
    SNR(tau) = mean within-mask signal / corner-noise std, normalised by
    the value at ``se_idx``.
    """
    n_taus = data.shape[-1]
    within = data.reshape(-1, n_taus)[mask.reshape(-1) > 0]
    corners = np.concatenate([
        data[1:corner, 1:corner],
        data[-corner:-1, -corner:-1],
        data[-corner:-1, 1:corner],
        data[1:corner, -corner:-1],
    ], 0).reshape(-1, n_taus)
    snr = within.mean(0) / corners.std(0)
    return snr / snr[se_idx]


def average_slices(image_data: np.ndarray, n: int,
                   mask_channels: int = 2) -> np.ndarray:
    """Average groups of ``n`` z-slices; masks re-binarised at 0.5
    (reference: data_preprocessing.py:310-313)."""
    if n <= 1:
        return image_data
    x, y = image_data.shape[0], image_data.shape[1]
    c = image_data.shape[-1]
    out = image_data.reshape((x, y, -1, n, c)).mean(3)
    masks = (out[..., -mask_channels:] >= 0.5).astype(out.dtype)
    return np.concatenate([out[..., :-mask_channels], masks], -1)


# ---- FSL-backed per-subject steps ------------------------------------------------


def prepare_image(image_filename: str) -> np.ndarray:
    """Motion-correct, mean, brain-extract one ASE series and return it
    with [gm_mask, brain_mask] channels appended
    (reference: data_preprocessing.py:180-267). Steps are cached on
    output-file existence exactly like the reference."""
    dir_name = path.dirname(image_filename)
    basename = path.basename(image_filename).split(".")[0]
    mean_image = f"{dir_name}/tmean_{basename}.nii.gz"
    brain_mask = f"{dir_name}/mask_{basename}_mask.nii.gz"
    mc_images = f"{dir_name}/mc_{basename}.nii.gz"
    ase_gm = f"{dir_name}/{basename}_gm.nii.gz"

    if not path.exists(mc_images):
        _run(["mcflirt", "-in", image_filename, "-out", mc_images,
              "-refvol", "2", "-stages", "4", "-sinc_final"])
    if not path.exists(mean_image):
        _run(["fslmaths", mc_images, "-Tmean", mean_image])
    if not path.exists(brain_mask):
        _run(["bet", mean_image, f"{dir_name}/mask_{basename}.nii.gz",
              "-R", "-Z", "-m", "-n"])

    img_data = nifti.load_nifti(mc_images)
    mask = nifti.load_nifti(brain_mask)
    gm = nifti.load_nifti(ase_gm) if path.isfile(ase_gm) else mask
    return np.concatenate([img_data, np.expand_dims(gm, -1),
                           np.expand_dims(mask, -1)], -1)


def average_fieldmaps(vdm_dir: str, warp_type_indicator: str,
                      shift_im: str) -> str:
    """Average the two SPM-produced EPI voxel-displacement (VDM) field
    maps for this acquisition into the mean shift map used for EPI
    distortion correction (reference: data_preprocessing.py:127-136:
    ``fslmaths f0 -add f1 -mul 0.5 shift_im``). ``warp_type_indicator``
    selects baseline ('B') vs hypervent ('H') maps, matching the
    reference's filename convention."""
    field_fnames = sorted(glob(f"{vdm_dir}/*{warp_type_indicator}*.nii"))
    if len(field_fnames) < 2:
        raise FileNotFoundError(
            f"need 2 SPM VDM field maps matching *{warp_type_indicator}* "
            f"in {vdm_dir}, found {len(field_fnames)}")
    _run(["fslmaths", field_fnames[0], "-add", field_fnames[1],
          "-mul", "0.5", shift_im])
    return shift_im


def register_to_t1(image_filename: str) -> tuple:
    """T1/MNI registration chain producing the per-subject nonlinear warp
    and GM mask (reference: data_preprocessing.py:66-177), including the
    SPM fieldmap (VDM) shift maps for EPI distortion correction, the
    ``T1_orig2roi`` concat, the WM+GM segmentation resampling, and the
    warped-mean QA image. Requires T1.nii, SPM ``c1T1``/``c2T1``
    segmentations, and a ``VDM/`` fieldmap directory next to the ASE
    series, plus a full FSL install; returns (warp_path, gm_mask_path).
    """
    dir_name = path.dirname(image_filename)
    basename = path.basename(image_filename).split(".")[0]
    mean_image = f"{dir_name}/tmean_{basename}.nii.gz"
    warped_mean_image = f"{dir_name}/tmean_warped{basename}.nii.gz"
    brain_mask = f"{dir_name}/mask_{basename}_mask.nii.gz"
    t1 = f"{dir_name}/T1.nii"
    t1_2mm = f"{dir_name}/T1_2mm.nii.gz"
    t1_2mm_mask = f"{dir_name}/T1_2mm_mask.nii.gz"
    t1_2mm_invmask = f"{dir_name}/T1_2mm_invmask.nii.gz"
    transform_matrix = f"{dir_name}/{basename}toT1.mat"
    transform_matrix_inv = f"{dir_name}/T1to{basename}.mat"
    transform_2_roi = f"{dir_name}/{basename}toT1_roi.mat"
    warp_to_std = f"{dir_name}/{basename}_warp_to_std.nii.gz"
    anat_dir = f"{dir_name}/T1_2mm.anat/"
    seg_wm_gm_out = f"{dir_name}/{basename}wm_gm"
    t1_to_ase_field = f"{dir_name}/{basename}_from_t1_field.nii.gz"
    ase_to_t1_field = f"{dir_name}/{basename}_to_t1_field.nii.gz"
    ase_gm = f"{dir_name}/{basename}_gm.nii.gz"
    shift_im = f"{dir_name}/{basename}ave_shift"

    if not path.exists(t1_2mm_mask):
        _run(["fslmaths", t1, "-subsamp2", t1_2mm])
        # heavily eroded mask for registering the ASE data; the inverted
        # mask for fsl_anat is NOT eroded (it disrupts std registration)
        _run(["fslmaths", t1_2mm, "-bin", "-kernel", "box", "25", "-ero",
              t1_2mm_mask])
        _run(["fslmaths", t1_2mm, "-bin", "-sub", "1", "-mul", "-1",
              t1_2mm_invmask])
    if not path.exists(anat_dir + "T1_to_MNI_nonlin_field.nii.gz"):
        _run(["fsl_anat", "-i", t1_2mm, "-m", t1_2mm_invmask, "--clobber",
              "--nobet"])
    if not path.exists(warped_mean_image):
        _run(["flirt", "-in", mean_image, "-ref", t1_2mm, "-dof", "7",
              "-inweight", brain_mask, "-omat", transform_matrix,
              "-searchrx", "-20", "20", "-searchry", "-20", "20",
              "-searchrz", "-20", "20", "-finesearch", "2",
              "-refweight", t1_2mm_mask])
        # ASE->T1 matrix concatenated into the anat ROI space
        # (reference: data_preprocessing.py:123-125)
        _run(["convert_xfm", "-omat", transform_2_roi, "-concat",
              f"{anat_dir}T1_orig2roi.mat", transform_matrix])
        # SPM EPI unwarping maps, averaged (reference :127-136); 'H' for
        # hypervent acquisitions, 'B' otherwise
        indicator = "H" if "hyperv_ase" in image_filename else "B"
        average_fieldmaps(f"{dir_name}/VDM", indicator, shift_im)
        # one combined ASE->MNI warp: shift map + affine + nonlinear
        # field (reference :138-140)
        _run(["convertwarp", "-r", f"{anat_dir}T1_to_MNI_nonlin.nii.gz",
              "-o", warp_to_std,
              "-w", f"{anat_dir}T1_to_MNI_nonlin_field.nii.gz",
              "-m", transform_2_roi, "-s", shift_im])
        # registration QA: nonlinearly warp the mean qBOLD image to MNI
        # (reference :142-145)
        _run(["applywarp", "-i", mean_image, "-w", warp_to_std,
              "-o", warped_mean_image,
              "-r", f"{anat_dir}T1_to_MNI_nonlin.nii.gz"])
    # NB existence check on the .nii.gz FSL actually writes: the
    # reference guards on the extensionless name (data_preprocessing.py
    # :147 vs :161), which never exists, so upstream re-runs this block
    # every call -- a documented upstream caching bug, fixed here.
    if not path.exists(seg_wm_gm_out + ".nii.gz"):
        # resample the SPM GM (c1) + WM (c2) segmentations into ASE space
        # and binarise their union (reference :147-162)
        _run(["convert_xfm", "-omat", transform_matrix_inv, "-inverse",
              transform_matrix])
        seg_ims_out = []
        for seg_basename in ("c1T1", "c2T1"):
            seg_im = f"{dir_name}/{seg_basename}.nii"
            seg_im_out = f"{dir_name}/{basename}_{seg_basename}"
            seg_ims_out.append(seg_im_out)
            _run(["flirt", "-in", seg_im, "-ref", mean_image,
                  "-init", transform_matrix_inv, "-applyxfm",
                  "-out", seg_im_out])
        _run(["fslmaths", seg_ims_out[0], "-add", seg_ims_out[1],
              "-thr", "0.5", "-bin", seg_wm_gm_out])
    if not path.exists(ase_gm):
        # GM mask in ASE space through the inverse of the
        # distortion-corrected ASE->T1 warp (reference :164-175)
        _run(["convertwarp", "-r", t1_2mm, "-o", ase_to_t1_field,
              "-s", shift_im, "-m", transform_matrix])
        _run(["invwarp", "-w", ase_to_t1_field, "-o", t1_to_ase_field,
              "-r", mean_image])
        _run(["applywarp", "-i", f"{dir_name}/c1T1.nii", "-r", mean_image,
              "-o", ase_gm, "-w", t1_to_ase_field])
        _run(["fslmaths", ase_gm, "-mas", brain_mask, "-thr", "0.5",
              ase_gm])
    return warp_to_std, ase_gm


def prepare_data(directory: str, orig_filebasename: str, *,
                 include_warp: bool = True, save_name: Optional[str] = None,
                 average_n_slices: int = 1) -> Optional[np.ndarray]:
    """Stack all subjects under ``directory`` into one 5-D ``.npy``
    (reference: data_preprocessing.py:270-345): per subject
    ``prepare_image`` (+ optional warp registration, tarred as
    ``nonlin<i>``), slice averaging, and fslmerge'd tmean/mask summaries.
    Returns the stacked array (also written to ``<save_name>.npy``)."""
    save_name = save_name or orig_filebasename
    results = sorted(glob(f"{directory}*/{orig_filebasename}.nii*"))
    shape = None
    data = []

    tar = None
    gm_paths = []
    if include_warp:
        tar_file = f"{directory}/warp_info{orig_filebasename}.tar.gz"
        if path.exists(tar_file):
            os.remove(tar_file)
        tar = tarfile.open(tar_file, "x:gz")

    for im_filename in results:
        image_data = prepare_image(im_filename)
        if shape is None:
            shape = image_data.shape
        if shape != image_data.shape:
            # Skip the subject from EVERY artifact, not just the stack:
            # tarring its warp / merging its GM mask anyway would shift
            # nonlin<i>/gm indices off the .npy subject axis and pair
            # subjects with the wrong registration downstream (the MNI
            # export reads nonlin<i> for npy subject i).
            import warnings
            warnings.warn(
                f"{im_filename}: shape {image_data.shape} != first "
                f"subject's {shape}; subject EXCLUDED from the stacked "
                f".npy, warps and GM merge", stacklevel=2)
            continue
        if include_warp:
            nonlin, gm_im = register_to_t1(im_filename)
            gm_paths.append(gm_im)
            tar.add(nonlin, arcname=f"nonlin{len(data)}.nii.gz")
        data.append(average_slices(image_data, average_n_slices))
    if tar is not None:
        tar.close()
        if gm_paths:
            fslmerge(f"{directory}/{orig_filebasename}_gm", gm_paths)

    stacked = None
    if data:
        stacked = np.stack(data, 0)
        np.save(f"{directory}/{save_name}.npy", stacked)

    for kind, prefix in (("tmean", "tmean_"), ("mask", "mask_")):
        pat = (f"{directory}*/{prefix}{orig_filebasename}_mask.nii*"
               if kind == "mask" else
               f"{directory}*/{prefix}{orig_filebasename}.nii*")
        found = sorted(glob(pat))
        if found:
            fslmerge(f"{directory}/{save_name}_{kind}", found)
    return stacked


def reslice_images(filename: str, binarise: bool = False, n: int = 4) -> None:
    """In-place z-averaging of a merged NIfTI
    (reference: data_preprocessing.py:353-363). With nibabel the header
    is kept; the built-in writer writes an identity affine."""
    data = nifti.load_nifti(filename)
    s = data.shape
    new = data.reshape((s[0], s[1], -1, n, s[-1])).mean(-2)
    if binarise:
        new = (new >= 0.5).astype(data.dtype)
    header = None
    if nifti.have_nibabel():
        import nibabel as nib
        header = nib.load(filename).header.copy()
    nifti.save_nifti(new, filename, header=header)
