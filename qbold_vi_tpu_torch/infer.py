"""Full-brain posterior maps and their NIfTI export (PyTorch).

The counterpart of ``qbold_vi_tpu/infer.py::posterior_maps`` and
``save_predictions``: the serving path. Volumes (S, X, Y, Z, T+1) carry
the brain mask as their last channel and go to the device a chunk of
subjects at a time. Two streams, as in the JAX package:

* stream 1 (``use_first_op=True``, pretrained weights) with
  ``fused_infer`` resolved on: ONE kernel per chunk,
  ops/fused_infer.py::encode_quad_fused (mask, normalise, dense chain,
  head, quadrature, raw-log-std transforms);
* stream 2 (``use_first_op=False``, fine-tuned weights), or stream 1 with
  ``fused_infer`` off: the encoder (torch Linear/conv2d in full float32)
  and then the quadrature kernel, ops/quadrature.py::
  quad_posterior_summaries.

Chunks are uploaded voxel-major as they lie (the kernel takes both
layouts, so the host transpose the TPU path pays for a channel-major
upload is skipped), and the per-chunk results stay on the device until
one copy back at the end.

Not ported yet, and raising ``NotImplementedError`` rather than doing
something else: ``method="mc"``, the fine-tuned likelihood/KL/residual
maps (``fine_tuned=True``), mesh-sharded export (``mesh=``) and the
FSL MNI-space export (``transform_directory=``).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import QBoldConfig, normalize_mode
from .models.vi import FineTuner
from .ops.fused_infer import encode_quad_fused, fused_infer_available
from .ops.quadrature import quad_posterior_summaries

__all__ = ["posterior_maps", "save_predictions", "to_channel_major"]


def _check_method(method: str) -> None:
    """Validate the estimator name; only quadrature is ported."""
    if method not in ("quadrature", "mc"):
        raise ValueError(
            f"method must be 'quadrature' or 'mc', got {method!r}")
    if method == "mc":
        raise NotImplementedError(
            "method='mc' (the sampled summaries, Pallas kernels C and D) is "
            "not ported yet: ROADMAP.md Queue 2")


def to_channel_major(data: np.ndarray) -> np.ndarray:
    """``(..., C)`` volumes -> contiguous channel-major ``(C, N)``, the
    kernel's ``input_layout="channel"`` form."""
    return np.ascontiguousarray(
        np.asarray(data).reshape(-1, data.shape[-1]).T)


def _resolve_fused_infer(cfg, device: torch.device) -> bool:
    """ModelConfig.fused_infer -> whether stream 1 runs the fused kernel.
    "auto" is on for CUDA devices when the activation is covered; "on"
    forces it (raising for an uncovered activation), on a CPU device
    through the kernel's plain version; "interpret" (the JAX package's
    Mosaic-interpreter mode) has no meaning here and is taken as "on"."""
    mode = normalize_mode(cfg.fused_infer, ("auto", "on", "off",
                                            "interpret"), "fused_infer")
    if mode == "off":
        return False
    ok = fused_infer_available(cfg.activation)
    if mode == "auto":
        return ok and torch.device(device).type == "cuda"
    if not ok:
        raise ValueError(
            f"fused_infer was forced on but activation {cfg.activation!r} "
            "has no kernel implementation (ops/fused_infer.SUPPORTED_ACTS)")
    return True


def _quad_kwargs(tuner: FineTuner) -> dict:
    cfg = tuner.cfg
    return dict(mvg=cfg.use_mvg, oef_range=cfg.oef_range,
                min_oef=cfg.min_oef, dbv_range=cfg.dbv_range,
                min_dbv=cfg.min_dbv,
                dw_coeff=float(tuner.scan.dw_coeff * tuner.scan.hct))


def _chunk_fused(tuner: FineTuner, block: torch.Tensor) -> dict:
    cfg = tuner.cfg
    means, variances, raw = encode_quad_fused(
        block, tuner.encoder, se_idx=tuner.scan.se_idx,
        multi_image=cfg.multi_image_normalisation,
        activation=cfg.activation, n_blocks=cfg.no_intermediate_layers,
        trunk="float32", mask_channel=True, input_layout="voxel",
        **_quad_kwargs(tuner))
    if not cfg.use_mvg:
        raw = raw[:2]
    shape = block.shape[:-1]
    return {k: v.T.reshape(shape + (v.shape[0],)) for k, v in
            (("means", means), ("stds", variances), ("raw_log_stds", raw))}


def _chunk_encoder(tuner: FineTuner, block: torch.Tensor,
                   use_first_op: bool) -> dict:
    cfg = tuner.cfg
    masked = block[..., :-1] * block[..., -1:]
    if use_first_op:
        q = tuner.encoder.stream1(masked)
        if cfg.infer_inv_gamma:
            q = q[..., :-4]
    else:
        q = tuner.encode(masked)[1]
    dist = tuner.dist
    raws = [dist.transform_std(q[..., 1:2]), dist.transform_std(q[..., 3:4])]
    if cfg.use_mvg:
        raws.append(dist.transform_offdiag(q[..., 4:5]))
    means, variances = quad_posterior_summaries(
        q.reshape(-1, q.shape[-1]), **_quad_kwargs(tuner))
    shape = q.shape[:-1]
    return {"means": means.reshape(shape + (3,)),
            "stds": variances.reshape(shape + (3,)),
            "raw_log_stds": torch.cat(raws, -1)}


@torch.no_grad()
def posterior_maps(tuner: FineTuner, data: np.ndarray, *,
                   use_first_op: bool = True, chunk: int = 2,
                   method: str = "quadrature") -> dict:
    """Posterior mean/variance maps for (S, X, Y, Z, n_taus+1) masked
    volumes, on the tuner's device.

    Returns numpy maps: oef, dbv, r2p (each (S,X,Y,Z,1)), stds
    (S,X,Y,Z,3) -- the biased posterior variances of (OEF, DBV, R2'),
    which the reference saves as ``_logstds`` -- and raw_log_stds
    (S,X,Y,Z,2|3)."""
    _check_method(method)
    device = tuner.device
    fused = use_first_op and _resolve_fused_infer(tuner.cfg, device)
    outs = []
    for i in range(0, data.shape[0], chunk):
        block = torch.from_numpy(np.ascontiguousarray(
            data[i:i + chunk], dtype=np.float32)).to(device)
        outs.append(_chunk_fused(tuner, block) if fused
                    else _chunk_encoder(tuner, block, use_first_op))
    cat = {k: torch.cat([o[k] for o in outs], 0).cpu().numpy()
           for k in outs[0]}
    means = cat["means"]
    return {"oef": means[..., 0:1], "dbv": means[..., 1:2],
            "r2p": means[..., 2:3], "stds": cat["stds"],
            "raw_log_stds": cat["raw_log_stds"]}


def save_predictions(tuner: FineTuner, cfg: QBoldConfig, data: np.ndarray,
                     filename: str, *, transform_directory=None,
                     use_first_op: bool = True, fine_tuned: bool = False,
                     priors=None, mesh=None,
                     method: str = "quadrature") -> dict:
    """Posterior summary export: writes ``<filename>_oef/_dbv/_r2p/
    _logstds/_raw_logstds.nii.gz`` (subjects folded into the last axis)
    and returns the map dict of ``posterior_maps``."""
    from .io import nifti

    if fine_tuned or priors is not None:
        raise NotImplementedError(
            "fine_tuned=True (the _likelihood/_kl/_residual maps, "
            "infer.elbo_maps) is not ported yet: ROADMAP.md")
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (sharded export) is not ported yet: ROADMAP.md")
    if transform_directory is not None:
        raise NotImplementedError(
            "transform_directory= (FSL MNI-space export, io/fsl.py) is not "
            "ported yet: ROADMAP.md")
    del cfg  # the tuner carries the model config; kept for API parity
    maps = posterior_maps(tuner, data, use_first_op=use_first_op,
                          method=method)
    for key, suffix in (("oef", "_oef"), ("dbv", "_dbv"), ("r2p", "_r2p"),
                        ("stds", "_logstds"),
                        ("raw_log_stds", "_raw_logstds")):
        nifti.save_im_data(maps[key], filename + suffix)
    return maps
