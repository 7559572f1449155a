"""Full-brain posterior maps, likelihood/KL/residual maps and their NIfTI
export (PyTorch).

The counterpart of ``qbold_vi_tpu/infer.py::posterior_maps``,
``elbo_maps`` and ``save_predictions``: the serving path. Volumes
(S, X, Y, Z, T+1) carry the brain mask as their last channel and go to
the device a chunk of subjects at a time. Two streams and two estimators,
as in the JAX package:

* stream 1 (``use_first_op=True``, pretrained weights) with
  ``fused_infer`` resolved on, its trunk at the encoder's dtype
  (``compute_dtype``; JAX infer.py:144): with ``method="quadrature"``
  ONE kernel per chunk, ops/fused_infer.py::encode_quad_fused (mask,
  normalise, dense chain, head, quadrature, raw-log-std transforms); with
  ``method="mc"`` the encode kernel encode_q1_packed (q (5, N)) and then
  the sampled summaries, ops/summarize.py::mc_posterior_summaries_packed;
* stream 2 (``use_first_op=False``, fine-tuned weights), or stream 1 with
  ``fused_infer`` off: the encoder (its trunk in float32 with TF32 off,
  or in bf16 with float32 sums under ``compute_dtype="bfloat16"``; its 3x3
  convs by cuDNN, or by kernel H under ``fused_conv="on"``) and then
  ops/quadrature.py::quad_posterior_summaries or
  ops/summarize.py::mc_posterior_summaries on the (N, K) rows.

``elbo_maps`` (the fine-tuned export's ``_likelihood/_kl/_residual``
maps) streams S decode passes per chunk as plain torch ops with O(voxels)
state, and takes an MVG head's sampled KL map from
ops/summarize.py::mc_kl_map (kernel E on the card, its plain version on
the CPU), any other head's from train/losses.py::kl_loss.

Randomness: where the JAX package splits a PRNG key, every draw here goes
through ``draw_noise`` -- the one place a caller (or a test) can swap in
other numbers. Kernels D and E draw normal pair d of voxel v from a
Philox4x32-10 counter (v, d), v the voxel's index in the whole request,
keyed by a seed derived from the caller's ``seed`` and the stream's name;
the plain versions replay the same counters on the CPU. The maps thus do
not depend on ``chunk``, and the summaries and the KL map never share
draws. The decode passes draw from torch generators on the device, one
per subject and pass.

Chunks are uploaded voxel-major as they lie (the kernels take both
layouts, so the host transpose the TPU path pays for a channel-major
upload is skipped), and the per-chunk results stay on the device until
one copy back at the end.

``save_predictions(transform_directory=)`` adds the FSL MNI-space export
(io/fsl.py) where FSL and nibabel are installed, and takes the maps'
NIfTI header from the directory's ``example.nii.gz`` where nibabel is.

Under a mesh (parallel/mesh.py), ``posterior_maps_sharded`` and
``elbo_maps_sharded`` (the JAX infer.py:494-681) pad the subjects to a
multiple of the world size, run each rank's subjects through the paths
above, all-gather the maps and slice the padding off. Every draw is keyed
by its GLOBAL subject or voxel index (each rank passes its first
subject's index as ``start``), so the sharded maps take exactly the
single-device draws, as the JAX ``_chunk_key_chain`` arranges;
``save_predictions(mesh=)`` routes to them and writes its files on rank 0.
"""

from __future__ import annotations

import hashlib
import warnings

import numpy as np
import torch

from .config import QBoldConfig, normalize_mode
from .models.vi import FineTuner
from .ops.fused_infer import (encode_q1_packed, encode_quad_fused,
                              fused_infer_available)
from .ops.quadrature import quad_posterior_summaries
from .ops.summarize import (mc_draws, mc_kl_map, mc_normals,
                            mc_posterior_summaries,
                            mc_posterior_summaries_packed)
from .parallel import mesh as pmesh
from .train import losses

__all__ = ["posterior_maps", "elbo_maps", "save_predictions",
           "posterior_maps_sharded", "elbo_maps_sharded",
           "to_channel_major", "draw_noise"]


def _check_method(method: str) -> None:
    """Validate the estimator name at the API boundary."""
    if method not in ("quadrature", "mc"):
        raise ValueError(
            f"method must be 'quadrature' or 'mc', got {method!r}")


def _stream_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one named stream of draws, derived from the
    caller's seed (BLAKE2b), so that streams never share draws."""
    h = hashlib.blake2b(repr((int(seed),) + tags).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def draw_noise(stream: str, seed: int, start: int, shape: tuple, draws: int,
               device, index: int | None = None) -> dict:
    """The noise of one chunk's MC stream, as keyword arguments: the one
    place the maps draw from.

    ``shape`` is the chunk's (B, X, Y, Z), ``start`` the index of its first
    subject in the request, ``seed`` the caller's seed of posterior_maps
    or elbo_maps. Streams:

    * "summaries" (kernel D's ``draws`` normal pairs a voxel) and "kl"
      (kernel E's ``draws``): ``{"seed", "offset"}`` -- the Philox
      counters (offset + v, d) under a seed of this stream, offset the
      global index of the chunk's first voxel; kernel D or E draws them
      on the card and the plain versions replay them;
    * "decode": ``{"z": (B, X, Y, Z, 2)}``, the normals of decode pass
      ``index`` (of ``draws``), from a torch generator on ``device``
      seeded by (stream seed, subject, pass).

    A replacement returns ``{"z": tensor}`` for every stream, with
    (draws, B, X, Y, Z, 2) normals for "summaries" and "kl"."""
    key = _stream_seed(seed, stream)
    if stream != "decode":
        return {"seed": key, "offset": start * int(np.prod(shape[1:]))}
    out = []
    for b in range(shape[0]):
        gen = torch.Generator(device=device)
        gen.manual_seed(_stream_seed(key, start + b, index))
        out.append(torch.randn(tuple(shape[1:]) + (2,), generator=gen,
                               device=device))
    return {"z": torch.stack(out)}


def _flat_noise(noise: dict, n: int) -> dict:
    """draw_noise's keyword arguments for a kernel wrapper over the N
    voxels of the chunk: host normals flattened to (draws, N, 2)."""
    if "z" in noise:
        z = noise["z"]
        return {"z": z.reshape(z.shape[0], n, 2).contiguous()}
    return noise


def to_channel_major(data: np.ndarray) -> np.ndarray:
    """``(..., C)`` volumes -> contiguous channel-major ``(C, N)``, the
    kernel's ``input_layout="channel"`` form."""
    return np.ascontiguousarray(
        np.asarray(data).reshape(-1, data.shape[-1]).T)


def _resolve_fused_infer(cfg, device: torch.device) -> bool:
    """ModelConfig.fused_infer -> whether stream 1 runs the fused kernel.
    "auto" is on for CUDA devices when the activation is covered, at every
    width and depth (the JAX rule); "on" forces it (raising for an
    uncovered activation), on a CPU device through the kernel's plain
    version; "interpret" (the JAX package's Mosaic-interpreter mode) has
    no meaning here and is taken as "on"."""
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


def _raw_log_stds(tuner: FineTuner, q: torch.Tensor, dim: int):
    """The squashed log-std (and offdiag) channels of raw heads q, taken
    along ``dim``."""
    dist, sel = tuner.dist, (lambda i: q.narrow(dim, i, 1))  # noqa: E731
    raws = [dist.transform_std(sel(1)), dist.transform_std(sel(3))]
    if tuner.cfg.use_mvg:
        raws.append(dist.transform_offdiag(sel(4)))
    return torch.cat(raws, dim)


def _chunk_fused(tuner: FineTuner, block: torch.Tensor, mc) -> dict:
    cfg = tuner.cfg
    trunk = ("bfloat16" if tuner.encoder.dtype == torch.bfloat16
             else "float32")
    enc = dict(se_idx=tuner.scan.se_idx,
               multi_image=cfg.multi_image_normalisation,
               activation=cfg.activation,
               n_blocks=cfg.no_intermediate_layers, trunk=trunk,
               mask_channel=True, input_layout="voxel")
    if mc is None:
        means, variances, raw = encode_quad_fused(
            block, tuner.encoder, **enc, **_quad_kwargs(tuner))
        if not cfg.use_mvg:
            raw = raw[:2]
    else:
        q_t = encode_q1_packed(block, tuner.encoder, **enc)
        means, variances = mc_posterior_summaries_packed(
            q_t, **mc, **_quad_kwargs(tuner))
        raw = _raw_log_stds(tuner, q_t, 0)
    shape = block.shape[:-1]
    return {k: v.T.reshape(shape + (v.shape[0],)) for k, v in
            (("means", means), ("stds", variances), ("raw_log_stds", raw))}


def _chunk_encoder(tuner: FineTuner, block: torch.Tensor,
                   use_first_op: bool, mc) -> dict:
    cfg = tuner.cfg
    masked = block[..., :-1] * block[..., -1:]
    if use_first_op:
        q = tuner.encoder.stream1(masked)
        if cfg.infer_inv_gamma:
            q = q[..., :-4]
    else:
        q = tuner.encode(masked)[1]
    rows = q.reshape(-1, q.shape[-1])
    if mc is None:
        means, variances = quad_posterior_summaries(rows,
                                                    **_quad_kwargs(tuner))
    else:
        means, variances = mc_posterior_summaries(rows, **mc,
                                                  **_quad_kwargs(tuner))
    shape = q.shape[:-1]
    return {"means": means.reshape(shape + (3,)),
            "stds": variances.reshape(shape + (3,)),
            "raw_log_stds": _raw_log_stds(tuner, q, -1)}


def _posterior_maps_device(tuner: FineTuner, data: np.ndarray, *, seed: int,
                           no_samples: int, use_first_op: bool, chunk: int,
                           method: str, antithetic: bool,
                           start: int = 0) -> dict:
    """posterior_maps' (means, stds, raw_log_stds) on the device;
    ``start`` is the request index of ``data``'s first subject."""
    device = tuner.device
    fused = use_first_op and _resolve_fused_infer(tuner.cfg, device)
    draws = mc_draws(no_samples, antithetic) if method == "mc" else 0
    outs = []
    for i in range(0, data.shape[0], chunk):
        block = torch.from_numpy(np.ascontiguousarray(
            data[i:i + chunk], dtype=np.float32)).to(device)
        mc = None
        if method == "mc":
            shape = tuple(block.shape[:-1])
            noise = draw_noise("summaries", seed, start + i, shape, draws,
                               device)
            mc = dict(_flat_noise(noise, int(np.prod(shape))),
                      no_samples=no_samples, antithetic=antithetic)
        outs.append(_chunk_fused(tuner, block, mc) if fused
                    else _chunk_encoder(tuner, block, use_first_op, mc))
    return {k: torch.cat([o[k] for o in outs], 0) for k in outs[0]}


def _maps_dict(cat: dict) -> dict:
    means = cat["means"]
    return {"oef": means[..., 0:1], "dbv": means[..., 1:2],
            "r2p": means[..., 2:3], "stds": cat["stds"],
            "raw_log_stds": cat["raw_log_stds"]}


def _rank_subjects(mesh, arr: np.ndarray) -> tuple:
    """(rows, lo): the rank's subjects of ``arr`` zero-padded to a multiple
    of the world size (padded subjects carry an all-zero mask), and the
    request index of its first."""
    n = arr.shape[0]
    lo, hi = pmesh.host_local_rows(mesh, n + (-n) % mesh.world_size)
    rows = np.zeros((hi - lo,) + arr.shape[1:], np.float32)
    rows[:max(min(hi, n) - lo, 0)] = arr[lo:hi]
    return rows, lo


@torch.no_grad()
def posterior_maps_sharded(tuner: FineTuner, data: np.ndarray, mesh, *,
                           seed: int = 0, no_samples: int = 200,
                           use_first_op: bool = True, chunk: int = 2,
                           method: str = "quadrature",
                           antithetic: bool = True) -> dict:
    """posterior_maps over ``mesh``: the subjects, of ANY count, are padded
    to a multiple of the world size; each rank maps its own through
    posterior_maps' path (kernel B, or C and D, for stream 1; the
    encoder, then A or D), keyed by their request indices, so its draws
    are posterior_maps'; the ranks all-gather the maps (the JAX
    posterior_maps_sharded). Every rank returns the whole request's
    numpy maps."""
    _check_method(method)
    rows, lo = _rank_subjects(mesh, data)
    local = _posterior_maps_device(
        tuner, rows, seed=seed, no_samples=no_samples,
        use_first_op=use_first_op, chunk=chunk, method=method,
        antithetic=antithetic, start=lo)
    n = data.shape[0]
    return _maps_dict({k: pmesh.all_gather_rows(mesh, v)[:n].cpu().numpy()
                       for k, v in local.items()})


@torch.no_grad()
def posterior_maps(tuner: FineTuner, data: np.ndarray, *, seed: int = 0,
                   no_samples: int = 200, use_first_op: bool = True,
                   chunk: int = 2, method: str = "quadrature",
                   antithetic: bool = True) -> dict:
    """Posterior mean/variance maps for (S, X, Y, Z, n_taus+1) masked
    volumes, on the tuner's device.

    ``method="quadrature"`` (default) evaluates the posterior expectations
    by deterministic Gaussian quadrature; ``method="mc"`` keeps the
    reference's sampled estimator with ``no_samples`` draws a voxel from
    ``seed`` (see draw_noise), in antithetic pairs (z, -z) unless
    ``antithetic=False`` asks for the reference's iid draws.

    Returns numpy maps: oef, dbv, r2p (each (S,X,Y,Z,1)), stds
    (S,X,Y,Z,3) -- the biased posterior variances of (OEF, DBV, R2'),
    which the reference saves as ``_logstds`` -- and raw_log_stds
    (S,X,Y,Z,2|3)."""
    _check_method(method)
    local = _posterior_maps_device(
        tuner, data, seed=seed, no_samples=no_samples,
        use_first_op=use_first_op, chunk=chunk, method=method,
        antithetic=antithetic)
    return _maps_dict({k: v.cpu().numpy() for k, v in local.items()})


def _elbo_maps_one(tuner: FineTuner, cfg: QBoldConfig, block, priors, *,
                   seed: int, start: int, no_samples: int, kl_samples: int,
                   with_kl: bool) -> dict:
    """Per-voxel likelihood / KL / residual maps of one chunk from the
    fine-tuned model (reference model.py:805-847). ``block`` is the raw
    (B, X, Y, Z, taus+1) chunk with the mask channel attached. The S
    stochastic decoder passes stream with O(voxels) state -- one posterior
    draw, one physics decode and one NLL row per pass, accumulating the
    NLL and the prediction -- as the JAX package's fori_loop does."""
    m = cfg.model
    mask = block[..., -1:]
    images = block[..., :-1] * mask
    _, q, im_sigma = tuner.encode(images)
    if not m.heteroscedastic_noise:
        im_sigma = torch.exp(tuner.log_sigma).expand(im_sigma.shape)
    shape = tuple(images.shape[:-1])
    msk = mask.expand(shape + (1,))
    nll_sum = images.new_zeros(shape + (1,))
    pred_sum = torch.zeros_like(images)
    for i in range(no_samples):
        z = draw_noise("decode", seed, start, shape, no_samples,
                       images.device, index=i)["z"]
        pred = tuner.decode(tuner.dist.sample(z, q, m.use_mvg))
        nll_sum = nll_sum + losses.fine_tune_nll(
            m, tuner.scan.se_idx, images, pred, im_sigma, msk,
            return_mean=False)
        pred_sum = pred_sum + pred
    out = {"likelihood": nll_sum / no_samples}
    mean_pred = pred_sum / no_samples
    if m.use_population_prior:
        priors = tuner.prior_params(q)
    if with_kl:
        n, k, device = int(np.prod(shape)), q.shape[-1], images.device
        if m.use_mvg:                # kernel E on the card, else its plain
            noise = draw_noise("kl", seed, start, shape, kl_samples, device)
            kl = mc_kl_map(q.reshape(n, k), priors.reshape(n, k),
                           **_flat_noise(noise, n), no_samples=kl_samples,
                           mvg=True)
            out["kl"] = torch.where(mask > 0, kl.reshape(mask.shape), 0.0)
        else:
            z = None                 # the analytic diagonal KL draws none
            if m.use_population_prior and m.mog_components > 1:
                noise = _flat_noise(draw_noise("kl", seed, start, shape, 1,
                                               device), n)
                z = mc_normals(noise.get("z"), noise.get("seed"),
                               noise.get("offset", 0), n, 1, device)
                # the mixture's OEF and DBV normals
                z = torch.movedim(z[0].reshape(shape + (2,)), -1, 0)
            out["kl"] = losses.kl_loss(tuner.dist, m, priors, q, mask, z=z,
                                       return_mean=False)

    # mean-|residual| map on normalised signals (reference model.py:838-847)
    eps = 1e-3
    se = tuner.scan.se_idx
    # the 3-image window clamps at the grid edge (se == 0 would slice
    # [-1:2], an empty window)
    lo, hi = (max(se - 1, 0), se + 2) if m.multi_image_normalisation \
        else (se, se + 1)
    t_ref = torch.mean(images[..., lo:hi], -1, keepdim=True)
    p_ref = torch.mean(mean_pred[..., lo:hi], -1, keepdim=True)
    out["residual"] = torch.mean(torch.abs(
        images / (t_ref + eps) - mean_pred / (p_ref + eps)), -1,
        keepdim=True)
    return out


@torch.no_grad()
def elbo_maps(tuner: FineTuner, cfg: QBoldConfig, data: np.ndarray,
              priors, seed: int = 0, no_samples: int = 100,
              chunk: int = 1) -> dict:
    """Chunked likelihood / KL / residual maps over subjects: numpy
    (S, X, Y, Z, 1) maps "likelihood" (the mean over ``no_samples``
    decode passes of the NLL), "kl" and "residual".

    The KL map needs a prior per voxel: ``priors`` (S, X, Y, Z, K)
    (predicted by the PRETRAINED encoder, reference train.py:26-31) or the
    model's own population prior; with neither, "kl" is omitted. For an
    MVG head it runs through ops/summarize.py::mc_kl_map (kernel E on the
    card, its plain version on the CPU), otherwise through
    losses.kl_loss."""
    local = _elbo_maps_device(tuner, cfg, data, priors, seed=seed,
                              no_samples=no_samples, chunk=chunk)
    return {k: v.cpu().numpy() for k, v in local.items()}


def _elbo_maps_device(tuner: FineTuner, cfg: QBoldConfig, data, priors, *,
                      seed: int, no_samples: int, chunk: int,
                      with_kl: bool | None = None, start: int = 0) -> dict:
    """elbo_maps' maps on the device; ``start`` is the request index of
    ``data``'s first subject."""
    if with_kl is None:
        with_kl = priors is not None or cfg.model.use_population_prior
    device = tuner.device
    outs = []
    for i in range(0, data.shape[0], chunk):
        block = torch.from_numpy(np.ascontiguousarray(
            data[i:i + chunk], dtype=np.float32)).to(device)
        p = None
        if priors is not None:
            p = torch.from_numpy(np.ascontiguousarray(
                priors[i:i + chunk], dtype=np.float32)).to(device)
        outs.append(_elbo_maps_one(
            tuner, cfg, block, p, seed=seed, start=start + i,
            no_samples=no_samples, kl_samples=100, with_kl=with_kl))
    return {k: torch.cat([o[k] for o in outs], 0) for k in outs[0]}


@torch.no_grad()
def elbo_maps_sharded(tuner: FineTuner, cfg: QBoldConfig, data: np.ndarray,
                      priors, mesh, *, seed: int = 0, no_samples: int = 100,
                      chunk: int = 1) -> dict:
    """elbo_maps over ``mesh``: subjects padded to a multiple of the world
    size (the padding's mask is zero), each rank's through elbo_maps'
    path (kernel E for an MVG head's KL map) under their request indices,
    so the maps take elbo_maps' draws; all-gathered, the padding sliced
    off (the JAX elbo_maps_sharded). Every rank returns the numpy maps."""
    with_kl = priors is not None or cfg.model.use_population_prior
    rows, lo = _rank_subjects(mesh, data)
    p = None if priors is None else _rank_subjects(mesh, priors)[0]
    local = _elbo_maps_device(tuner, cfg, rows, p, seed=seed,
                              no_samples=no_samples, chunk=chunk,
                              with_kl=with_kl, start=lo)
    n = data.shape[0]
    return {k: pmesh.all_gather_rows(mesh, v)[:n].cpu().numpy()
            for k, v in local.items()}


def save_predictions(tuner: FineTuner, cfg: QBoldConfig, data: np.ndarray,
                     filename: str, *, seed: int = 0,
                     transform_directory=None, use_first_op: bool = True,
                     fine_tuned: bool = False, priors=None, mesh=None,
                     method: str = "quadrature") -> dict:
    """Posterior summary export (reference model.py:772-887): writes
    ``<filename>_oef/_dbv/_r2p/_logstds/_raw_logstds.nii.gz`` (subjects
    folded into the last axis) and, with ``fine_tuned``, also
    ``_likelihood/_kl/_residual`` (``_kl`` only with ``priors`` or a
    population prior); returns the map dict. ``seed`` keys every draw
    (posterior_maps' and elbo_maps' streams are derived from it, never
    shared). With ``transform_directory`` (``nonlin<i>.nii.gz`` warps,
    ``MNI152_T1_2mm.nii.gz``, ``example.nii.gz``) the maps carry the
    example's header, and where FSL is installed the (OEF, DBV, R2') maps
    are also warped to MNI space (``_oef_mni`` ...; io/fsl.py) -- with a
    warning and without the warp where nibabel is missing, as the JAX
    package does (infer.py:778-792). With ``mesh`` the maps are
    posterior_maps_sharded's and elbo_maps_sharded's, every rank returns
    them, and rank 0 writes the files (rank 0 of an initialised process
    group without a mesh, too)."""
    from .io import fsl, nifti

    _check_method(method)
    if mesh is None:
        maps = posterior_maps(tuner, data, seed=seed,
                              use_first_op=use_first_op, method=method)
    else:
        maps = posterior_maps_sharded(tuner, data, mesh, seed=seed,
                                      use_first_op=use_first_op,
                                      method=method)
    suffixes = [("oef", "_oef"), ("dbv", "_dbv"), ("r2p", "_r2p"),
                ("stds", "_logstds"), ("raw_log_stds", "_raw_logstds")]
    if fine_tuned:
        if priors is None and not cfg.model.use_population_prior:
            warnings.warn(
                "fine-tuned export without priors or a population prior: "
                "the _kl map needs the pretrained-encoder priors "
                "(reference train.py:26-31) -- pass priors= (e.g. from "
                "train.data.predict_priors); exporting _likelihood/"
                "_residual only", stacklevel=2)
        extra = (elbo_maps(tuner, cfg, data, priors, seed) if mesh is None
                 else elbo_maps_sharded(tuner, cfg, data, priors, mesh,
                                        seed=seed))
        maps.update(extra)
        suffixes += [(k, "_" + k) for k in ("likelihood", "kl", "residual")
                     if k in extra]
    if (pmesh.process_index() if mesh is None else mesh.rank) != 0:
        return maps                  # rank 0 writes
    if transform_directory and fsl.have_fsl():
        if nifti.have_nibabel():
            fsl.warp_maps_to_mni(maps["oef"], maps["dbv"], maps["r2p"],
                                 filename, transform_directory)
        else:
            warnings.warn(
                "transform_directory given but nibabel is unavailable: "
                "skipping the MNI-space export (the built-in NIfTI "
                "fallback cannot carry the affines applywarp needs)",
                stacklevel=2)
    for key, suffix in suffixes:
        nifti.save_im_data(maps[key], filename + suffix, transform_directory)
    return maps
