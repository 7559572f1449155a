"""Train steps, epochs and evaluations of both phases (PyTorch).

The counterpart of ``qbold_vi_tpu/train/steps.py``: the pretraining step
and evaluation (``posterior_mse_metrics`` :47, ``_pretrain_loss`` /
``make_pretrain_step`` :63-113, ``make_pretrain_eval`` :570), the
streaming pretrain (``stream_synthetic_batch`` :389, ``_stream_step_body``
/ ``make_pretrain_stream_step`` / ``make_pretrain_stream_epoch`` /
``make_pretrain_stream_step_sharded`` :424-567), and the fine-tune part
(``sample_crop_batch`` :116, ``make_finetune_epoch_on_device`` :155,
``_device_crop_counts`` / ``make_finetune_epoch_sharded`` :194-276,
``_subject_shard_counts`` / ``make_finetune_epoch_subject_sharded``
:279-386, ``_fused_nll_fn`` / ``_fused_elbo_fn`` / ``_finetune_terms``
:598-813, ``make_finetune_step`` :827, ``make_finetune_eval`` :883).

Pretraining scores the synthetic (oef, dbv, r2p) labels under the
encoder's stream-1 posterior (losses.synthetic_data_loss). The fine-tune
loss is
    total = nll + kl * kl_weight + smoothness * smoothness_weight
(reference train.py:313-320), through one of three paths:

* the fused ELBO (kernel F, ops/fused_elbo.py) when ``fused_elbo``
  resolves on -- every step of the OPTIMAL configuration on the card;
* else the fused decode+NLL (kernel G, ops/decode_nll.py) for the NLL
  when ``fused_decode_nll`` resolves on, with the KL in torch;
* else the plain path: ``FineTuner.apply`` + ``losses.fine_tune_nll`` +
  ``losses.kl_loss``.

Mode strings keep the JAX force semantics: "auto" is on for a CUDA device
and off for the CPU; "on" forces the kernel (its plain version on the
CPU) and raises for an uncovered configuration; "host" forces host
noise; the Mosaic-interpreter modes "interpret" / "host-interpret" mean
"on" / "host" here. (``fused_conv``, kernel H, is the encoder's:
models/encoder.py.)

Randomness: a step takes an integer ``seed`` (drawn from the caller's
host ``torch.Generator``), from which it derives the seeds of its
normals (and of the kernel's device-noise stream); or ``noise``, the
normals themselves -- fine-tuning {"z_nll": (S, B, X, Y, Z, 2), "z_kl":
(S_kl, B, X, Y, Z, 2), or (2, B, X, Y, Z) for the MoG KL}, pretraining
{"z_r2p": (10, N, 2)} -- with which every path computes the same loss as
the JAX package given the same normals. At ``dropout_rate`` > 0 a
fine-tune step draws its dropout masks on the device from the seed's
fourth split, or takes them as ``dropout_masks`` (the JAX run's in the
tests). A streaming step draws its batch
from the seed too (kernel S on the card, ops/synth_batch.py), or takes
the batch's ``draws`` (the layout of ``stream_synthetic_batch``), the
JAX key's in the tests.

Under a mesh (parallel/mesh.py; one process a device) the parameters are
replicated and every rank runs the same steps on its own rows: a rank
draws its crops or its synthetic volumes from ``fold_seed(seed, rank)``
(the JAX ``fold_in(key, d)``), of which the first ``_device_crop_counts``
(or ``_subject_shard_counts``) slots are live and the rest carry a zero
mask; each term is rescaled to its share of the global masked mean (the
rank's mask count over the all-reduced count, the JAX ``_globalise``),
and ONE all-reduce sums every gradient and the step's metrics, after
which every rank applies the same update, so the parameters stay equal
bit for bit. The streaming pretrain takes the live-weighted mean over
the all-reduced live-voxel count. With one rank the reduction is the
identity and the scale 1: a sharded step is the unsharded one bit for
bit.

The steps run forward and backward with TF32 off for cuDNN and matmuls
(``models.encoder._full_fp32``): the gradients are float32, as the JAX
package's are.
"""

from __future__ import annotations

import hashlib
import math
from typing import Optional

import torch

from ..config import QBoldConfig, normalize_mode
from ..models.encoder import _full_fp32
from ..models.vi import FineTuner
from ..ops.decode_nll import decode_consts, decode_nll_rows, fused_available
from ..ops.fused_elbo import fused_elbo, fused_elbo_available
from ..ops.synth_batch import synth_batch
from ..parallel import mesh as pmesh
from ..synth import sample_batch_params, synthetic_signals
from . import losses
from .optim import swa_update

__all__ = ["posterior_mse_metrics", "pretrain_loss", "make_pretrain_step",
           "make_pretrain_eval", "stream_synthetic_batch",
           "make_pretrain_stream_step", "make_pretrain_stream_epoch",
           "sample_crop_batch", "take_crops", "finetune_terms",
           "population_finetune_terms",
           "make_finetune_step", "make_finetune_epoch_on_device",
           "make_finetune_eval", "resolve_fused_elbo", "resolve_fused_nll",
           "normals", "fold_seed", "make_pretrain_stream_step_sharded",
           "make_finetune_epoch_sharded",
           "make_finetune_epoch_subject_sharded"]

_SEED_HI = 2 ** 62


def _resolve(mode: str, device: torch.device) -> bool:
    return mode != "off" and (mode != "auto"
                              or torch.device(device).type == "cuda")


def resolve_fused_nll(tuner: FineTuner, cfg: QBoldConfig, device):
    """The decode+NLL kernel's constants when ``fused_decode_nll`` resolves
    on, else None."""
    mode = normalize_mode(cfg.train.fused_decode_nll,
                          ("auto", "on", "off", "interpret"),
                          "fused_decode_nll")
    if not _resolve(mode, device):
        return None
    if not fused_available(cfg.model, tuner.scan, tuner.full_model,
                           tuner.use_blood):
        if mode != "auto":
            raise ValueError(
                "fused_decode_nll was forced on but the configuration is not "
                "covered by the kernel (needs the full SDR model, "
                "heteroscedastic noise, and an interior spin-echo window for "
                "multi-image normalisation)")
        return None
    return decode_consts(cfg.model, tuner.scan, tuner.use_blood)


def resolve_fused_elbo(tuner: FineTuner, cfg: QBoldConfig, device):
    """(constants, host_noise) of the fused ELBO kernel when ``fused_elbo``
    resolves on, else None."""
    mode = normalize_mode(cfg.train.fused_elbo,
                          ("auto", "on", "off", "host", "interpret",
                           "host-interpret"), "fused_elbo")
    if not _resolve(mode, device):
        return None
    if not fused_elbo_available(cfg.model, tuner.scan, tuner.full_model,
                                tuner.use_blood):
        if mode != "auto":
            raise ValueError(
                "fused_elbo was forced on but the configuration is not "
                "covered by the kernel (needs the full SDR model, "
                "heteroscedastic noise, an interior spin-echo window for "
                "multi-image normalisation, and either an MVG posterior or a "
                "diagonal one without a population prior)")
        return None
    return (decode_consts(cfg.model, tuner.scan, tuner.use_blood),
            mode in ("host", "host-interpret"))


def normals(seed: int, shape, device) -> torch.Tensor:
    """Standard normals of ``shape`` on ``device`` from a generator of that
    device seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn(shape, generator=gen, device=device)


def _split_seed(seed: int, n: int) -> list:
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randint(0, _SEED_HI, (n,), generator=gen).tolist()


def fold_seed(seed: int, rank: int) -> int:
    """Rank ``rank``'s seed of the stream under ``seed`` (BLAKE2b): the
    counterpart of ``jax.random.fold_in(key, d)``, so that ranks draw
    disjoint crops and noise."""
    h = hashlib.blake2b(repr((int(seed), int(rank))).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") % _SEED_HI


def _device_crop_counts(b_global: int, n_dev: int):
    """(b_local, counts): every device samples ``b_local = ceil(b/n)``
    crop SLOTS (static shape, same SPMD program) but only its first
    ``counts[d] = b//n + (d < b%n)`` are live -- counts sum to exactly
    ``b_global``, so the published global batch (38, reference
    train.py:68) is preserved on ANY mesh size via pad-and-mask instead
    of being silently rounded to a multiple of the mesh."""
    b_local = -(-b_global // n_dev)
    return b_local, (b_global // n_dev, b_global % n_dev)


def _subject_shard_counts(n_subjects: int, n_dev: int, b_global: int):
    """Static layout of the subject-sharded fine-tune epoch.

    Subjects pad to ``s_pad = chunk*n`` rows (``chunk = ceil(S/n)``) so
    the stack shards evenly. jax shards the leading axis CONTIGUOUSLY
    in chunk-sized blocks, so device d's local shard holds rows
    ``[d*chunk, (d+1)*chunk)`` of the padded stack and its LIVE subject
    count is ``subj[d] = clamp(S - d*chunk, 0, chunk)`` -- full chunks
    up front, one partial chunk, zeros after (NOT the round-robin
    ``S//n + (d < S%n)`` split, which would skip real subjects on
    full-chunk devices and sample pad rows on the partial one whenever
    S > n and S % n != 0). The global batch of ``b_global`` crops is
    apportioned to devices proportionally to their live subject counts
    by largest remainder (deterministic, ties to the lower device
    index), so counts sum EXACTLY to b_global and each crop's subject
    marginal is uniform over all S subjects up to the <1-crop-per-device
    apportionment rounding (exact whenever b_global*subj[d]/S is
    integral -- e.g. equal shards). Returns (s_pad, subj, crops,
    b_local) with b_local = max(crops) slot count (pad slots are
    dead-masked, the pad-and-mask mechanism of _device_crop_counts)."""
    chunk = -(-n_subjects // n_dev)
    s_pad = chunk * n_dev
    subj = [min(max(n_subjects - d * chunk, 0), chunk)
            for d in range(n_dev)]
    quota = [b_global * s / n_subjects for s in subj]
    crops = [int(q) for q in quota]
    short = b_global - sum(crops)
    order = sorted(range(n_dev), key=lambda d: (crops[d] - quota[d], d))
    for d in order[:short]:
        crops[d] += 1
    assert sum(crops) == b_global
    return s_pad, subj, crops, max(max(crops), 1)


def _live(b_local: int, n_live: int, device) -> torch.Tensor:
    """(b_local,) float flags: the first ``n_live`` slots live."""
    return (torch.arange(b_local) < n_live).to(torch.float32).to(device)


def _reduce_step(mesh, params: list, metrics: dict) -> dict:
    """Sum every parameter's gradient and the step's metrics over the
    ranks in ONE all-reduce; the sums replace each rank's gradients, and
    the summed metrics are returned (detached)."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    names = list(metrics)
    mesh.counts["step_reduce"] += 1
    out = pmesh.all_reduce_sum(
        mesh, grads + [metrics[k].detach() for k in names])
    for p, g in zip(params, out):
        p.grad = g
    return dict(zip(names, out[len(params):]))


def posterior_mse_metrics(tuner: FineTuner, q: torch.Tensor,
                          y_true: torch.Tensor, z: torch.Tensor) -> dict:
    """OEF, DBV and R2' mean squared errors of the MC posterior means over
    the draws of the normals z (S, ..., 2) against the truth (reference
    model.py:326-374)."""
    samples = tuner.dist.sample_many(z, q, tuner.cfg.use_mvg)
    means = torch.mean(samples, 0).reshape(-1, 2)
    dw_coeff = tuner.scan.dw_coeff * tuner.scan.hct
    r2p = torch.mean(dw_coeff * samples[..., 0] * samples[..., 1],
                     0).reshape(-1)
    y = y_true.reshape(-1, 3)
    return {"oef_mse": torch.mean(torch.square(means[:, 0] - y[:, 0])),
            "dbv_mse": torch.mean(torch.square(means[:, 1] - y[:, 1])),
            "r2p_mse": torch.mean(torch.square(r2p - y[:, 2]))}


def pretrain_loss(tuner: FineTuner, cfg: QBoldConfig, batch: dict, *,
                  seed: Optional[int] = None, noise: Optional[dict] = None,
                  live: Optional[torch.Tensor] = None,
                  mesh=None) -> torch.Tensor:
    """The mean synthetic loss of a batch {x (B, X, Y, Z, T), y (..., 3)}.

    The loss reads only the encoder's first output, which ``Encoder.stream1``
    computes without the conv trunk of stream 2: the same values and
    gradients as the JAX step (qbold_vi_tpu/train/steps.py:63-94), whose
    XLA program drops stream 2 because nothing reads it. So pretraining
    launches no kernel H. Dropout, which flax applies on stream 2's
    residual path only, cannot reach this loss: a step with
    ``dropout_rate`` > 0 computes what one without it does, as the JAX
    step does, and validation (the JAX ``train=False``) is the same pass.
    The R2' term's normals come from ``noise`` ("z_r2p") or the
    ``seed``.

    ``live`` (B,) flags the real volumes of a rank's slots: the loss is
    then the live-weighted sum over the live-voxel count, all-reduced
    under ``mesh``, so that the ranks' losses sum to the global mean (the
    JAX ``_pretrain_loss(live=, axis_name=)``)."""
    x = batch["x"]
    z = None
    if cfg.train.use_r2p_loss:
        shape = (losses.R2P_LOSS_SAMPLES, x[..., 0].numel(), 2)
        z = _noise(noise, "z_r2p", seed, shape, x.device)
    rows = losses.synthetic_data_loss(
        tuner.dist, cfg.model, cfg.scan, batch["y"], tuner.encoder.stream1(x),
        use_r2p_loss=cfg.train.use_r2p_loss,
        inv_gamma_alpha=cfg.train.inv_gamma_alpha,
        inv_gamma_beta=cfg.train.inv_gamma_beta, z=z,
        return_mean=live is None)
    if live is None:
        return rows
    b = x.shape[0]
    n_per_vol = rows.shape[0] // b
    num = torch.sum(torch.sum(rows.reshape(b, n_per_vol), 1) * live)
    den = torch.sum(live) * n_per_vol
    if mesh is not None:
        den = pmesh.all_reduce_sum(mesh, [den])[0]
    return num / den


def make_pretrain_step(tuner: FineTuner, cfg: QBoldConfig, optimizer,
                       mesh=None):
    """step(batch, *, seed=None, noise=None, live=None) -> {"loss"}
    (detached, on the device): the synthetic loss and its gradients with
    TF32 off, then one optimiser update. SWA is the caller's
    (optim.swa_update). Under ``mesh`` the batch is the rank's slots,
    ``live`` flags its real volumes (default all), and the gradients and
    the loss are summed over the ranks before the update."""

    def step(batch: dict, *, seed: Optional[int] = None,
             noise: Optional[dict] = None,
             live: Optional[torch.Tensor] = None) -> dict:
        optimizer.zero_grad()
        if mesh is not None and live is None:
            live = _live(batch["x"].shape[0], batch["x"].shape[0],
                         batch["x"].device)
        with _full_fp32():
            loss = pretrain_loss(tuner, cfg, batch, seed=seed, noise=noise,
                                 live=live, mesh=mesh)
            loss.backward()
        metrics = {"loss": loss.detach()}
        if mesh is not None:
            metrics = _reduce_step(mesh, optimizer.params, metrics)
        optimizer.step()
        return metrics

    return step


def stream_synthetic_batch(cfg: QBoldConfig, batch_size: int, draws: dict,
                           *, device=None, vol_shape=(10, 10, 5)) -> dict:
    """The plain version of kernel S: a synthetic pretraining batch
    {x (B, *vol_shape, T), y (B, *vol_shape, 3)} from the population
    mixture (synth.sample_batch_params), misaligned where configured,
    decoded through the forward model (with the quadrature rule of the
    data path's OEF bound) and noisy where the scan says so, as the JAX
    function draws it from its key (k_par, k_mis, k_noise).

    ``draws`` (numpy arrays or tensors; ``device`` defaults to where they
    lie): the mixture's "sel_o", "sel_d", "oef_u", "oef_n", "dbv_u",
    "dbv_n" (N,); where misalign_prob > 0 "mis_u", "from_idx", "z_oef",
    "z_dbv" (N, 1); where the scan simulates noise "snr_u" (N, 1) and "z"
    (N, T); uniforms on [0, 1), normals standard. ``ops.synth_batch.
    synth_philox_draws`` gives kernel S's."""
    scan, synth = cfg.scan, cfg.synth
    n = int(batch_size) * math.prod(vol_shape)
    d = {k: torch.as_tensor(v, device=device) for k, v in draws.items()}
    with torch.no_grad():
        oef, dbv = sample_batch_params(synth, d)
        if oef.shape != (n,):
            raise ValueError(f"draws hold {tuple(oef.shape)} voxels, the "
                             f"batch needs {n}")
        x, y = synthetic_signals(oef, dbv, d, scan, synth,
                                 full_model=cfg.train.full_model,
                                 use_blood=cfg.train.use_blood,
                                 quad_rule=cfg.model.quad_rule)
    shape = (int(batch_size),) + tuple(vol_shape)
    return {"x": x.reshape(shape + (scan.n_taus,)),
            "y": y.reshape(shape + (3,))}


def _stream_step(tuner: FineTuner, cfg: QBoldConfig, optimizer, b: int,
                 mesh=None, live: Optional[torch.Tensor] = None):
    """The streaming step on ``b`` pseudo-volumes (the JAX
    ``_stream_step_body``); under ``mesh`` on the rank's slots, ``live``
    flagging the real ones, the gradients and loss summed over ranks."""
    update = make_pretrain_step(tuner, cfg, optimizer, mesh)
    named = list(tuner.named_parameters())
    tw = cfg.train

    def step(seed: Optional[int] = None, *, swa=None,
             draws: Optional[dict] = None, noise: Optional[dict] = None):
        seeds = _split_seed(seed, 2) if seed is not None else (None, None)
        if draws is not None:
            batch = stream_synthetic_batch(cfg, b, draws, device=tuner.device)
        elif seed is not None:
            batch = synth_batch(cfg, b, seeds[0], device=tuner.device)
        else:
            raise ValueError("a streaming step needs a seed or its draws")
        metrics = update(batch, seed=seeds[1], noise=noise, live=live)
        if swa is not None:
            swa = swa_update(swa, named, tw.swa_start, tw.swa_period)
        return metrics, swa

    return step


def _stream_slots(cfg: QBoldConfig, mesh, device) -> tuple:
    """(b_local, live) of the rank's streaming batch."""
    b_local, (c_base, c_rem) = _device_crop_counts(cfg.train.pt_batch_size,
                                                   mesh.world_size)
    return b_local, _live(b_local, c_base + (mesh.rank < c_rem), device)


def make_pretrain_stream_step(tuner: FineTuner, cfg: QBoldConfig, optimizer):
    """step(seed=None, *, swa=None, draws=None, noise=None) -> ({"loss"},
    swa): one streaming pretraining step on a fresh batch of
    ``pt_batch_size`` pseudo-volumes -- drawn under the seed's first split
    by ``ops.synth_batch.synth_batch`` (kernel S on the card), or by the
    plain version from ``draws`` -- then the synthetic loss (normals from
    the seed's second split, or ``noise``), its gradients, the optimiser
    update and, given an SWA state, its update (the JAX key split k_batch,
    k_loss as two seeds)."""
    return _stream_step(tuner, cfg, optimizer, cfg.train.pt_batch_size)


def make_pretrain_stream_step_sharded(tuner: FineTuner, cfg: QBoldConfig,
                                      optimizer, mesh):
    """The streaming step under ``mesh``: each rank draws its
    ``ceil(pt_batch_size / n)`` pseudo-volumes (kernel S on the card)
    under ``fold_seed(seed, rank)``, of which the first
    ``_device_crop_counts`` are live; the live-weighted loss and the
    gradients are summed over ranks, and every rank applies the same
    update. step(seed=None, *, swa=None, draws=None, noise=None) as
    make_pretrain_stream_step's, ``draws`` / ``noise`` being the rank's
    (its b_local volumes')."""
    b_local, live = _stream_slots(cfg, mesh, tuner.device)
    inner = _stream_step(tuner, cfg, optimizer, b_local, mesh, live)

    def step(seed: Optional[int] = None, **kw):
        return inner(None if seed is None else fold_seed(seed, mesh.rank),
                     **kw)

    return step


def make_pretrain_stream_epoch(tuner: FineTuner, cfg: QBoldConfig,
                               optimizer, n_steps: int, mesh=None):
    """epoch(seed=None, *, swa=None, draws=None) -> (losses (n_steps,)
    numpy, swa): ``n_steps`` streaming steps, step i on the i-th split of
    the seed (or on the batch draws ``draws[i]``), the losses read back
    from the device once. Under ``mesh`` the steps are
    make_pretrain_stream_step_sharded's, on the splits of the rank's
    ``fold_seed(seed, rank)`` (``draws[i]`` the rank's), and the losses
    are the global ones."""
    if mesh is None:
        step = make_pretrain_stream_step(tuner, cfg, optimizer)
    else:
        b_local, live = _stream_slots(cfg, mesh, tuner.device)
        step = _stream_step(tuner, cfg, optimizer, b_local, mesh, live)

    def epoch(seed: Optional[int] = None, *, swa=None,
              draws: Optional[list] = None):
        if seed is not None and mesh is not None:
            seed = fold_seed(seed, mesh.rank)
        seeds = (_split_seed(seed, n_steps) if seed is not None
                 else [None] * n_steps)
        losses = []
        for i in range(n_steps):
            m, swa = step(seeds[i], swa=swa,
                          draws=None if draws is None else draws[i])
            losses.append(m["loss"])
        return torch.stack(losses).cpu().numpy(), swa

    return epoch


def _rows_normals(seed: int, shape: tuple, rows, device,
                  axis: int = 1) -> torch.Tensor:
    """normals(seed, shape), or under ``rows`` = (lo, hi, n) the rank's
    rows [lo, hi) (along ``axis``) of the normals of the global batch of n
    rows: the draws the unsharded pass over the global batch takes."""
    if rows is None:
        return normals(seed, shape, device)
    lo, hi, n = rows
    full = tuple(shape[:axis]) + (n,) + tuple(shape[axis + 1:])
    return normals(seed, full, device).narrow(axis, lo, hi - lo)


def make_pretrain_eval(tuner: FineTuner, cfg: QBoldConfig,
                       mse_samples: int = 20, mesh=None):
    """evaluate(batch, seed, *, rows=None) -> the validation metrics of a
    synthetic batch: val_loss (dropout off), the posterior-mean MSEs over
    ``mse_samples`` draws, and under infer_inv_gamma the learned
    hyperprior (reference train.py:395-413). Under ``mesh``, ``rows`` =
    (lo, hi, n) says the batch holds rows [lo, hi) of a global batch of n
    (parallel.mesh.shard_batch): the metrics are then the global batch's,
    from the draws its unsharded evaluation takes, summed over ranks (the
    JAX jitted eval of a sharded batch); a replicated batch (no ``rows``)
    is evaluated on each rank as a whole."""

    @torch.no_grad()
    def evaluate(batch: dict, seed: int, *, rows=None) -> dict:
        x = batch["x"]
        seeds = _split_seed(seed, 2)
        on = mesh if rows is not None else None      # a sharded batch
        rows = rows if on is not None else None
        b = x.shape[0]
        noise = live = None
        if on is not None:
            live = _live(b, b, x.device)
            if cfg.train.use_r2p_loss:
                vox = x[0, ..., 0].numel()
                noise = {"z_r2p": _rows_normals(
                    seeds[0], (losses.R2P_LOSS_SAMPLES, b, vox, 2), rows,
                    x.device)}
        with _full_fp32():
            loss = pretrain_loss(tuner, cfg, batch, seed=seeds[0],
                                 noise=noise, live=live, mesh=on)
            out1 = tuner.encoder.stream1(x)
        if cfg.model.infer_inv_gamma:
            out1 = out1[..., :-4]
        z = _rows_normals(seeds[1], (mse_samples,) + tuple(out1.shape[:-1])
                          + (2,), rows, x.device)
        metrics = posterior_mse_metrics(tuner, out1, batch["y"], z)
        metrics["val_loss"] = loss
        if on is not None:
            # a rank's means weigh in by its share of the voxels
            share = x.new_tensor((rows[1] - rows[0]) / rows[2])
            parts = {k: v * share for k, v in metrics.items()
                     if k != "val_loss"}
            parts["val_loss"] = loss
            metrics = dict(zip(parts, pmesh.all_reduce_sum(
                on, list(parts.values()))))
        if cfg.model.infer_inv_gamma:
            a_o, b_o, a_d, b_d = torch.exp(tuner.encoder.inv_gamma_raw)
            metrics.update(oef_alpha=a_o, oef_beta=b_o, dbv_alpha=a_d,
                           dbv_beta=b_d)
        return metrics

    return evaluate


def sample_crop_batch(generator: torch.Generator, volumes: torch.Tensor,
                      priors: torch.Tensor, b: int, crop_size: int,
                      n_subjects: Optional[int] = None) -> dict:
    """A b-crop fine-tune batch from resident volumes (S, X, Y, Z, T+1)
    (trailing mask channel) and priors (S, X, Y, Z, 4|5): subjects uniform
    with replacement, in-plane windows uniform, drawn from the host
    ``generator`` and gathered on the volumes' device in one indexing op.
    Returns {images (masked), mask, priors}."""
    s_n, x_n, y_n = volumes.shape[:3]
    cx, cy = min(crop_size, x_n), min(crop_size, y_n)
    hi = s_n if n_subjects is None else max(int(n_subjects), 1)
    idx = torch.stack([
        torch.randint(0, hi, (b,), generator=generator),
        torch.randint(0, x_n - cx + 1, (b,), generator=generator),
        torch.randint(0, y_n - cy + 1, (b,), generator=generator)])
    return take_crops(volumes, priors, idx, crop_size)


def take_crops(volumes: torch.Tensor, priors: torch.Tensor, idx,
               crop_size: int) -> dict:
    """The crops (subject, x0, y0) = idx[:, i] (a (3, b) integer array) of
    the resident volumes and priors, gathered on their device in one
    indexing op: {images (masked), mask, priors}."""
    x_n, y_n = volumes.shape[1:3]
    cx, cy = min(crop_size, x_n), min(crop_size, y_n)
    idx = torch.as_tensor(idx, dtype=torch.int64)
    if volumes.device.type == "cuda":
        idx = idx.pin_memory().to(volumes.device, non_blocking=True)
    si, xi, yi = idx
    ix = xi[:, None] + torch.arange(cx, device=idx.device)
    iy = yi[:, None] + torch.arange(cy, device=idx.device)
    sel = (si[:, None, None], ix[:, :, None], iy[:, None, :])
    windows = volumes[sel]
    mask = windows[..., -1:]
    return {"images": windows[..., :-1] * mask, "mask": mask,
            "priors": priors[sel]}


def _noise(noise, key, seed, shape, device):
    if noise is not None and key in noise:
        z = torch.as_tensor(noise[key], dtype=torch.float32)
        return z.to(device).reshape(shape)
    if seed is None:
        raise ValueError("a train step needs a seed or its normals")
    return normals(seed, shape, device)


def finetune_terms(tuner: FineTuner, cfg: QBoldConfig, batch: dict, *,
                   seed: Optional[int] = None, noise: Optional[dict] = None,
                   no_samples: Optional[int] = None, kl_samples: int = 70,
                   train: bool = True, dropout_masks=None, mesh=None):
    """(total, aux{nll, kl, smoothness, sigma}) of one fine-tune batch
    {images (B, X, Y, Z, T), mask (..., 1)[, priors (..., 4|5)][, live]}.
    With ``train`` and ``dropout_rate`` > 0 the encoder pass drops units,
    its masks drawn on the device from the seed's fourth split, or taken
    from ``dropout_masks`` (models.encoder.Dropout), as ``noise`` injects
    the normals.

    Under ``mesh`` every masked-mean term is rescaled by the rank's mask
    count over the all-reduced count, and sigma (an unmasked monitoring
    mean) divided by the world size, so that the ranks' totals and terms
    SUM to the global ones (the JAX ``_globalise``); the population
    prior's hyperprior cost counts the rank's live crops
    (``batch["live"]``).

    The pieces (``_encoded``, ``_elbo_noise``, ``_elbo_means``,
    ``_nll_inputs``, ``_kl_term``, ``_total``) are shared with
    ``population_finetune_terms``, which puts one kernel call over every
    trial's rows between the encoder passes and the terms."""
    mcfg = cfg.model
    images = batch["images"]
    device = images.device
    s = no_samples if no_samples is not None else mcfg.no_samples
    seeds = _split_seed(seed, 4) if seed is not None else (None,) * 4
    drop = tuner.dropout(train, seed=seeds[3], masks=dropout_masks)
    elbo = resolve_fused_elbo(tuner, cfg, device)
    if elbo is not None:
        consts, host = elbo
        q, sigma, args = _encoded(tuner, cfg, batch, drop)
        kw = _elbo_noise(cfg, host, noise, seeds, args[4].shape[0], s,
                         kl_samples, device)
        nll_rows, kl_rows = fused_elbo(*args, consts, **kw)
        nll, kl = _elbo_means(nll_rows, kl_rows, args[4], s)
        return _total(tuner, cfg, batch, q, sigma, nll, kl, mesh)
    consts = resolve_fused_nll(tuner, cfg, device)
    if consts is not None:
        q, sigma, rows_in = _nll_inputs(tuner, cfg, batch, drop, noise,
                                        seeds, s)
        nll = (torch.sum(decode_nll_rows(*rows_in, consts))
               / losses.safe_mask_sum(rows_in[4]))
    else:
        z_nll = _noise(noise, "z_nll", seeds[0],
                       (s,) + tuple(images.shape[:-1]) + (2,), device)
        out = tuner.apply(images, z_nll, drop)
        q, sigma = out["predictions"], out["im_sigma"]
        pred = out["predicted_images"]
        nll = losses.fine_tune_nll(
            mcfg, tuner.scan.se_idx, images.expand(pred.shape), pred,
            sigma.expand(pred.shape),
            batch["mask"].expand(pred.shape[:-1] + (1,)))
    kl = _kl_term(tuner, cfg, batch, q, noise, seeds, kl_samples)
    return _total(tuner, cfg, batch, q, sigma, nll, kl, mesh)


def _prior_of(tuner: FineTuner, cfg: QBoldConfig, batch: dict, q):
    return (tuner.prior_params(q) if cfg.model.use_population_prior
            else batch["priors"])


def _encoded(tuner: FineTuner, cfg: QBoldConfig, batch: dict, drop):
    """(q, sigma, kernel F's row inputs (q, prior, y, sigma, mask)) of one
    batch's encoder pass."""
    images, mask = batch["images"], batch["mask"]
    t = tuner.scan.n_taus
    _, q, sigma = tuner.encode(images, drop)
    k = q.shape[-1]
    return q, sigma, (q.reshape(-1, k),
                      _prior_of(tuner, cfg, batch, q).reshape(-1, k),
                      images.reshape(-1, t), sigma.reshape(-1, t),
                      mask.reshape(-1))


def _elbo_noise(cfg: QBoldConfig, host: bool, noise, seeds, n: int, s: int,
                kl_samples: int, device) -> dict:
    """Kernel F's keyword arguments for n rows: the host normals (``noise``
    or the seeds' first two splits) under host noise or given, else the
    device-noise seed (the seeds' third split)."""
    kw = dict(mvg=cfg.model.use_mvg, s_nll=s, s_kl=kl_samples)
    if host or (noise is not None and "z_nll" in noise):
        kw["z_nll"] = _noise(noise, "z_nll", seeds[0], (s, n, 2), device)
        if cfg.model.use_mvg:
            kw["z_kl"] = _noise(noise, "z_kl", seeds[1], (kl_samples, n, 2),
                                device)
    else:
        kw["seed"] = seeds[2]
    return kw


def _elbo_means(nll_rows, kl_rows, mf, s: int) -> tuple:
    denom = losses.safe_mask_sum(mf)
    return torch.sum(nll_rows) / (s * denom), torch.sum(kl_rows) / denom


def _nll_inputs(tuner: FineTuner, cfg: QBoldConfig, batch: dict, drop,
                noise, seeds, s: int) -> tuple:
    """(q, sigma, kernel G's row inputs (oef, dbv, y, sigma, mask) over the
    s draws) of one batch's encoder pass and posterior draws."""
    images, mask = batch["images"], batch["mask"]
    t = tuner.scan.n_taus
    z_nll = _noise(noise, "z_nll", seeds[0],
                   (s,) + tuple(images.shape[:-1]) + (2,), images.device)
    _, q, sigma = tuner.encode(images, drop)
    samples = tuner.dist.sample_many(z_nll, q, cfg.model.use_mvg)
    return q, sigma, (samples[..., 0].reshape(-1),
                      samples[..., 1].reshape(-1),
                      images.expand((s,) + images.shape).reshape(-1, t),
                      sigma.expand((s,) + sigma.shape).reshape(-1, t),
                      mask.expand((s,) + mask.shape).reshape(-1))


def _kl_term(tuner: FineTuner, cfg: QBoldConfig, batch: dict, q, noise,
             seeds, kl_samples: int):
    """The KL term in torch (the paths other than kernel F's)."""
    mcfg = cfg.model
    mask = batch["mask"]
    vox = tuple(batch["images"].shape[:-1])
    n_crops = (torch.sum(batch["live"]) if "live" in batch
               else batch["images"].shape[0])
    if mcfg.use_mvg:
        z_kl = _noise(noise, "z_kl", seeds[1], (kl_samples,) + vox + (2,),
                      q.device)
    elif mcfg.use_population_prior and mcfg.mog_components > 1:
        z_kl = _noise(noise, "z_kl", seeds[1], (2,) + vox, q.device)
    else:
        z_kl = None
    return losses.kl_loss(tuner.dist, mcfg, _prior_of(tuner, cfg, batch, q),
                          q, mask, z=z_kl, n_crops=n_crops)


def _total(tuner: FineTuner, cfg: QBoldConfig, batch: dict, q, sigma, nll,
           kl, mesh):
    """(total, aux) from the NLL and KL means: the smoothness term, the
    weighted total, and under ``mesh`` the rank's share of each."""
    mask = batch["mask"]
    smooth = losses.smoothness_loss(tuner.dist, q, mask)
    aux = {"nll": nll, "kl": kl, "smoothness": smooth,
           "sigma": torch.mean(sigma)}
    total = (nll + kl * cfg.train.kl_weight
             + smooth * cfg.train.smoothness_weight)
    if mesh is None:
        return total, aux
    m_local = torch.sum(mask)
    scale = m_local / pmesh.all_reduce_sum(mesh, [m_local.detach()])[0]
    aux = {k: aux[k] * scale for k in ("nll", "kl", "smoothness")}
    aux["sigma"] = torch.mean(sigma) / sigma.new_tensor(
        float(mesh.world_size))
    return total * scale, aux


def population_finetune_terms(tuners: list, cfg: QBoldConfig,
                              batches: list, *, seeds: list,
                              noises: Optional[list] = None,
                              device_seed: int, first_trial: int = 0,
                              kl_samples: int = 70) -> list:
    """[(total, aux)] of P trials' fine-tune batches of N rows each, trial
    j through ``tuners[j]`` on ``batches[j]`` with the step seed
    ``seeds[j]`` (or the normals ``noises[j]``), as finetune_terms gives
    each -- except that the kernel of the path runs ONCE for all trials:
    each trial's encoder pass gives its rows, the rows of every trial are
    concatenated (trial j's at rows j N ...), kernel F (or G) runs forward
    and, in the backward, once more over them, and each trial's terms are
    its own rows' masked means (its mask count, its weights).

    Host normals (``fused_elbo="host"``, or given) travel with their rows,
    so every trial computes exactly what finetune_terms computes for it;
    kernel G's normals are drawn in torch from each trial's seed, so they
    do too. Under device noise kernel F draws from ONE seed a step,
    ``device_seed``, with the Philox counters of rows (first_trial + j)
    N ... for trial j: a trial's draws depend on
    the step's seed and on its index in its group, not on which trials
    share the launch. Its draws are valid ones, but not those that
    finetune_terms takes for it under its own seed. Whether the step's
    seeds differ or are one and the same, the trials draw distinct noise
    (their rows' counters differ). Paths without a kernel run
    finetune_terms per trial."""
    p_n = len(tuners)
    noises = noises if noises is not None else [None] * p_n
    tuner = tuners[0]
    device = batches[0]["images"].device
    s = cfg.model.no_samples
    splits = [_split_seed(sd, 4) if sd is not None else (None,) * 4
              for sd in seeds]
    drops = [tj.dropout(True, seed=sp[3]) for tj, sp in zip(tuners, splits)]
    elbo = resolve_fused_elbo(tuner, cfg, device)
    consts = None if elbo is not None else resolve_fused_nll(tuner, cfg,
                                                             device)
    if elbo is None and consts is None:
        return [finetune_terms(tj, cfg, b, seed=sd, noise=nz,
                               kl_samples=kl_samples)
                for tj, b, sd, nz in zip(tuners, batches, seeds, noises)]
    if elbo is not None:
        consts, host = elbo
        parts = [_encoded(tj, cfg, b, d)
                 for tj, b, d in zip(tuners, batches, drops)]
        sizes = [p[2][4].shape[0] for p in parts]
        args = [torch.cat([p[2][i] for p in parts]) for i in range(5)]
        kws = [_elbo_noise(cfg, host, nz, sp, n, s, kl_samples, device)
               for nz, sp, n in zip(noises, splits, sizes)]
        kw = dict(kws[0])
        for z in ("z_nll", "z_kl"):
            if z in kw:
                kw[z] = torch.cat([k[z] for k in kws], 1)
        if "seed" in kw:
            kw.update(seed=device_seed, offset=first_trial * sizes[0])
        nll_rows, kl_rows = fused_elbo(*args, consts, **kw)
        out = []
        for j, (n_r, k_r) in enumerate(zip(torch.split(nll_rows, sizes),
                                           torch.split(kl_rows, sizes))):
            q, sigma, a = parts[j]
            nll, kl = _elbo_means(n_r, k_r, a[4], s)
            out.append(_total(tuners[j], cfg, batches[j], q, sigma, nll, kl,
                              None))
        return out
    parts = [_nll_inputs(tj, cfg, b, d, nz, sp, s)
             for tj, b, d, nz, sp in zip(tuners, batches, drops, noises,
                                         splits)]
    sizes = [p[2][4].shape[0] for p in parts]
    rows = decode_nll_rows(*[torch.cat([p[2][i] for p in parts])
                             for i in range(5)], consts)
    out = []
    for j, r in enumerate(torch.split(rows, sizes)):
        q, sigma, a = parts[j]
        nll = torch.sum(r) / losses.safe_mask_sum(a[4])
        kl = _kl_term(tuners[j], cfg, batches[j], q, noises[j], splits[j],
                      kl_samples)
        out.append(_total(tuners[j], cfg, batches[j], q, sigma, nll, kl,
                          None))
    return out


def make_finetune_step(tuner: FineTuner, cfg: QBoldConfig, optimizer,
                       mesh=None):
    """step(batch, *, seed=None, noise=None, dropout_masks=None) -> metrics
    {loss, nll, kl, smoothness, sigma} (detached, on the device): loss and
    gradients with TF32 off, then one optimiser update.

    Under ``mesh`` the batch holds the rank's crop slots with their
    ``live`` flags (dead slots' masks are zeroed here), and ``noise`` /
    ``dropout_masks`` are the rank's; the terms are globalised
    (finetune_terms), the gradients and the metrics summed over the ranks
    in one all-reduce, and every rank applies the same update."""

    def step(batch: dict, *, seed: Optional[int] = None,
             noise: Optional[dict] = None, dropout_masks=None) -> dict:
        optimizer.zero_grad()
        if mesh is not None and "live" in batch:
            mask = batch["mask"]
            live = batch["live"].reshape((-1,) + (1,) * (mask.dim() - 1))
            batch = dict(batch, mask=mask * live)
        with _full_fp32():
            loss, aux = finetune_terms(tuner, cfg, batch, seed=seed,
                                       noise=noise,
                                       dropout_masks=dropout_masks,
                                       mesh=mesh)
            loss.backward()
        aux["loss"] = loss
        aux = {k: v.detach() for k, v in aux.items()}
        if mesh is not None:
            aux = _reduce_step(mesh, optimizer.params, aux)
        optimizer.step()
        return aux

    return step


def make_finetune_epoch_on_device(tuner: FineTuner, cfg: QBoldConfig,
                                  optimizer, n_steps: int):
    """epoch(generator, volumes, priors) -> metrics, each a (n_steps,)
    tensor on the device: n_steps steps, each on a fresh crop batch drawn
    from the resident volumes (a Python loop over steps; the metrics stay
    on the device until the caller reads them)."""
    step = make_finetune_step(tuner, cfg, optimizer)
    b, crop = cfg.train.ft_batch_size, cfg.train.crop_size

    def epoch(generator: torch.Generator, volumes: torch.Tensor,
              priors: torch.Tensor) -> dict:
        hist = []
        for _ in range(n_steps):
            batch = sample_crop_batch(generator, volumes, priors, b, crop)
            seed = int(torch.randint(0, _SEED_HI, (1,), generator=generator))
            hist.append(step(batch, seed=seed))
        return {k: torch.stack([h[k] for h in hist]) for k in hist[0]}

    return epoch


def _sharded_epoch(tuner: FineTuner, cfg: QBoldConfig, optimizer,
                   n_steps: int, mesh, b_local: int, n_live: int,
                   n_subjects: Optional[int] = None):
    step = make_finetune_step(tuner, cfg, optimizer, mesh)
    live = _live(b_local, n_live, tuner.device)
    crop = cfg.train.crop_size

    def epoch(seed: int, volumes: torch.Tensor,
              priors: torch.Tensor) -> dict:
        gen = torch.Generator().manual_seed(fold_seed(seed, mesh.rank))
        hist = []
        for _ in range(n_steps):
            batch = sample_crop_batch(gen, volumes, priors, b_local, crop,
                                      n_subjects=n_subjects)
            batch["live"] = live
            s = int(torch.randint(0, _SEED_HI, (1,), generator=gen))
            hist.append(step(batch, seed=s))
        return {k: torch.stack([h[k] for h in hist]) for k in hist[0]}

    return epoch


def make_finetune_epoch_sharded(tuner: FineTuner, cfg: QBoldConfig,
                                optimizer, n_steps: int, mesh):
    """epoch(seed, volumes, priors) -> the global metrics, each a (n_steps,)
    tensor: ``n_steps`` sharded steps (make_finetune_step under ``mesh``)
    on replicated volumes and priors. Each rank draws its
    ``ceil(ft_batch_size / n)`` crop slots and its step seeds from a
    generator seeded with ``fold_seed(seed, rank)``; its first
    ``_device_crop_counts`` slots are live, so every step trains on exactly
    ``ft_batch_size`` crops whatever the world size (the JAX
    make_finetune_epoch_sharded)."""
    b_local, (c_base, c_rem) = _device_crop_counts(cfg.train.ft_batch_size,
                                                   mesh.world_size)
    return _sharded_epoch(tuner, cfg, optimizer, n_steps, mesh, b_local,
                          c_base + (mesh.rank < c_rem))


def make_finetune_epoch_subject_sharded(tuner: FineTuner, cfg: QBoldConfig,
                                        optimizer, n_steps: int, mesh,
                                        n_subjects: int):
    """epoch(seed, volumes, priors) -> the global metrics, as
    make_finetune_epoch_sharded's, where ``volumes`` / ``priors`` are only
    the rank's rows (``parallel.mesh.shard_batch``) of the stack padded
    to ``_subject_shard_counts``' s_pad subjects: each rank samples its
    crop share from its live subjects only, so a rank holds
    ceil(S / n) subjects, not S (the JAX
    make_finetune_epoch_subject_sharded)."""
    _, subj, crops, b_local = _subject_shard_counts(
        n_subjects, mesh.world_size, cfg.train.ft_batch_size)
    return _sharded_epoch(tuner, cfg, optimizer, n_steps, mesh, b_local,
                          crops[mesh.rank], n_subjects=subj[mesh.rank])


def make_finetune_eval(tuner: FineTuner, cfg: QBoldConfig,
                       stochastic_passes: int = 10, kl_samples: int = 70,
                       mesh=None):
    """evaluate(batch, seed, *, rows=None) -> the ELBO validation metrics
    (reference train.py:325-359): the NLL averaged over
    ``stochastic_passes`` draws through the plain decode, and the KL and
    smoothness once. Under ``mesh``, ``rows`` = (lo, hi, n) says the batch
    holds crops [lo, hi) of a global batch of n: the metrics are then the
    global batch's, from the draws of its unsharded evaluation (each term
    rescaled to its share of the global masked mean and summed over
    ranks); a replicated batch (no ``rows``) is evaluated as a whole."""
    mcfg = cfg.model

    @torch.no_grad()
    def evaluate(batch: dict, seed: int, *, rows=None) -> dict:
        images, mask = batch["images"], batch["mask"]
        vox = tuple(images.shape[:-1])
        seeds = _split_seed(seed, stochastic_passes + 1)
        on = mesh if rows is not None else None      # a sharded batch
        rows = rows if on is not None else None
        with _full_fp32():
            nlls = []
            for sd in seeds[1:]:
                out = tuner.apply(images, _rows_normals(
                    sd, (mcfg.no_samples,) + vox + (2,), rows,
                    images.device))
                pred = out["predicted_images"]
                nlls.append(losses.fine_tune_nll(
                    mcfg, tuner.scan.se_idx, images.expand(pred.shape), pred,
                    out["im_sigma"].expand(pred.shape),
                    mask.expand(pred.shape[:-1] + (1,))))
            nll = torch.mean(torch.stack(nlls))
            _, q, _ = tuner.encode(images)
        prior = (tuner.prior_params(q) if mcfg.use_population_prior
                 else batch["priors"])
        if mcfg.use_mvg:
            z = _rows_normals(seeds[0], (kl_samples,) + vox + (2,), rows,
                              images.device)
        elif mcfg.use_population_prior and mcfg.mog_components > 1:
            z = _rows_normals(seeds[0], (2,) + vox, rows, images.device)
        else:
            z = None
        kl = losses.kl_loss(tuner.dist, mcfg, prior, q, mask, z=z)
        smooth = losses.smoothness_loss(tuner.dist, q, mask)
        if on is not None:
            m_local = torch.sum(mask)
            scale = m_local / pmesh.all_reduce_sum(on, [m_local])[0]
            nll, kl, smooth = pmesh.all_reduce_sum(
                on, [nll * scale, kl * scale, smooth * scale])
        tw = cfg.train
        return {"val_nll": nll, "val_kl": kl, "val_smoothness": smooth,
                "val_smoothness_scaled": smooth * tw.smoothness_weight,
                "val_elbo": nll + kl,
                "val_elbo_smooth": (nll + kl * tw.kl_weight
                                    + smooth * tw.smoothness_weight)}

    return evaluate
