"""Fine-tune step, epoch and ELBO evaluation (PyTorch).

The counterpart of the fine-tune part of ``qbold_vi_tpu/train/steps.py``
(``sample_crop_batch`` :116, ``make_finetune_epoch_on_device`` :155,
``_fused_nll_fn`` / ``_fused_elbo_fn`` / ``_finetune_terms`` :598-813,
``make_finetune_step`` :827, ``make_finetune_eval`` :883). The loss is
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
"on" / "host" here.

Randomness: a step takes an integer ``seed`` (drawn from the caller's
host ``torch.Generator``), from which it derives the seeds of its
posterior-draw normals, its KL normals and the kernel's device-noise
stream; or ``noise``, the normals themselves ({"z_nll": (S, B, X, Y, Z,
2), "z_kl": (S_kl, B, X, Y, Z, 2), or (2, B, X, Y, Z) for the MoG KL}),
with which every path -- the fused one in host-noise mode -- computes the
same loss as the JAX package given the same normals.

The step runs forward and backward with TF32 off for cuDNN and matmuls
(``models.encoder._full_fp32``): the conv gradients are float32, as the
JAX package's are.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import QBoldConfig, normalize_mode
from ..models.encoder import _full_fp32
from ..models.vi import FineTuner
from ..ops.decode_nll import decode_consts, decode_nll_rows, fused_available
from ..ops.fused_elbo import fused_elbo, fused_elbo_available
from . import losses

__all__ = ["sample_crop_batch", "finetune_terms", "make_finetune_step",
           "make_finetune_epoch_on_device", "make_finetune_eval",
           "resolve_fused_elbo", "resolve_fused_nll", "normals"]

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
        raise ValueError("a fine-tune step needs a seed or its normals")
    return normals(seed, shape, device)


def finetune_terms(tuner: FineTuner, cfg: QBoldConfig, batch: dict, *,
                   seed: Optional[int] = None, noise: Optional[dict] = None,
                   no_samples: Optional[int] = None, kl_samples: int = 70,
                   train: bool = True):
    """(total, aux{nll, kl, smoothness, sigma}) of one fine-tune batch
    {images (B, X, Y, Z, T), mask (..., 1)[, priors (..., 4|5)][, live]}."""
    mcfg = cfg.model
    images, mask = batch["images"], batch["mask"]
    device = images.device
    n_crops = (torch.sum(batch["live"]) if "live" in batch
               else images.shape[0])
    s = no_samples if no_samples is not None else mcfg.no_samples
    t = tuner.scan.n_taus
    vox = tuple(images.shape[:-1])
    seeds = _split_seed(seed, 3) if seed is not None else (None,) * 3
    tuner.check_dropout(train)

    def prior_of(q):
        return (tuner.prior_params(q) if mcfg.use_population_prior
                else batch["priors"])

    elbo = resolve_fused_elbo(tuner, cfg, device)
    if elbo is not None:
        consts, host = elbo
        _, q, sigma = tuner.encode(images)
        k = q.shape[-1]
        mf = mask.reshape(-1)
        n = mf.shape[0]
        args = (q.reshape(-1, k), prior_of(q).reshape(-1, k),
                images.reshape(-1, t), sigma.reshape(-1, t), mf)
        kw = dict(mvg=mcfg.use_mvg, s_nll=s, s_kl=kl_samples)
        if host or (noise is not None and "z_nll" in noise):
            kw["z_nll"] = _noise(noise, "z_nll", seeds[0], (s, n, 2), device)
            if mcfg.use_mvg:
                kw["z_kl"] = _noise(noise, "z_kl", seeds[1],
                                    (kl_samples, n, 2), device)
        else:
            kw["seed"] = seeds[2]
        nll_rows, kl_rows = fused_elbo(*args, consts, **kw)
        denom = losses.safe_mask_sum(mf)
        nll = torch.sum(nll_rows) / (s * denom)
        kl = torch.sum(kl_rows) / denom
    else:
        z_nll = _noise(noise, "z_nll", seeds[0], (s,) + vox + (2,), device)
        consts = resolve_fused_nll(tuner, cfg, device)
        if consts is not None:
            _, q, sigma = tuner.encode(images)
            samples = tuner.dist.sample_many(z_nll, q, mcfg.use_mvg)
            yb = images.expand((s,) + images.shape).reshape(-1, t)
            sb = sigma.expand((s,) + sigma.shape).reshape(-1, t)
            mb = mask.expand((s,) + mask.shape).reshape(-1)
            rows = decode_nll_rows(samples[..., 0].reshape(-1),
                                   samples[..., 1].reshape(-1), yb, sb, mb,
                                   consts)
            nll = torch.sum(rows) / losses.safe_mask_sum(mb)
        else:
            out = tuner.apply(images, z_nll, train=train)
            q, sigma = out["predictions"], out["im_sigma"]
            pred = out["predicted_images"]
            nll = losses.fine_tune_nll(
                mcfg, tuner.scan.se_idx, images.expand(pred.shape), pred,
                sigma.expand(pred.shape),
                mask.expand(pred.shape[:-1] + (1,)))
        if mcfg.use_mvg:
            z_kl = _noise(noise, "z_kl", seeds[1],
                          (kl_samples,) + vox + (2,), device)
        elif mcfg.use_population_prior and mcfg.mog_components > 1:
            z_kl = _noise(noise, "z_kl", seeds[1], (2,) + vox, device)
        else:
            z_kl = None
        kl = losses.kl_loss(tuner.dist, mcfg, prior_of(q), q, mask, z=z_kl,
                            n_crops=n_crops)
    smooth = losses.smoothness_loss(tuner.dist, q, mask)
    aux = {"nll": nll, "kl": kl, "smoothness": smooth,
           "sigma": torch.mean(sigma)}
    total = (nll + kl * cfg.train.kl_weight
             + smooth * cfg.train.smoothness_weight)
    return total, aux


def make_finetune_step(tuner: FineTuner, cfg: QBoldConfig, optimizer):
    """step(batch, *, seed=None, noise=None) -> metrics {loss, nll, kl,
    smoothness, sigma} (detached, on the device): loss and gradients with
    TF32 off, then one optimiser update."""

    def step(batch: dict, *, seed: Optional[int] = None,
             noise: Optional[dict] = None) -> dict:
        optimizer.zero_grad()
        with _full_fp32():
            loss, aux = finetune_terms(tuner, cfg, batch, seed=seed,
                                       noise=noise)
            loss.backward()
        optimizer.step()
        aux["loss"] = loss
        return {k: v.detach() for k, v in aux.items()}

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


def make_finetune_eval(tuner: FineTuner, cfg: QBoldConfig,
                       stochastic_passes: int = 10, kl_samples: int = 70):
    """evaluate(batch, seed) -> the ELBO validation metrics (reference
    train.py:325-359): the NLL averaged over ``stochastic_passes`` draws
    through the plain decode, and the KL and smoothness once."""
    mcfg = cfg.model

    @torch.no_grad()
    def evaluate(batch: dict, seed: int) -> dict:
        images, mask = batch["images"], batch["mask"]
        vox = tuple(images.shape[:-1])
        seeds = _split_seed(seed, stochastic_passes + 1)
        with _full_fp32():
            nlls = []
            for sd in seeds[1:]:
                out = tuner.apply(images, normals(
                    sd, (mcfg.no_samples,) + vox + (2,), images.device))
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
            z = normals(seeds[0], (kl_samples,) + vox + (2,), images.device)
        elif mcfg.use_population_prior and mcfg.mog_components > 1:
            z = normals(seeds[0], (2,) + vox, images.device)
        else:
            z = None
        kl = losses.kl_loss(tuner.dist, mcfg, prior, q, mask, z=z)
        smooth = losses.smoothness_loss(tuner.dist, q, mask)
        tw = cfg.train
        return {"val_nll": nll, "val_kl": kl, "val_smoothness": smooth,
                "val_smoothness_scaled": smooth * tw.smoothness_weight,
                "val_elbo": nll + kl,
                "val_elbo_smooth": (nll + kl * tw.kl_weight
                                    + smooth * tw.smoothness_weight)}

    return evaluate
