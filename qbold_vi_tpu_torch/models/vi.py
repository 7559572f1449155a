"""The VI fine-tuner: encoder -> reparameterised posterior sample ->
physics decoder -> heteroscedastic noise (PyTorch).

The counterpart of ``qbold_vi_tpu/models/vi.py::FineTuner``: the encoder,
the posterior distribution, the encoder pass, the population prior and
the fine-tune forward pass ``apply`` (reference model.py:239-286).

Where the JAX FineTuner is a stateless bundle applied to an explicit
params pytree, this one is an ``nn.Module`` that owns its parameters:

    encoder.*   the Encoder (models/encoder.py)
    pop_prior   (5,) | (4,) | (4 * mog,) learned population prior, when
                cfg.use_population_prior
    log_sigma   scalar learned noise, when not cfg.heteroscedastic_noise

``init_params`` makes a state_dict from a ``torch.Generator`` with
flax's initialisers; ``io/from_jax.py`` converts a JAX params tree into
the same state_dict.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..config import ModelConfig, ScanParams
from ..dist.logit_mvn import LogitMVN
from ..ops import physics
from .encoder import Dropout, Encoder, init_encoder_

__all__ = ["FineTuner", "init_params", "POP_PRIOR_INIT_MVG",
           "POP_PRIOR_INIT_DIAG"]

POP_PRIOR_INIT_MVG = (-0.97, 0.4, -1.14, 0.6, 0.0)
POP_PRIOR_INIT_DIAG = (-0.97, 0.4, -1.14, 0.6)


class FineTuner(nn.Module):
    """Encoder + posterior distribution + physics decoder. Parameters are
    allocated uninitialised on ``device`` -- the CUDA card unless the
    caller asks for another (``device="cpu"``) -- so load a state_dict
    (``init_params`` or the JAX bridge) before use. ``full_model`` and
    ``use_blood`` select the decoder's tissue model and blood compartment,
    as the JAX FineTuner's fields do."""

    def __init__(self, cfg: ModelConfig, scan: ScanParams, *, device=None,
                 full_model: bool = True, use_blood: bool = True):
        super().__init__()
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "FineTuner runs on the CUDA card unless asked otherwise, and "
                "no CUDA device is available: pass device='cpu'")
        self.cfg, self.scan = cfg, scan
        self.full_model, self.use_blood = full_model, use_blood
        # built on the meta device so that construction draws nothing from
        # torch's global generator; the weights come from a state_dict
        self.encoder = Encoder(cfg, n_taus=scan.n_taus, se_idx=scan.se_idx,
                               device="meta")
        if cfg.use_population_prior:
            self.pop_prior = nn.Parameter(torch.empty(
                _pop_prior_size(cfg), device="meta"))
        if not cfg.heteroscedastic_noise:
            self.log_sigma = nn.Parameter(torch.empty((), device="meta"))
        self.to_empty(device=device)

    @property
    def dist(self) -> LogitMVN:
        c = self.cfg
        return LogitMVN(c.oef_range, c.min_oef, c.dbv_range, c.min_dbv)

    @property
    def device(self) -> torch.device:
        return self.encoder.first_conv.weight.device

    def encode(self, images: torch.Tensor, dropout: Dropout = None):
        """(q_voxelwise, q_neighbourhood, im_sigma) from (..., T) images;
        a training pass with ``dropout`` (``FineTuner.dropout``)."""
        return self.encoder(images, dropout)

    def prior_params(self, q: torch.Tensor) -> torch.Tensor:
        """The learned population prior broadcast to q's leading shape."""
        pop = self.pop_prior
        return pop.expand(q.shape[:-1] + pop.shape)

    def dropout(self, train: bool, *, seed: int = None, masks=None):
        """The trunk's dropout of one pass, or None: a pass with ``train``
        and ``dropout_rate`` > 0 draws its masks from a generator on the
        tuner's device seeded with ``seed``, or takes ``masks`` (see
        models.encoder.Dropout); validation and inference (``train``
        False) are deterministic, as the JAX package keys dropout only in
        its training steps (models/vi.py:84-93, train/steps.py:71-78)."""
        rate = self.cfg.dropout_rate
        if not train or rate <= 0.0:
            return None
        if masks is not None:
            return Dropout(rate, masks=masks)
        if seed is None:
            raise ValueError("a training pass with dropout needs a seed or "
                             "its masks")
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return Dropout(rate, generator=gen)

    def decode(self, samples: torch.Tensor) -> torch.Tensor:
        """Physical (OEF, DBV) draws (..., 2) -> noise-free signals
        (..., n_taus), with the configured OEF bound for the rule gate."""
        cfg = self.cfg
        return physics.ase_signal(
            samples[..., 0], samples[..., 1], self.scan,
            full_model=self.full_model, include_blood=self.use_blood,
            quad_rule=cfg.quad_rule, max_oef=cfg.min_oef + cfg.oef_range)

    def apply(self, images: torch.Tensor, z: torch.Tensor,
              dropout: Dropout = None) -> dict:
        """One stochastic forward pass on (B, X, Y, Z, n_taus) images with
        the standard normals ``z`` (S, B, X, Y, Z, 2) of its S posterior
        draws, a training pass with ``dropout``. Returns predictions
        (B, ..., 4|5) raw posterior params, samples (S, B, ..., 2),
        predicted_images (S, B, ..., n_taus) and im_sigma (B, ..., n_taus)
        -- exp(log_sigma) everywhere when the noise is not
        heteroscedastic."""
        _, q, im_sigma = self.encode(images, dropout)
        samples = self.dist.sample_many(z, q, self.cfg.use_mvg)
        if not self.cfg.heteroscedastic_noise:
            im_sigma = torch.exp(self.log_sigma).expand(im_sigma.shape)
        return {"predictions": q, "samples": samples,
                "predicted_images": self.decode(samples),
                "im_sigma": im_sigma}


def _pop_prior_size(cfg: ModelConfig) -> int:
    if cfg.use_mvg:
        return 5
    return 4 * cfg.mog_components if cfg.mog_components > 1 else 4


def init_params(cfg: ModelConfig, scan: ScanParams,
                generator: torch.Generator) -> dict:
    """A FineTuner state_dict drawn from ``generator`` (a CPU generator)
    with flax's initialisers: he_normal for the embed/shared/head
    kernels, normal(resid_init_std) for convs, gates and the sigma head,
    log(im_loss_sigma) for the sigma bias. Same shapes and distributions
    as ``qbold_vi_tpu.models.vi.FineTuner.init``, not the same numbers."""
    tuner = FineTuner(cfg, scan, device="cpu")
    init_encoder_(tuner.encoder, generator)
    with torch.no_grad():
        if cfg.use_population_prior:
            if cfg.use_mvg:
                tuner.pop_prior.copy_(torch.tensor(POP_PRIOR_INIT_MVG))
            elif cfg.mog_components > 1:
                tuner.pop_prior.normal_(generator=generator)
            else:
                tuner.pop_prior.copy_(torch.tensor(POP_PRIOR_INIT_DIAG))
        if not cfg.heteroscedastic_noise:
            tuner.log_sigma.fill_(math.log(cfg.im_loss_sigma))
    return tuner.state_dict()
