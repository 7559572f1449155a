"""Fine-tune losses: reconstruction NLL, KL dispatch, TV smoothness.

The counterpart of ``qbold_vi_tpu/train/losses.py:41-80,166-292``
(reference model.py:527-754). Stochastic terms take their standard
normals as arguments instead of a PRNG key (see dist/logit_mvn.py).
``synthetic_data_loss`` (pretraining) is not ported yet.

Shapes: distribution maps (..., K), K in {4, 5}; masks (..., 1).
"""

from __future__ import annotations

import math

import torch

from ..config import ModelConfig
from ..dist.logit_mvn import LogitMVN

__all__ = ["safe_mask_sum", "student_t_nll", "gaussian_nll_full",
           "inv_gamma_log_prob", "fine_tune_nll", "kl_loss",
           "smoothness_loss"]

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def safe_mask_sum(mask: torch.Tensor) -> torch.Tensor:
    """Masked-mean denominator: sum(mask), or 1 for an all-dead mask (whose
    numerators are exactly 0), so no 0/0 reaches a value or a gradient."""
    den = torch.sum(mask)
    return torch.where(den > 0, den, torch.ones_like(den))


def _lgamma(a):
    return torch.lgamma(a) if torch.is_tensor(a) else math.lgamma(a)


def _log(a):
    return torch.log(a) if torch.is_tensor(a) else math.log(a)


def student_t_nll(residual, sigma, df: float):
    """-log p of a Student-t(df, 0, sigma) (reference model.py:557-559)."""
    log_norm = (_lgamma((df + 1.0) / 2.0) - _lgamma(df / 2.0)
                - 0.5 * math.log(df * math.pi) - torch.log(sigma))
    quad = -((df + 1.0) / 2.0) * torch.log1p(
        torch.square(residual / sigma) / df)
    return -(log_norm + quad)


def gaussian_nll_full(residual, sigma):
    """Normalised Gaussian NLL (reference model.py:561)."""
    return torch.log(sigma) + _HALF_LOG_2PI + 0.5 * torch.square(
        residual / sigma)


def inv_gamma_log_prob(x, alpha, beta):
    """InverseGamma(alpha, beta).log_prob(x), closed form."""
    return (alpha * _log(beta) - _lgamma(alpha) - (alpha + 1.0) * torch.log(x)
            - beta / x)


def fine_tune_nll(cfg: ModelConfig, se_idx: int, y_true, y_pred, sigma,
                  mask, *, return_mean: bool = True):
    """Masked reconstruction NLL of real vs predicted tau-series, each
    normalised by its spin-echo image (or the mean of the three around
    it) + 1e-3 (reference model.py:527-568)."""
    eps = 1e-3
    if cfg.multi_image_normalisation:
        lo = max(se_idx - 1, 0)
        t_ref = torch.mean(y_true[..., lo:se_idx + 2], -1, keepdim=True)
        p_ref = torch.mean(y_pred[..., lo:se_idx + 2], -1, keepdim=True)
    else:
        t_ref = y_true[..., se_idx:se_idx + 1]
        p_ref = y_pred[..., se_idx:se_idx + 1]
    y_true = y_true / (t_ref + eps)
    y_pred = y_pred / (p_ref + eps)
    if cfg.predict_log_data:
        live = mask > 0
        y_true = torch.where(live, torch.log(y_true), 0.0)
        y_pred = torch.where(live, torch.log(y_pred), 0.0)
    residual = y_true - y_pred
    if cfg.student_t_df is not None and cfg.student_t_df < 50:
        nll = student_t_nll(residual, sigma, cfg.student_t_df)
    else:
        nll = gaussian_nll_full(residual, sigma)
    nll = torch.sum(nll, -1, keepdim=True) * mask
    if return_mean:
        return torch.sum(nll) / safe_mask_sum(mask)
    return nll


def kl_loss(dist: LogitMVN, cfg: ModelConfig, prior, pred, mask, *,
            z=None, return_mean: bool = True, n_crops=None):
    """KL(q || p), selected as the reference does (model.py:654-724):

    * MVG: the sampled KL over the draws ``z`` (S, ..., 2) of q, with q
      stop-gradiented inside log q (model.py:592-610);
    * MoG (population prior, mog_components > 1): one-sample entropy +
      mixture NLL; ``z`` (2, ...) holds the OEF and DBV normals;
    * diagonal: the analytic logit-Normal KL, plus, with a population
      prior, an InverseGamma(1, 2) hyperprior cost on the prior stds
      scaled by the crop count (model.py:712-716; ``n_crops`` defaults
      to ``pred.shape[0]``).
    """
    prior_cost = 0.0
    if cfg.use_mvg:
        kl_op = dist.mvg_kl_samples(z, pred, prior)[..., None]
    elif cfg.use_population_prior and cfg.mog_components > 1:
        q = pred
        entropy = dist.transform_std(q[..., 1]) + dist.transform_std(q[..., 3])
        oef_s = q[..., 0] + z[0] * torch.exp(dist.transform_std(q[..., 1]))
        dbv_s = q[..., 2] + z[1] * torch.exp(dist.transform_std(q[..., 3]))

        def comp_nll(sample, mean, raw_log_std):
            ls = dist.transform_std(raw_log_std)
            return ls + 0.5 * torch.square((sample - mean) / torch.exp(ls))

        kl_op = -entropy
        m = cfg.mog_components
        for i in range(m):
            p = prior[..., 4 * i:4 * (i + 1)]
            kl_op = kl_op + comp_nll(oef_s, p[..., 0], p[..., 1]) / m
            kl_op = kl_op + comp_nll(dbv_s, p[..., 2], p[..., 3]) / m
        kl_op = kl_op[..., None]
    else:
        kl_op = dist.diag_kl(pred, prior)[..., None]
        if cfg.use_population_prior:
            _, p_oef_ls, _, p_dbv_ls, _ = dist.unpack(prior, mvg=False)

            def ig(v):
                return inv_gamma_log_prob(v, 1.0, 2.0)

            prior_cost = -ig(torch.exp(2.0 * torch.mean(p_dbv_ls)))
            prior_cost = prior_cost - ig(torch.exp(2.0 * torch.mean(p_oef_ls)))
            prior_cost = prior_cost * (pred.shape[0] if n_crops is None
                                       else n_crops)
    kl_op = torch.where(mask > 0, kl_op, 0.0)
    if return_mean:
        return (torch.sum(kl_op) + prior_cost) / safe_mask_sum(mask)
    return kl_op


def smoothness_loss(dist: LogitMVN, pred, mask):
    """Masked anisotropic TV (L1) of the forward-transformed posterior
    means, in-plane x/y only (reference model.py:726-754).
    pred: (B, X, Y, Z, 4|5); mask: (B, X, Y, Z, 1)."""
    means = torch.stack([pred[..., 0], pred[..., 2]], -1)
    phys = dist.forward_transform(means)
    phys = phys / torch.tensor([dist.oef_range, dist.dbv_range],
                               dtype=phys.dtype, device=phys.device)
    live = mask > 0
    dx = torch.where(live[:, :-1] & live[:, 1:], phys[:, :-1] - phys[:, 1:],
                     0.0)
    dy = torch.where(live[:, :, :-1] & live[:, :, 1:],
                     phys[:, :, :-1] - phys[:, :, 1:], 0.0)
    total = torch.sum(torch.abs(dx)) + torch.sum(torch.abs(dy))
    return total / safe_mask_sum(mask)
