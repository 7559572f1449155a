"""The losses: synthetic pretraining NLL, fine-tune reconstruction NLL,
KL dispatch, TV smoothness.

The counterpart of ``qbold_vi_tpu/train/losses.py`` (reference
model.py:449-754). Stochastic terms take their standard normals as
arguments instead of a PRNG key (see dist/logit_mvn.py).

Shapes: distribution maps (..., K), K in {4, 5}; masks (..., 1).
"""

from __future__ import annotations

import math

import torch

from ..config import ModelConfig, ScanParams
from ..dist.logit_mvn import LogitMVN

__all__ = ["safe_mask_sum", "student_t_nll", "gaussian_nll_full",
           "inv_gamma_log_prob", "synthetic_data_loss", "fine_tune_nll",
           "kl_loss", "smoothness_loss", "R2P_LOSS_SAMPLES"]

R2P_LOSS_SAMPLES = 10   # posterior draws of the R2' term (model.py:475-490)

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


def synthetic_data_loss(dist: LogitMVN, cfg: ModelConfig, scan: ScanParams,
                        y_true, y_pred, *, use_r2p_loss: bool,
                        inv_gamma_alpha: float, inv_gamma_beta: float,
                        z=None, return_mean: bool = True):
    """Pretraining loss on synthetic voxels (reference model.py:449-514).

    y_true (..., 3) physical (oef, dbv, r2p); y_pred (..., 4|5[+4]) raw
    heads (+4 exp'd hyperprior channels under cfg.infer_inv_gamma). The
    logit-Normal NLL of (oef, dbv); with ``use_r2p_loss``, a Gaussian NLL
    of r2p under the mean and std of R2' over the posterior draws of the
    normals ``z`` (R2P_LOSS_SAMPLES, N, 2); with an inverse-gamma prior
    (inferred, or alpha * beta > 0), minus its log density at the posterior
    variances. Returns the mean, or the (N,) rows (``return_mean=False``)."""
    if cfg.infer_inv_gamma:
        y_pred, ig_params = y_pred[..., :-4], y_pred[..., -4:]
    y_true = y_true.reshape(-1, 3)
    k = 5 if cfg.use_mvg else 4
    y_pred = y_pred.reshape(-1, k)
    if cfg.use_mvg:
        loss = dist.logit_gaussian_mvg_log_prob(y_true[:, :2], y_pred)
    else:
        loss = dist.logit_gaussian_log_prob(y_true[:, :2], y_pred)
    if use_r2p_loss:
        if z is None:
            raise ValueError("the R2' loss needs the normals z of its draws")
        samples = dist.sample_many(z, y_pred, cfg.use_mvg)
        r2p = scan.dw_coeff * scan.hct * samples[..., 0] * samples[..., 1]
        mean = torch.mean(r2p, 0)
        # the population std as jnp.std forms it, (x - mean)^2 averaged
        log_std = torch.log(torch.sqrt(torch.mean(torch.square(r2p - mean),
                                                  0)))
        loss = loss + dist.gaussian_nll(y_true[:, 2], mean, log_std)
    if cfg.infer_inv_gamma or inv_gamma_alpha * inv_gamma_beta > 0.0:
        _, oef_ls, _, dbv_ls, _ = dist.unpack(y_pred, cfg.use_mvg)
        if cfg.use_mvg:
            oef_var = torch.exp(oef_ls) ** 2
            # the reference adds the RAW off-diagonal head here, not its
            # squashed value (model.py:501); reproduced
            dbv_var = torch.exp(dbv_ls) ** 2 + torch.square(y_pred[:, 4])
        else:
            oef_var = torch.exp(2.0 * oef_ls)
            dbv_var = torch.exp(2.0 * dbv_ls)
        if cfg.infer_inv_gamma:
            ig = ig_params.reshape(-1, 4)[0]
            prior = (inv_gamma_log_prob(oef_var, ig[0], ig[1])
                     + inv_gamma_log_prob(dbv_var, ig[2], ig[3]))
        else:
            prior = (inv_gamma_log_prob(oef_var, inv_gamma_alpha,
                                        inv_gamma_beta)
                     + inv_gamma_log_prob(dbv_var, inv_gamma_alpha,
                                          inv_gamma_beta))
        loss = loss - prior
    return torch.mean(loss) if return_mean else loss


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
