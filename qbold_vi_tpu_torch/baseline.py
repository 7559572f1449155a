"""Classical log-linear WLS baseline (PyTorch).

The port's copy of ``qbold_vi_tpu/baseline.py`` (reference
loglinear.py:68-105): per voxel, the weighted least-squares line through
ln S over the long-tau taus (tau > 0.016 s) with weights 1 / tau, in
closed form from two weighted moments,

    slope     = cov_w(tau, ln S) / var_w(tau)
    intercept = mean_w(ln S) - slope * mean_w(tau),

then R2' = -slope, DBV = intercept - ln S(tau = 0) and OEF = R2' / (DBV
dw_coeff hct), sanitised (nan_to_num) and clipped to the reference's
ranges. Plain torch: the JAX package computes it in XLA, outside any
Pallas kernel, and every voxel is independent.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ScanParams

__all__ = ["fit_wls", "wls_maps", "fit_rounding"]


def fit_wls(signals: torch.Tensor, scan: ScanParams):
    """Log-linear WLS estimate of (OEF, DBV, R2') per voxel: signals
    (..., n_taus) ASE magnitudes on the scan's tau grid -> (oef, dbv, r2p),
    each (..., 1), clipped to [0.01, 0.8], [0.002, 0.25], [0.01, 100].

    As the reference: ln S with non-finite values zeroed; the fit over
    tau > 0.016 with weights 1 / tau; a degenerate fit (DBV = 0, 0 / 0)
    is sanitised before clipping, so the maps are always finite."""
    x = torch.as_tensor(signals, dtype=torch.float32)
    taus = torch.as_tensor(scan.taus(), device=x.device)
    ln_s = torch.log(x)
    ln_s = torch.where(torch.isfinite(ln_s), ln_s, torch.zeros_like(ln_s))

    long = taus > 0.016
    w = torch.where(long, 1.0 / torch.where(long, taus, torch.ones_like(
        taus)), torch.zeros_like(taus))
    sw = torch.sum(w)
    mean_t = torch.sum(w * taus) / sw
    var_t = torch.sum(w * torch.square(taus - mean_t)) / sw
    mean_y = torch.sum(w * ln_s, -1, keepdim=True) / sw
    cov_ty = torch.sum(w * (taus - mean_t) * ln_s, -1, keepdim=True) / sw

    slope = cov_ty / var_t
    intercept = mean_y - slope * mean_t
    se = int(np.argmin(np.abs(np.asarray(scan.taus()))))
    r2p = -slope
    dbv = intercept - ln_s[..., se:se + 1]
    oef = r2p / (dbv * scan.dw_coeff * scan.hct)
    return (torch.clamp(torch.nan_to_num(oef), 0.01, 0.8),
            torch.clamp(torch.nan_to_num(dbv), 0.002, 0.25),
            torch.clamp(torch.nan_to_num(r2p), 1e-2, 100.0))


def wls_maps(signals: np.ndarray, scan: ScanParams, *,
             device=None) -> np.ndarray:
    """The stacked (..., 3) [oef, dbv, r2p] maps of ``fit_wls`` as numpy,
    the reference CLI's triplet (loglinear.py:143-157); the fit runs on
    ``device``, the CUDA card unless given another."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("wls_maps fits on the CUDA card unless asked "
                           "otherwise, and no CUDA device is available: "
                           "pass device='cpu'")
    x = torch.from_numpy(np.ascontiguousarray(signals, np.float32))
    with torch.no_grad():
        maps = fit_wls(x.to(device), scan)
    return torch.cat(maps, -1).cpu().numpy()


def fit_rounding(signals: np.ndarray, maps: np.ndarray,
                 scan: ScanParams) -> np.ndarray:
    """(..., 3) the float32 rounding that two WLS fits of ``signals`` whose
    sums over the taus run in different orders may differ by, in the
    layout of ``maps`` (a fit's (..., 3) [oef, dbv, r2p]): 8 float32 ulps
    of the voxel's largest |ln S| (non-finite logs zeroed), u, carried
    through the fit -- u for DBV (the intercept minus ln S(0)), u / sd for
    R2' (sd the weighted spread of the fitted taus), and the sum of the two
    relative terms for OEF = R2' / (DBV k). The fit cancels in float32:
    the covariance of tau with a nearly constant ln S, and DBV as a small
    difference of two numbers near ln S0. A gate of two fits allows this
    beside its relative tolerance."""
    with np.errstate(divide="ignore"):
        ln_s = np.log(np.abs(np.asarray(signals, np.float64)))
    ln_s = np.where(np.isfinite(ln_s), ln_s, 0.0)
    u = 8 * np.finfo(np.float32).eps * np.abs(ln_s).max(-1)
    taus = np.asarray(scan.taus(), np.float64)
    w = np.where(taus > 0.016, 1.0 / np.where(taus > 0.016, taus, 1.0), 0.0)
    mean_t = np.sum(w * taus) / np.sum(w)
    sd = np.sqrt(np.sum(w * (taus - mean_t) ** 2) / np.sum(w))
    oef, dbv, r2p = np.moveaxis(np.abs(np.asarray(maps, np.float64)), -1, 0)
    return np.stack([oef * (u / sd / r2p + u / dbv), u, u / sd], -1)
