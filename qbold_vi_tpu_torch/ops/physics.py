"""The ASE qBOLD forward model (decode part) as torch functions.

The counterpart of ``qbold_vi_tpu/ops/physics.py:64-460``: the SDR tissue
integral (Chebyshev surrogate, 16-node Gauss-Jacobi lattice, or the
reference's 129-point Simpson lattice), the asymptotic tissue model, the
blood compartment and ``ase_signal``. Noise and slice misalignment
(synthetic pretraining) are not ported yet.

The tables are the JAX module's: the float64 Chebyshev coefficients and
Gauss-Jacobi nodes copied digit for digit, rounded once to float32 the
same way (gated word for word in tests/test_torch_physics.py), so the
decode paths and the kernels of ``ops/decode_nll.py`` /
``ops/fused_elbo.py`` all evaluate the same words.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import ScanParams
from .bessel import bessel_j0, one_minus_j0

__all__ = ["N_QUAD", "quadrature_lattice", "delta_omega",
           "sdr_integral_cheb", "cheb_abscissa", "select_quad_rule",
           "tissue_signal_full", "tissue_signal_asymptotic", "blood_signal",
           "blood_steady_state_weight", "ase_signal", "MAX_PHYSICAL_OEF"]

N_QUAD = 129
_U_LO = 1e-5
_U_HI = 1.0


def quadrature_lattice(n_points: int = N_QUAD):
    """(u grid, Simpson-weighted prefactor g(u) w(u), sum of it) in float64:
    the reference's lattice on [1e-5, 1] (signals.py:164-171)."""
    u = np.linspace(_U_LO, _U_HI, n_points, dtype=np.float64)
    h = (u[2] - u[0]) / 2.0
    w = np.ones(n_points, dtype=np.float64)
    w[1:-1:2] = 4.0
    w[2:-2:2] = 2.0
    w *= h / 3.0
    g = (2.0 + u) * np.sqrt(1.0 - u) / (3.0 * np.square(u))
    gw = g * w
    return u, gw, float(np.sum(gw))


_U64, _GW64, _ = quadrature_lattice()
_U = _U64.astype(np.float32)
_GW = _GW64.astype(np.float32)

# 16-node Gauss-Jacobi rule, weight (1-u)^{1/2} on [0, 1]; WG folds the
# prefactor (2+u) / (3 u^2): I(c) ~= sum_i WG_i (1 - J0(c u_i)).
_GJ16_U64 = np.array([
    0.005143979307365376, 0.026905100186775777, 0.06525346129857601,
    0.11885287482812507, 0.18582445064904252, 0.26381943591394486,
    0.35010225532648365, 0.4416465851757409, 0.535241534755813,
    0.6276042793481131, 0.7154952094720111, 0.795831561890886,
    0.8657955482325908, 0.9229331891781755, 0.9652403878525269,
    0.9912332235069066,
], dtype=np.float64)
_GJ16_WG64 = np.array([
    332.02413861347264, 27.831404480423064, 7.228516842933007,
    2.8460723362510847, 1.3881432807018608, 0.7685944247606386,
    0.46080322251507605, 0.2903248434243377, 0.18808126289704707,
    0.1230191259787926, 0.0797948391919353, 0.050259822571288554,
    0.029843316315261624, 0.015881528927640064, 0.006794309437261243,
    0.0016610835166726576,
], dtype=np.float64)
_GJ16_U = _GJ16_U64.astype(np.float32)
_GJ16_WG = _GJ16_WG64.astype(np.float32)

# Degree-20 Chebyshev surrogate of I(c) in t = (c / 17)^2 on |c| <= 17
# (tools/gen_cheb_sdr.py), and of dI/dt (its exact derivative).
_CHEB_CMAX = 17.0
_CHEB_I64 = np.array([
    9.866915278212103, 7.15178129173075, -1.3874029423862115,
    0.5684482848616327, -0.2964158056737435, 0.17456105573999753,
    -0.1096504503323415, 0.07033178965494045, -0.04642863188421036,
    0.030430483836097973, -0.01784883925686604, 0.008692282817092277,
    -0.0034368251853911006, 0.0011088814765485748, -0.0002960950562157371,
    6.645318461205073e-05, -1.271695220883571e-05, 2.1015479405875626e-06,
    -3.0322440003633545e-07, 3.856231220852574e-08, -4.319402330758407e-09,
], dtype=np.float64)
_CHEB_DI64 = np.polynomial.chebyshev.chebder(_CHEB_I64)
# float32-rounded Python floats: the one table of the surrogate for every
# decode path here and for the kernels
_CHEB_I32 = tuple(float(np.float32(a)) for a in _CHEB_I64)
_CHEB_DI32 = tuple(float(np.float32(a)) for a in _CHEB_DI64)
MAX_PHYSICAL_OEF = 0.84


def _clenshaw(x, coef):
    """Chebyshev series at x by the Clenshaw recurrence, unrolled over the
    Python-float coefficients in the order of the JAX module."""
    b0, b1 = 0.0, 0.0
    for a in coef[::-1][:-1]:
        b0, b1 = 2.0 * x * b0 - b1 + a, b0
    return x * b0 - b1 + coef[0]


def cheb_abscissa(c):
    """x = min(2 (c / cmax)^2 - 1, 1), the surrogate's abscissa."""
    return torch.clamp(2.0 * (torch.square(c) * (1.0 / _CHEB_CMAX ** 2))
                       - 1.0, max=1.0)


class _SdrCheb(torch.autograd.Function):
    @staticmethod
    def forward(ctx, c):
        ctx.save_for_backward(c)
        return _clenshaw(cheb_abscissa(c), _CHEB_I32)

    @staticmethod
    def backward(ctx, g):
        (c,) = ctx.saved_tensors
        raw = 2.0 * (torch.square(c) * (1.0 / _CHEB_CMAX ** 2)) - 1.0
        x = torch.clamp(raw, max=1.0)
        d = _clenshaw(x, _CHEB_DI32) * (4.0 / _CHEB_CMAX ** 2) * c
        # the forward is flat where the abscissa clamps
        return torch.where(raw <= 1.0, d, torch.zeros_like(d)) * g


def sdr_integral_cheb(c: torch.Tensor) -> torch.Tensor:
    """I(c) by the Chebyshev surrogate, with its clamped derivative."""
    return _SdrCheb.apply(c)


def select_quad_rule(scan: ScanParams, requested: str = "auto",
                     max_oef: float = MAX_PHYSICAL_OEF,
                     hct: float | None = None) -> str:
    """"auto" -> "cheb" when |tau|_max * dw_coeff * hct * max_oef fits the
    surrogate's envelope, else "gj16"; "cheb"/"gj16" force a rule."""
    if requested in ("cheb", "gj16"):
        return requested
    if requested != "auto":
        raise ValueError(f"unknown quad_rule {requested!r}")
    c_max = float(np.max(np.abs(scan.taus()))) * scan.dw_coeff \
        * (scan.hct if hct is None else hct) * max_oef
    return "cheb" if c_max <= _CHEB_CMAX else "gj16"


def _align_tau(x, n_taus: int, per_tau: bool = False):
    """Per-voxel (...,) -> (..., 1) against the tau axis; per-tau maps
    (``per_tau``) must already end in n_taus."""
    if not torch.is_tensor(x) or x.ndim == 0:
        return x
    if per_tau:
        if x.shape[-1] != n_taus:
            raise ValueError(f"per-tau parameters must have trailing dim "
                             f"{n_taus}, got shape {tuple(x.shape)}")
        return x
    return x[..., None]


def delta_omega(oef, hct, scan: ScanParams):
    return scan.dw_coeff * hct * oef


def tissue_signal_full(dw, dbv, taus: torch.Tensor, te: float, r2t: float,
                       reference_fp32_compat: bool = False,
                       per_tau: bool = False, quad_rule: str = "gj16"):
    """Full static-dephasing tissue signal (..., n_taus)."""
    c = taus * _align_tau(dw, taus.shape[0], per_tau)
    if reference_fp32_compat:
        u = torch.as_tensor(_U, device=c.device)
        gw = torch.as_tensor(_GW, device=c.device)
        integral = torch.sum(gw * (1.0 - bessel_j0(1.5 * c[..., None] * u)),
                             -1)
    elif quad_rule == "cheb":
        integral = sdr_integral_cheb(c)
    elif quad_rule == "gj16":
        u = torch.as_tensor(_GJ16_U, device=c.device)
        wg = torch.as_tensor(_GJ16_WG, device=c.device)
        integral = torch.sum(wg * one_minus_j0(1.5 * c[..., None] * u), -1)
    else:
        raise ValueError(f"unknown quad_rule {quad_rule!r}")
    dbv_b = _align_tau(dbv, taus.shape[0], per_tau)
    return torch.exp(-dbv_b * integral) * math.exp(-te * r2t)


def tissue_signal_asymptotic(dw, dbv, taus: torch.Tensor, te: float,
                             r2t: float, per_tau: bool = False):
    """Two-regime asymptotic tissue model, blended by |tau| < 1/dw."""
    n_taus = taus.shape[0]
    dbv_b = _align_tau(dbv, n_taus, per_tau)
    tc = _align_tau(1.0 / dw, n_taus, per_tau)
    rt = _align_tau(dw, n_taus, per_tau) * dbv_b * taus
    s_short = torch.exp(-(0.3 * torch.square(rt)) / dbv_b)
    s_long = torch.exp(dbv_b - rt)
    return math.exp(-te * r2t) * torch.where(torch.abs(taus) < tc, s_short,
                                             s_long)


def blood_steady_state_weight(dbv, scan: ScanParams):
    m_bld = 1.0 - (2.0 - math.exp(-(scan.tr - scan.ti) / scan.t1b)) \
        * math.exp(-scan.ti / scan.t1b)
    return m_bld * scan.nb * dbv


def blood_signal(oef, hct, taus: torch.Tensor, scan: ScanParams,
                 per_tau: bool = False):
    """Venous blood signal, Berman et al. 2018 constants (signals.py:233-247;
    the reference's (te +/- tau)/td is not squared, as there)."""
    r2b = 1.0 / 0.189
    td = (2.6 ** 2.0) / 2.0 * 1e-3
    te = scan.te
    g0 = (4.0 / 45.0) * hct * (1.0 - hct) * torch.square(
        4.0 * math.pi * scan.b0 * scan.dchi * oef)
    phase = ((te / td)
             + torch.sqrt(torch.tensor(0.25 + te / td, dtype=taus.dtype))
             + 1.5 - 2.0 * torch.sqrt(0.25 + (te + taus) / td)
             - 2.0 * torch.sqrt(0.25 + (te - taus) / td))
    g0_b = _align_tau(g0, taus.shape[0], per_tau)
    return math.exp(-r2b * te) * torch.exp(
        -(0.5 * scan.gamma ** 2) * g0_b * (td ** 2) * phase)


def ase_signal(oef, dbv, scan: ScanParams, hct=None, *,
               full_model: bool = True, include_blood: bool = True,
               reference_fp32_compat: bool = False,
               per_tau_params: bool = False, quad_rule: str = "auto",
               max_oef: float | None = None):
    """Noise-free ASE signal (..., n_taus) float32 for (OEF, DBV) voxels.
    ``max_oef`` bounds the OEF the call can see, for the "auto" rule."""
    if quad_rule not in ("auto", "cheb", "gj16"):
        raise ValueError(f"unknown quad_rule {quad_rule!r}")
    if quad_rule == "auto":
        if hct is None or isinstance(hct, (int, float, np.floating)):
            quad_rule = select_quad_rule(
                scan, "auto",
                max_oef=MAX_PHYSICAL_OEF if max_oef is None else max_oef,
                hct=float(scan.hct if hct is None else hct))
        else:
            quad_rule = "gj16"
    if hct is None:
        hct = scan.hct
    oef = torch.as_tensor(oef, dtype=torch.float32)
    dbv = torch.as_tensor(dbv, dtype=torch.float32, device=oef.device)
    taus = torch.as_tensor(scan.taus(), device=oef.device)
    dw = delta_omega(oef, hct, scan)
    if full_model:
        tissue = tissue_signal_full(
            dw, dbv, taus, scan.te, scan.r2t,
            reference_fp32_compat=reference_fp32_compat,
            per_tau=per_tau_params, quad_rule=quad_rule)
    else:
        tissue = tissue_signal_asymptotic(dw, dbv, taus, scan.te, scan.r2t,
                                          per_tau=per_tau_params)
    dbv_b = _align_tau(dbv, scan.n_taus, per_tau_params)
    if include_blood:
        weight = blood_steady_state_weight(dbv_b, scan)
        blood = blood_signal(oef, hct, taus, scan, per_tau=per_tau_params)
        return (1.0 - weight) * tissue + weight * blood
    return (1.0 - dbv_b) * tissue
