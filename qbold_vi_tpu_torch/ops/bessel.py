"""Bessel functions J0 / J1 as element-wise torch code.

The counterpart of ``qbold_vi_tpu/ops/bessel.py``: the Abramowitz & Stegun
9.4.1/9.4.3 (J0) and 9.4.4/9.4.6 (J1) rational approximations, |error|
< ~1e-7 on the forward model's argument range |x| <~ 40, with the same
coefficients in the same Horner order. ``bessel_j0`` and
``one_minus_j0`` differentiate by the analytic identities J0' = -J1 and
(1 - J0)' = J1 (``torch.autograd.Function``s), not through the
piecewise polynomials.
"""

from __future__ import annotations

import torch

__all__ = ["bessel_j0", "bessel_j1", "one_minus_j0"]

# A&S 9.4.1: J0 on |x| <= 3, polynomial in (x/3)^2.
_J0_SMALL = (1.0000000, -2.2499997, 1.2656208, -0.3163866, 0.0444479,
             -0.0039444, 0.0002100)
# A&S 9.4.3: J0(x) = x^-1/2 * f0(x) * cos(theta0(x)) for x >= 3, in (3/x).
_J0_F = (0.79788456, -0.00000077, -0.00552740, -0.00009512, 0.00137237,
         -0.00072805, 0.00014476)
_J0_THETA = (-0.78539816, -0.04166397, -0.00003954, 0.00262573,
             -0.00054125, -0.00029333, 0.00013558)
# A&S 9.4.4: J1(x)/x on |x| <= 3, polynomial in (x/3)^2.
_J1_SMALL = (0.50000000, -0.56249985, 0.21093573, -0.03954289, 0.00443319,
             -0.00031761, 0.00001109)
# A&S 9.4.6: J1(x) = x^-1/2 * f1(x) * cos(theta1(x)) for x >= 3.
_J1_F = (0.79788456, 0.00000156, 0.01659667, 0.00017105, -0.00249511,
         0.00113653, -0.00020033)
_J1_THETA = (-2.35619449, 0.12499612, 0.00005650, -0.00637879, 0.00074348,
             0.00079824, -0.00029166)


def _poly(coeffs, t):
    """Horner evaluation of sum_i coeffs[i] * t^i."""
    acc = torch.full_like(t, coeffs[-1])
    for c in reversed(coeffs[:-1]):
        acc = acc * t + c
    return acc


def bessel_j1(x: torch.Tensor) -> torch.Tensor:
    """Bessel function of the first kind, order 1 (odd)."""
    ax = torch.abs(x)
    t_small = torch.square(torch.clamp(ax, max=3.0) / 3.0)
    small = _poly(_J1_SMALL, t_small) * ax
    big = torch.clamp(ax, min=3.0)
    z = 3.0 / big
    f = _poly(_J1_F, z)
    theta = ax + _poly(_J1_THETA, z)
    large = f * torch.cos(theta) * torch.rsqrt(big)
    return torch.sign(x) * torch.where(ax <= 3.0, small, large)


def _j0(x: torch.Tensor) -> torch.Tensor:
    ax = torch.abs(x)
    t_small = torch.square(torch.clamp(ax, max=3.0) / 3.0)
    small = _poly(_J0_SMALL, t_small)
    big = torch.clamp(ax, min=3.0)
    z = 3.0 / big
    f = _poly(_J0_F, z)
    theta = ax + _poly(_J0_THETA, z)
    large = f * torch.cos(theta) * torch.rsqrt(big)
    return torch.where(ax <= 3.0, small, large)


def _one_minus_j0(x: torch.Tensor) -> torch.Tensor:
    # exact series q - q^2/4 + q^3/36 - q^4/576 + q^5/14400 for |x| <= 1
    # (no cancellation); the subtraction is safe elsewhere
    ax = torch.abs(x)
    q = torch.square(torch.clamp(ax, max=1.0)) * 0.25
    series = q * (1.0 + q * (-0.25 + q * (1.0 / 36.0 + q * (
        -1.0 / 576.0 + q / 14400.0))))
    return torch.where(ax <= 1.0, series, 1.0 - _j0(x))


class _J0(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _j0(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return -bessel_j1(x) * g


class _OneMinusJ0(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _one_minus_j0(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return bessel_j1(x) * g


def bessel_j0(x: torch.Tensor) -> torch.Tensor:
    """Bessel function of the first kind, order 0 (d/dx = -J1)."""
    return _J0.apply(x)


def one_minus_j0(x: torch.Tensor) -> torch.Tensor:
    """1 - J0(x) without cancellation for small |x| (d/dx = J1)."""
    return _OneMinusJ0.apply(x)
