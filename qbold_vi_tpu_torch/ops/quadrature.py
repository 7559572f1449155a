"""Deterministic posterior summaries by Gaussian quadrature (PyTorch).

The counterpart of ``qbold_vi_tpu/ops/quadrature.py``: posterior means
and biased variances of (OEF, DBV, R2') per voxel from the raw
(N, 4|5) head, by a 16-node Gauss-Hermite rule where the logit std
s < 1.5 and an exact step + 16-node Gauss-Laguerre split elsewhere, with
the R2' cross moments from a third-order Taylor expansion in the
Cholesky off-diagonal. See the JAX module's docstring for the
derivation and its error bounds; the arithmetic here is the same, line
for line, including the Abramowitz-Stegun 7.1.26 normal CDF (which is
part of the model: ``torch.special.ndtr`` would give other numbers).

Two implementations share the node constants:

* ``posterior_summaries_quadrature`` / ``quad_tile_summaries``: the
  plain torch version (any device, any leading shape);
* ``quad_posterior_summaries``: the wrapper of the hand-written CUDA
  kernel ``csrc/quadrature.cu`` (device math in ``csrc/quad_math.cuh``).
  For a CUDA tensor it launches the kernel or raises; for a CPU tensor
  it runs the plain version.

The node constants are built in float64 by numpy and rounded once to
float32 (``QUAD_CONSTS``); the kernel receives exactly those float32
words, so it and the plain version integrate with the same nodes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import _cuda

__all__ = ["posterior_summaries_quadrature", "quad_tile_summaries",
           "quad_posterior_summaries", "QUAD_CONSTS", "QH", "QL",
           "SPLIT_THRESHOLD", "QUAD_BLOCK"]

QH = 16              # Gauss-Hermite nodes (probabilists')
QL = 16              # Gauss-Laguerre nodes for the split correction
SPLIT_THRESHOLD = 1.5   # s >= this -> step+Laguerre branch
QUAD_BLOCK = 256     # kernel A's block: the voxels it sorts by side

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
_OFFDIAG_SCALE = math.exp(-2.0)


def _node_constants():
    xh, wh = np.polynomial.hermite_e.hermegauss(QH)
    wh = wh / np.sqrt(2.0 * np.pi)
    tl, wl = np.polynomial.laguerre.laggauss(QL)
    sig = lambda x: 1.0 / (1.0 + np.exp(-x))          # noqa: E731
    # corr_k = sum_j [P_jk N(z* + t_j/s) + M_jk N(z* - t_j/s)], k = 1..5
    we = wl * np.exp(tl)
    pk = [we * (sig(tl) ** k - 1.0) for k in range(1, 6)]
    mk = [we * sig(-tl) ** k for k in range(1, 6)]
    return (xh.astype(np.float32), wh.astype(np.float32),
            tl.astype(np.float32),
            [p.astype(np.float32) for p in pk],
            [m.astype(np.float32) for m in mk])


XH, WH, TL, PK, MK = _node_constants()
# The kernel's constant table, in the order csrc/quad_math.cuh reads it:
# XH[16] WH[16] TL[16] P1..P5[16 each] M1..M5[16 each].
QUAD_CONSTS = np.concatenate([XH, WH, TL, *PK, *MK]).astype(np.float32)

_XH = [float(v) for v in XH]
_XH2 = [float(v) for v in XH * XH]           # float32 products
_WH = [float(v) for v in WH]
_TL = [float(v) for v in TL]
_P = [[float(v) for v in p] for p in PK]
_M = [[float(v) for v in m] for m in MK]


def _ndtr(x):
    """Standard normal CDF via the A&S 7.1.26 rational erf."""
    z = x * (1.0 / math.sqrt(2.0))
    az = torch.abs(z)
    t = 1.0 / (1.0 + 0.3275911 * az)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    erf_abs = 1.0 - poly * torch.exp(-az * az)
    erf = torch.where(z < 0.0, -erf_abs, erf_abs)
    return 0.5 * (1.0 + erf)


def _npdf(z):
    return _INV_SQRT_2PI * torch.exp(-0.5 * z * z)


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def _gh_powers(m, s, n_pow: int, z_pows: int = 0):
    """Gauss-Hermite sums of w_i sig(m + s x_i)^p x_i^j, p = 1..n_pow,
    j = 0..z_pows; returned as acc[j][p-1]."""
    acc = [[torch.zeros_like(m) for _ in range(n_pow)]
           for _ in range(z_pows + 1)]
    for i in range(QH):
        sg = _sigmoid(m + s * _XH[i])
        w = _WH[i] * sg
        ws = [w]
        for _ in range(n_pow - 1):
            ws.append(ws[-1] * sg)
        for p in range(n_pow):
            acc[0][p] = acc[0][p] + ws[p]
        if z_pows:
            # x^2 rounded to float32 and w x^3 as (w x^2) x: the order
            # of the JAX path and of csrc/quad_math.cuh
            x2 = _XH2[i]
            for p in range(n_pow):
                wx2 = ws[p] * x2
                acc[1][p] = acc[1][p] + ws[p] * _XH[i]
                acc[2][p] = acc[2][p] + wx2
                acc[3][p] = acc[3][p] + wx2 * _XH[i]
    return acc


def _mom1d(m, s):
    """(E[sig(m+sZ)], E[sig^2(m+sZ)]), hybrid rule."""
    gh1, gh2 = _gh_powers(m, s, 2)[0]
    inv_s = 1.0 / s
    zs = -m * inv_s
    c1 = torch.zeros_like(m)
    c2 = torch.zeros_like(m)
    for j in range(QL):
        na = _npdf(zs + _TL[j] * inv_s)
        nb = _npdf(zs - _TL[j] * inv_s)
        c1 = c1 + _P[0][j] * na + _M[0][j] * nb
        c2 = c2 + _P[1][j] * na + _M[1][j] * nb
    phi = _ndtr(m * inv_s)
    use_gh = s < SPLIT_THRESHOLD
    return (torch.where(use_gh, gh1, phi + c1 * inv_s),
            torch.where(use_gh, gh2, phi + c2 * inv_s))


def _omom1d(m, s):
    """E[sig^p(m+sZ) Z^j] for p = 1, 2 and j = 0..3, ordered (1,0),
    (2,0), (1,1), (2,1), (1,2), (2,2), (1,3), (2,3)."""
    acc = _gh_powers(m, s, 2, z_pows=3)
    gh = [acc[j][p] for j in range(4) for p in range(2)]
    inv_s = 1.0 / s
    zs = -m * inv_s
    c = [torch.zeros_like(m) for _ in range(8)]
    for j in range(QL):
        za = zs + _TL[j] * inv_s
        zb = zs - _TL[j] * inv_s
        na = _npdf(za)
        nb = _npdf(zb)
        za2, zb2 = za * za, zb * zb
        p1a, m1b = _P[0][j] * na, _M[0][j] * nb
        p2a, m2b = _P[1][j] * na, _M[1][j] * nb
        c = [c[0] + p1a + m1b, c[1] + p2a + m2b,
             c[2] + p1a * za + m1b * zb, c[3] + p2a * za + m2b * zb,
             c[4] + p1a * za2 + m1b * zb2, c[5] + p2a * za2 + m2b * zb2,
             c[6] + p1a * za2 * za + m1b * zb2 * zb,
             c[7] + p2a * za2 * za + m2b * zb2 * zb]
    phi = _ndtr(m * inv_s)
    nm = _npdf(zs)
    s2m = phi + zs * nm
    s3m = (2.0 + zs * zs) * nm
    step = [phi, phi, nm, nm, s2m, s2m, s3m, s3m]
    use_gh = s < SPLIT_THRESHOLD
    return tuple(torch.where(use_gh, gh[k], step[k] + c[k] * inv_s)
                 for k in range(8))


def _gmom1d(m, s):
    """E[sig^k(m+sZ)] for k = 1..5, hybrid rule."""
    gh = _gh_powers(m, s, 5)[0]
    inv_s = 1.0 / s
    zs = -m * inv_s
    c = [torch.zeros_like(m) for _ in range(5)]
    for j in range(QL):
        na = _npdf(zs + _TL[j] * inv_s)
        nb = _npdf(zs - _TL[j] * inv_s)
        c = [c[k] + _P[k][j] * na + _M[k][j] * nb for k in range(5)]
    phi = _ndtr(m * inv_s)
    use_gh = s < SPLIT_THRESHOLD
    return tuple(torch.where(use_gh, gh[k], phi + c[k] * inv_s)
                 for k in range(5))


def _summaries_from_moments(O1, O2, D1, D2, J11, J12, J21, J22, *,
                            oef_range, min_oef, dbv_range, min_dbv,
                            dw_coeff):
    """(means, vars) of (OEF, DBV, R2') from the sigmoid moments; the
    variances are the biased E[x^2] - E[x]^2 form."""
    A, B, C, D = min_oef, oef_range, min_dbv, dbv_range
    mean_o = A + B * O1
    eo2 = A * A + 2.0 * A * B * O1 + B * B * O2
    mean_d = C + D * D1
    ed2 = C * C + 2.0 * C * D * D1 + D * D * D2
    er = (A * C + A * D * D1 + C * B * O1 + B * D * J11)
    er2 = (A * A * (C * C + 2.0 * C * D * D1 + D * D * D2)
           + 2.0 * A * B * (C * C * O1 + 2.0 * C * D * J11 + D * D * J12)
           + B * B * (C * C * O2 + 2.0 * C * D * J21 + D * D * J22))
    mean_r = dw_coeff * er
    var_o = torch.clamp(eo2 - mean_o * mean_o, min=0.0)
    var_d = torch.clamp(ed2 - mean_d * mean_d, min=0.0)
    var_r = torch.clamp(dw_coeff * dw_coeff * er2 - mean_r * mean_r, min=0.0)
    return (mean_o, mean_d, mean_r), (var_o, var_d, var_r)


def _quad_moments(mu0, ls0, mu1, ls1, od):
    """All sigmoid moments the summaries need, from squashed params."""
    s0 = torch.exp(ls0)
    s1 = torch.exp(ls1)
    sm1 = torch.sqrt(od * od + s1 * s1)

    O1, O2, U1, U2, V1, V2, W1, W2 = _omom1d(mu0, s0)
    D1, D2 = _mom1d(mu1, sm1)
    g1, g2, g3, g4, g5 = _gmom1d(mu1, s1)

    G1d1 = g1 - g2
    G1d2 = g1 - 3.0 * g2 + 2.0 * g3
    G1d3 = g1 - 7.0 * g2 + 12.0 * g3 - 6.0 * g4
    G2d1 = 2.0 * (g2 - g3)
    G2d2 = 2.0 * (2.0 * g2 - 5.0 * g3 + 3.0 * g4)
    G2d3 = 2.0 * (4.0 * g2 - 19.0 * g3 + 27.0 * g4 - 12.0 * g5)

    h2 = 0.5 * od * od
    h3 = h2 * od * (1.0 / 3.0)
    t1_1 = od * U1
    t1_2 = od * U2
    t2_1 = h2 * (V1 - O1)
    t2_2 = h2 * (V2 - O2)
    t3_1 = h3 * W1
    t3_2 = h3 * W2
    J11 = O1 * D1 + t1_1 * G1d1 + t2_1 * G1d2 + t3_1 * G1d3
    J12 = O1 * D2 + t1_1 * G2d1 + t2_1 * G2d2 + t3_1 * G2d3
    J21 = O2 * D1 + t1_2 * G1d1 + t2_2 * G1d2 + t3_2 * G1d3
    J22 = O2 * D2 + t1_2 * G2d1 + t2_2 * G2d2 + t3_2 * G2d3
    return O1, O2, D1, D2, J11, J12, J21, J22


def quad_tile_summaries(q0, q1, q2, q3, q4, *, mvg: bool, oef_range: float,
                        min_oef: float, dbv_range: float, min_dbv: float,
                        dw_coeff: float):
    """Raw head rows -> (means 3-tuple, variances 3-tuple, squashed
    (ls0, ls1, od)). The plain version of the per-voxel device routine
    ``qv_quad_squash`` / ``qv_quad_block`` / ``qv_quad_combine`` in
    csrc/quad_math.cuh."""
    ls0 = torch.tanh(q1) * 3.0 - 1.0                 # dist transform_std
    ls1 = torch.tanh(q3) * 3.0 - 1.0
    od = (torch.tanh(q4) * _OFFDIAG_SCALE if mvg     # transform_offdiag
          else torch.zeros_like(q0))
    moments = _quad_moments(q0, ls0, q2, ls1, od)
    means, variances = _summaries_from_moments(
        *moments, oef_range=oef_range, min_oef=min_oef,
        dbv_range=dbv_range, min_dbv=min_dbv, dw_coeff=dw_coeff)
    return means, variances, (ls0, ls1, od)


def posterior_summaries_quadrature(params: torch.Tensor, *, mvg: bool = True,
                                   oef_range: float = 0.8,
                                   min_oef: float = 0.04,
                                   dbv_range: float = 0.2,
                                   min_dbv: float = 0.001,
                                   dw_coeff: float = 1.0):
    """Plain version: params (..., 4|5) raw head outputs ->
    (means (..., 3), vars (..., 3))."""
    q4 = params[..., 4] if mvg else torch.zeros_like(params[..., 0])
    means, variances, _ = quad_tile_summaries(
        params[..., 0], params[..., 1], params[..., 2], params[..., 3], q4,
        mvg=mvg, oef_range=oef_range, min_oef=min_oef, dbv_range=dbv_range,
        min_dbv=min_dbv, dw_coeff=dw_coeff)
    return torch.stack(means, -1), torch.stack(variances, -1)


def quad_posterior_summaries(params: torch.Tensor, *, mvg: bool = True,
                             oef_range: float = 0.8, min_oef: float = 0.04,
                             dbv_range: float = 0.2, min_dbv: float = 0.001,
                             dw_coeff: float = 1.0):
    """params (N, 4|5) -> (means (N, 3), vars (N, 3)).

    For a CUDA tensor this launches the kernel of csrc/quadrature.cu
    (one thread per voxel, the (N, K) rows read as they lie, each 1-D
    moment routine's problems sorted by side across a block of
    ``QUAD_BLOCK``) and counts the launch in
    ``quad_posterior_summaries.launches``; a kernel that cannot launch
    raises. Its exponentials and reciprocals are the hardware's, so it
    agrees with the plain version to a few ulp of each node's term. For a
    CPU tensor it runs the plain version."""
    if params.ndim != 2 or params.shape[1] not in (4, 5):
        raise ValueError(f"params must be (N, 4|5), got {tuple(params.shape)}")
    if mvg and params.shape[1] != 5:
        raise ValueError("mvg posteriors need 5 raw channels")
    kw = dict(mvg=mvg, oef_range=oef_range, min_oef=min_oef,
              dbv_range=dbv_range, min_dbv=min_dbv, dw_coeff=dw_coeff)
    if params.device.type == "cpu":
        return posterior_summaries_quadrature(params, **kw)
    if params.device.type != "cuda":
        raise ValueError(f"no quadrature kernel for device {params.device}")
    if params.dtype != torch.float32:
        raise TypeError(f"the quadrature kernel takes float32, got "
                        f"{params.dtype}")
    params = params.contiguous()
    n, k = params.shape
    means = torch.empty((n, 3), device=params.device, dtype=torch.float32)
    variances = torch.empty_like(means)
    if n == 0:
        return means, variances
    consts = _cuda.quad_consts(params.device)
    block = QUAD_BLOCK
    with torch.cuda.device(params.device):
        err = _cuda.library().qv_quad_posterior_summaries(
            params.data_ptr(), n, k, int(mvg),
            _cuda.quad_ranges(oef_range=oef_range, min_oef=min_oef,
                              dbv_range=dbv_range, min_dbv=min_dbv,
                              dw_coeff=dw_coeff),
            consts.data_ptr(), means.data_ptr(), variances.data_ptr(),
            (n + block - 1) // block, block,
            torch.cuda.current_stream(params.device).cuda_stream)
    _cuda.check(err, "quadrature")
    quad_posterior_summaries.launches += 1
    return means, variances


quad_posterior_summaries.launches = 0
