"""Physics decode + reconstruction NLL rows, forward and backward
(kernel G).

The counterpart of ``qbold_vi_tpu/ops/pallas_decode.py``: per voxel, the
full SDR signal of one (oef, dbv) draw over the taus -- the Chebyshev
surrogate of the tissue integral when the scan envelope fits, else the
16-node Gauss-Jacobi J0 lattice -- the spin-echo normalised predicted and
measured series and the Student-t / Gaussian NLL summed over taus, masked;
the backward recomputes the signal and gives d/doef, d/ddbv, d/dsigma and
d/dy in closed form.

* ``decode_consts``: every per-scan constant formed in double on the host
  and rounded once to float32, as ``_consts`` bakes them into the Pallas
  trace; the plain version and the kernel read the same words.
* ``nll_row_plain`` / ``nll_row_grads_plain``: the plain torch versions
  of ``_nll_row`` / ``_nll_row_grads`` (also the per-draw routine of the
  fused ELBO's plain version, ops/fused_elbo.py).
* ``decode_nll_forward`` / ``decode_nll_backward``: the wrappers of the
  hand-written kernel ``csrc/decode_nll.cu`` (tiles of 128 rows a
  block; the table's layout and the per-residual math of the plain
  version in ``csrc/elbo_math.cuh``). A CUDA tensor launches the kernel,
  counted in ``<wrapper>.launches``, or raises; a CPU tensor runs the
  plain version. The backward gives dy only when asked (``want_dy``).
* ``decode_nll_rows``: the op with its closed-form backward, as a
  ``torch.autograd.Function``, which asks for dy only when y requires a
  gradient (the fine-tune step's measured images do not).

``sum(rows) / sum(mask)`` is ``train.losses.fine_tune_nll``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..config import ModelConfig, ScanParams
from . import _cuda, physics
from .bessel import bessel_j1, one_minus_j0

__all__ = ["fused_available", "decode_consts", "DecodeConsts",
           "nll_row_plain", "nll_row_grads_plain", "decode_nll_forward",
           "decode_nll_backward", "decode_nll_rows"]

EPS = 1e-3                 # normaliser epsilon (reference model.py:540-545)
_BLOCK = 128               # the fused ELBO kernel's block (ops/fused_elbo.py)


def fused_available(cfg: ModelConfig, scan: ScanParams, full_model: bool,
                    use_blood: bool) -> bool:
    """The kernel covers the full SDR model with heteroscedastic noise and,
    under multi-image normalisation, an interior spin-echo window."""
    del use_blood
    if cfg.multi_image_normalisation and not (
            1 <= scan.se_idx < scan.n_taus - 1):
        return False
    return bool(full_model) and cfg.heteroscedastic_noise


@dataclass(frozen=True, eq=False)
class DecodeConsts:
    """One decode configuration: flags, float32 scalars, and the float32
    table the kernel stages in shared memory, laid out as
    csrc/elbo_math.cuh::qv_table reads it:
    tk[T] tk15[T] dc[T] beta[T] gj_u[16] gj_wg[16] ci[21] cd[20] gj_d[T,16].
    """

    n_taus: int
    se: int
    multi: bool
    log_data: bool
    student: bool
    use_blood: bool
    cheb: bool
    scalars: dict          # name -> float32-rounded Python float
    table: np.ndarray      # float32

    def part(self, name: str) -> np.ndarray:
        t = self.n_taus
        start = {"tk": 0, "tk15": t, "dc": 2 * t, "beta": 3 * t,
                 "gj_u": 4 * t, "gj_wg": 4 * t + 16, "ci": 4 * t + 32,
                 "cd": 4 * t + 53, "gj_d": 4 * t + 73}[name]
        size = {"gj_u": 16, "gj_wg": 16, "ci": 21, "cd": 20,
                "gj_d": 16 * t}.get(name, t)
        out = self.table[start:start + size]
        return out.reshape(t, 16) if name == "gj_d" else out

    def struct(self) -> _cuda.QvDecodeConsts:
        flags = dict(n_taus=self.n_taus, se=self.se, multi=int(self.multi),
                     log_data=int(self.log_data), student=int(self.student),
                     use_blood=int(self.use_blood), cheb=int(self.cheb))
        return _cuda.QvDecodeConsts(**flags, **self.scalars)

    @functools.lru_cache(maxsize=None)
    def coeffs(self) -> _cuda.QvDecodeCoeffs:
        """The table's ci and cd, which kernel G takes by value."""
        return _cuda.QvDecodeCoeffs(*(
            (ctypes.c_float * n)(*self.part(name))
            for name, n in (("ci", 21), ("cd", 20))))

    @functools.lru_cache(maxsize=None)
    def device_table(self, device: torch.device) -> torch.Tensor:
        return torch.from_numpy(self.table).to(device)

    @functools.lru_cache(maxsize=None)
    def tensors(self, device: torch.device) -> dict:
        """The table's parts as float32 tensors on ``device`` (the plain
        version's operands)."""
        return {k: torch.from_numpy(np.ascontiguousarray(self.part(k)))
                .to(device) for k in ("tk", "tk15", "dc", "beta", "gj_d")}


def _f32(x: float) -> float:
    return float(np.float32(x))


@functools.lru_cache(maxsize=64)
def decode_consts(cfg: ModelConfig, scan: ScanParams,
                  use_blood: bool = True) -> DecodeConsts:
    """The constants of pallas_decode._consts (+ the ELBO kernel's ranges),
    each formed in double and rounded once to float32."""
    taus = scan.taus().astype(np.float64)
    k = scan.dw_coeff * scan.hct                      # dw = k * oef
    r2b = 1.0 / 0.189
    td = (2.6 ** 2.0) / 2.0 * 1e-3
    a_g0 = (4.0 / 45.0) * scan.hct * (1.0 - scan.hct) * (
        4.0 * math.pi * scan.b0 * scan.dchi) ** 2     # g0 = a_g0 * oef^2
    te = scan.te
    phase = (te / td + math.sqrt(0.25 + te / td) + 1.5
             - 2.0 * np.sqrt(0.25 + (te + taus) / td)
             - 2.0 * np.sqrt(0.25 + (te - taus) / td))
    beta = 0.5 * scan.gamma ** 2 * td ** 2 * a_g0 * phase
    m_bld = 1.0 - (2.0 - math.exp(-(scan.tr - scan.ti) / scan.t1b)) \
        * math.exp(-scan.ti / scan.t1b)
    rule = physics.select_quad_rule(scan, cfg.quad_rule,
                                    max_oef=cfg.min_oef + cfg.oef_range)
    inv_cmax2 = 1.0 / physics._CHEB_CMAX ** 2
    u, wg = physics._GJ16_U64, physics._GJ16_WG64
    table = np.concatenate([
        taus * k, 1.5 * taus * k, 4.0 * inv_cmax2 * (taus * k), beta, u, wg,
        physics._CHEB_I32, physics._CHEB_DI32,
        (wg * u * 1.5 * taus[:, None] * k).reshape(-1),
    ]).astype(np.float32)
    df = cfg.student_t_df
    student = df is not None and df < 50.0
    df = float(df) if df is not None else 0.0
    t_const = (-(math.lgamma((df + 1.0) / 2.0) - math.lgamma(df / 2.0)
                 - 0.5 * math.log(df * math.pi)) if student else 0.0)
    scalars = dict(
        envelope=math.exp(-scan.te * scan.r2t), bc=math.exp(-r2b * te),
        mnb=m_bld * scan.nb, inv_cmax2=inv_cmax2, df=df, df1=df + 1.0,
        half_df1=(df + 1.0) / 2.0, t_const=t_const,
        half_log_2pi=0.5 * math.log(2.0 * math.pi),
        wk=1.0 / 3.0 if cfg.multi_image_normalisation else 1.0,
        oef_range=cfg.oef_range, min_oef=cfg.min_oef,
        dbv_range=cfg.dbv_range, min_dbv=cfg.min_dbv,
        kl_bound=math.log((1.0 - 1e-6) / 1e-6))
    return DecodeConsts(
        n_taus=len(taus), se=scan.se_idx,
        multi=cfg.multi_image_normalisation, log_data=cfg.predict_log_data,
        student=student, use_blood=bool(use_blood), cheb=rule == "cheb",
        scalars={k_: _f32(v) for k_, v in scalars.items()}, table=table)


# ---- plain versions ---------------------------------------------------------

def _signal(oef, dbv, C: DecodeConsts):
    """(pred, tissue, integral, blood, w), each (N, T) but w (N, 1)."""
    tb, s = C.tensors(oef.device), C.scalars
    if C.cheb:
        integral = physics._clenshaw(physics.cheb_abscissa(
            tb["tk"] * oef[:, None]), physics._CHEB_I32)
    else:
        c = tb["tk15"] * oef[:, None]
        integral = 0.0
        for ui, wi in zip(physics._GJ16_U64, physics._GJ16_WG64):
            integral = integral + float(wi) * one_minus_j0(c * float(ui))
    tissue = torch.exp(-dbv[:, None] * integral) * s["envelope"]
    if C.use_blood:
        w = s["mnb"] * dbv[:, None]
        blood = s["bc"] * torch.exp(-tb["beta"] * oef[:, None] * oef[:, None])
        pred = (1.0 - w) * tissue + w * blood
    else:
        w = dbv[:, None]
        blood = torch.zeros_like(tissue)
        pred = (1.0 - w) * tissue
    return pred, tissue, integral, blood, w


def _ref(x, C: DecodeConsts):
    """Spin-echo normaliser of (N, T) rows, (N, 1)."""
    se = C.se
    if C.multi:
        # divided by a 0-d tensor: on CUDA, torch turns a division by a
        # Python scalar into a product with its reciprocal (two roundings),
        # where the kernel and the CPU divide (one)
        return ((x[:, se - 1:se] + x[:, se:se + 1] + x[:, se + 1:se + 2])
                / x.new_tensor(3.0))
    return x[:, se:se + 1]


def _nll_terms(r, sigma, C: DecodeConsts):
    s = C.scalars
    if C.student:
        dss = s["df"] * sigma * sigma
        denom = dss + r * r
        nll = s["t_const"] + torch.log(sigma) + s["half_df1"] * torch.log1p(
            r * r / dss)
        return (nll, s["df1"] * r / denom,
                1.0 / sigma - s["df1"] * r * r / (sigma * denom))
    nll = torch.log(sigma) + s["half_log_2pi"] + 0.5 * torch.square(r / sigma)
    return (nll, r / (sigma * sigma),
            1.0 / sigma - r * r / (sigma * (sigma * sigma)))


def _normalised(y, pred, mask, C: DecodeConsts):
    t_ref = _ref(y, C) + EPS
    p_ref = _ref(pred, C) + EPS
    yh_lin, q_lin = y / t_ref, pred / p_ref
    if C.log_data:
        live = (mask > 0)[:, None]
        return (yh_lin, q_lin, torch.where(live, torch.log(yh_lin), 0.0),
                torch.where(live, torch.log(q_lin), 0.0), t_ref, p_ref)
    return yh_lin, q_lin, yh_lin, q_lin, t_ref, p_ref


def nll_row_plain(oef, dbv, y, sigma, mask, C: DecodeConsts):
    """(N,) summed-over-tau NLL of one draw, unmasked (pallas_decode.
    _nll_row): oef/dbv/mask (N,), y/sigma (N, T)."""
    pred = _signal(oef, dbv, C)[0]
    _, _, yh, q, _, _ = _normalised(y, pred, mask, C)
    nll = _nll_terms(yh - q, sigma, C)[0]
    acc = 0.0
    for t in range(C.n_taus):
        acc = acc + nll[:, t]
    return acc


def nll_row_grads_plain(oef, dbv, y, sigma, mask, C: DecodeConsts):
    """Closed-form gradients of ``nll_row_plain`` for one draw, not
    cotangent-scaled (pallas_decode._nll_row_grads): (doef (N,),
    ddbv (N,), dsigma (N, T), dy (N, T))."""
    tb, s = C.tensors(oef.device), C.scalars
    o = oef[:, None]
    pred, tissue, integral, blood, w = _signal(oef, dbv, C)
    if C.cheb:
        cc = tb["tk"] * o
        raw = 2.0 * (torch.square(cc) * s["inv_cmax2"]) - 1.0
        d_i = physics._clenshaw(torch.clamp(raw, max=1.0),
                                physics._CHEB_DI32) * tb["dc"] * cc
        d_i = torch.where(raw <= 1.0, d_i, 0.0)
    else:
        c = tb["tk15"] * o
        d_i = 0.0
        for i, ui in enumerate(physics._GJ16_U64):
            d_i = d_i + tb["gj_d"][:, i] * bessel_j1(c * float(ui))
    dt_doef = -dbv[:, None] * d_i * tissue
    dt_ddbv = -integral * tissue
    if C.use_blood:
        db_doef = -2.0 * tb["beta"] * o * blood
        dpred_doef = (1.0 - w) * dt_doef + w * db_doef
        dpred_ddbv = (1.0 - w) * dt_ddbv + s["mnb"] * (blood - tissue)
    else:
        dpred_doef = (1.0 - w) * dt_doef
        dpred_ddbv = (1.0 - w) * dt_ddbv - tissue
    yh_lin, q_lin, yh, z, t_ref, p_ref = _normalised(y, pred, mask, C)
    _, d_r, d_sig = _nll_terms(yh - z, sigma, C)
    e, c = -d_r, d_r
    if C.log_data:
        e = e / q_lin
        c = torch.where((mask > 0)[:, None],
                        d_r / torch.clamp(yh_lin, min=1e-30), 0.0)
    sum_eq, sum_cy = 0.0, 0.0
    for t in range(C.n_taus):
        sum_eq = sum_eq + e[:, t] * q_lin[:, t]
        sum_cy = sum_cy + c[:, t] * yh_lin[:, t]
    window = range(C.se - 1, C.se + 2) if C.multi else (C.se,)
    kp = (sum_eq[:, None] * (s["wk"] / p_ref))[:, 0]
    ky = (sum_cy[:, None] * (s["wk"] / t_ref))[:, 0]
    doef = torch.zeros_like(oef)
    ddbv = torch.zeros_like(oef)
    dys = []
    for t in range(C.n_taus):
        dnll_dpred = e[:, t] / p_ref[:, 0]
        dnll_dy = c[:, t] / t_ref[:, 0]
        if t in window:
            dnll_dpred = dnll_dpred - kp
            dnll_dy = dnll_dy - ky
        doef = doef + dnll_dpred * dpred_doef[:, t]
        ddbv = ddbv + dnll_dpred * dpred_ddbv[:, t]
        dys.append(dnll_dy)
    return doef, ddbv, d_sig, torch.stack(dys, -1)


# ---- kernel wrappers ----------------------------------------------------------

def _device_of(x: torch.Tensor, name: str = "decode+NLL") -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {name} kernel for device {x.device}")
    return x.device.type


def _check_cuda(name, *tensors):
    for t in tensors:
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise TypeError(f"the {name} kernel takes float32 CUDA tensors, "
                            f"got {t.dtype} on {t.device}")
    return [t.contiguous() for t in tensors]


def _grid(n: int) -> int:
    """The fused ELBO kernel's grid (one thread a voxel, grid-stride)."""
    return max(1, min((n + _BLOCK - 1) // _BLOCK, 1 << 20))


def decode_nll_forward(oef, dbv, y, sigma, mask, C: DecodeConsts):
    """(N,) masked NLL rows. CUDA: kernel G's forward (counted in
    ``decode_nll_forward.launches``); CPU: the plain version."""
    if _device_of(oef) == "cpu":
        return nll_row_plain(oef, dbv, y, sigma, mask, C) * mask
    oef, dbv, y, sigma, mask = _check_cuda("decode+NLL", oef, dbv, y, sigma,
                                           mask)
    n = oef.shape[0]
    rows = torch.empty_like(oef)
    if n == 0:
        return rows
    table = C.device_table(oef.device)
    with torch.cuda.device(oef.device):
        err = _cuda.library().qv_decode_nll_fwd(
            oef.data_ptr(), dbv.data_ptr(), y.data_ptr(), sigma.data_ptr(),
            mask.data_ptr(), n, C.struct(), C.coeffs(), table.data_ptr(),
            table.numel(), rows.data_ptr(),
            torch.cuda.current_stream(oef.device).cuda_stream)
    _cuda.check(err, "decode+NLL forward")
    decode_nll_forward.launches += 1
    return rows


def decode_nll_backward(oef, dbv, y, sigma, mask, ct, C: DecodeConsts,
                        want_dy: bool = True):
    """(doef, ddbv, dsigma, dy) of ``sum(ct * rows)``, dy None unless
    ``want_dy``. CUDA: kernel G's backward, which then leaves the dy store
    out (counted in ``decode_nll_backward.launches``); CPU: plain."""
    if _device_of(oef) == "cpu":
        ct = ct * mask
        doef, ddbv, dsig, dy = nll_row_grads_plain(oef, dbv, y, sigma, mask,
                                                   C)
        return (ct * doef, ct * ddbv, ct[:, None] * dsig,
                ct[:, None] * dy if want_dy else None)
    oef, dbv, y, sigma, mask, ct = _check_cuda(
        "decode+NLL", oef, dbv, y, sigma, mask, ct)
    n = oef.shape[0]
    doef, ddbv = torch.empty_like(oef), torch.empty_like(oef)
    dsig = torch.empty_like(y)
    dy = torch.empty_like(y) if want_dy else None
    if n == 0:
        return doef, ddbv, dsig, dy
    table = C.device_table(oef.device)
    with torch.cuda.device(oef.device):
        err = _cuda.library().qv_decode_nll_bwd(
            oef.data_ptr(), dbv.data_ptr(), y.data_ptr(), sigma.data_ptr(),
            mask.data_ptr(), ct.data_ptr(), n, C.struct(), C.coeffs(),
            table.data_ptr(), table.numel(), doef.data_ptr(),
            ddbv.data_ptr(), dsig.data_ptr(),
            dy.data_ptr() if want_dy else None,
            torch.cuda.current_stream(oef.device).cuda_stream)
    _cuda.check(err, "decode+NLL backward")
    decode_nll_backward.launches += 1
    return doef, ddbv, dsig, dy


decode_nll_forward.launches = 0
decode_nll_backward.launches = 0


class _DecodeNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, oef, dbv, y, sigma, mask, C):
        ctx.save_for_backward(oef, dbv, y, sigma, mask)
        ctx.C = C
        return decode_nll_forward(oef, dbv, y, sigma, mask, C)

    @staticmethod
    def backward(ctx, ct):
        oef, dbv, y, sigma, mask = ctx.saved_tensors
        doef, ddbv, dsig, dy = decode_nll_backward(
            oef, dbv, y, sigma, mask, ct, ctx.C,
            want_dy=ctx.needs_input_grad[2])
        return doef, ddbv, dy, dsig, None, None


def decode_nll_rows(oef, dbv, y, sigma, mask, C: DecodeConsts):
    """(N,) masked per-voxel NLL rows of the draws (oef, dbv) (N,) against
    y, sigma (N, T), differentiable in oef, dbv, y and sigma."""
    return _DecodeNLL.apply(oef, dbv, y, sigma, mask, C)
