"""The fused fine-tune ELBO rows, forward and backward (kernel F).

The counterpart of ``qbold_vi_tpu/ops/pallas_elbo.py``: per voxel, from
the raw posterior map q and the prior map p (N, 5|4), the tau-series y and
sigma (N, T) and the mask (N,),

* s_nll posterior draws, forward-transformed to (OEF, DBV), decoded and
  scored by the masked NLL row (ops/decode_nll.py's per-draw routine);
* the s_kl-draw reduced sampled MVG KL (dist/logit_mvn.py), or the
  analytic diagonal KL;

giving ``(nll_rows, kl_rows)`` (N,); the backward replays the draws and
gives dq, dp, dy and dsigma in closed form. The loss is assembled as
``sum(nll_rows) / (s_nll * sum(mask)) + sum(kl_rows) / sum(mask)``.

The KL state: with a ``state`` (N, 6) tensor the MVG forward also writes,
per voxel, the moments of its KL draws (sum z0, z1, z0^2, z0 z1, z1^2) and
a flag "some draw clamped at +-kl_bound" (``kl_state_plain``). Given it,
the backward forms the KL side of an unflagged voxel from the moments in
closed form and draws only the NLL draws (the kernel's ``from_state``
path); ``fused_elbo`` passes it from its forward to its backward. The
state changes no result beyond rounding: the plain versions define both.

Noise: ``z_nll`` (s_nll, N, 2) and ``z_kl`` (s_kl, N, 2) standard normals
in the JAX layout (host noise), or a ``seed``: the kernel then draws
normal pair d of row v from a Philox4x32-10 counter (offset + v, d) keyed
by the seed (draws 0..s_nll-1 for the NLL, s_nll.. for the KL) and its
backward replays them bit for bit; ``offset`` (default 0) lets a launch
over some rows of a larger set draw what a launch over the whole set draws
for them. ``philox_normals`` is the same generator in numpy: the plain
version takes its normals from it for a seed.

* ``elbo_rows_plain`` / ``elbo_grads_plain``: the plain torch versions of
  the two Pallas kernels; ``kl_state_plain``: of the state;
* ``fused_elbo_forward`` / ``fused_elbo_backward``: the wrappers of the
  hand-written kernel ``csrc/fused_elbo.cu``. A CUDA tensor launches it,
  counted in ``<wrapper>.launches`` (and the backward's state path in
  ``fused_elbo_backward.from_state``), or raises; a CPU tensor runs the
  plain version;
* ``fused_elbo``: the op as a ``torch.autograd.Function``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ModelConfig, ScanParams
from ..dist.logit_mvn import whiten_apply, whiten_factors
from . import _cuda
from .decode_nll import (DecodeConsts, _check_cuda, _device_of, _grid,
                         fused_available, nll_row_grads_plain, nll_row_plain)

__all__ = ["fused_elbo_available", "fused_elbo", "fused_elbo_forward",
           "fused_elbo_backward", "elbo_rows_plain", "elbo_grads_plain",
           "kl_state_plain", "philox_normals", "philox_block",
           "box_muller", "KL_STATE"]

_EXP_M2 = float(np.exp(-2.0))
KL_STATE = 6                # floats of the KL state a voxel (csrc QV_STATE)
_BWD_LANES = 2              # lanes a backward voxel (csrc QV_BWD_LANES)


def fused_elbo_available(cfg: ModelConfig, scan: ScanParams,
                         full_model: bool, use_blood: bool) -> bool:
    """The decode+NLL kernel's coverage, for an MVG posterior or a diagonal
    one without a population prior (whose KL carries a whole-map
    hyperprior cost, model.py:712-716, not a per-voxel row)."""
    if not fused_available(cfg, scan, full_model, use_blood):
        return False
    return cfg.use_mvg or not cfg.use_population_prior


# ---- the device-noise generator -------------------------------------------------

_PHILOX_M = (np.uint64(0xD2511F53), np.uint64(0xCD9E8D57))
_PHILOX_W = (np.uint64(0x9E3779B9), np.uint64(0xBB67AE85))
_MASK32 = np.uint64(0xFFFFFFFF)


def philox_block(seed: int, v, ctr) -> list:
    """Words c0..c3 of the Philox4x32-10 blocks with counters (v lo, v hi,
    ctr, 0) keyed by (seed lo, seed hi), for broadcastable uint64 arrays v
    and ctr: csrc/elbo_math.cuh::qv_philox."""
    v, ctr = np.broadcast_arrays(np.asarray(v, np.uint64),
                                 np.asarray(ctr, np.uint64))
    c = [v & _MASK32, v >> np.uint64(32), ctr.copy(),
         np.zeros(v.shape, np.uint64)]
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    k0, k1 = np.uint64(s & 0xFFFFFFFF), np.uint64(s >> 32)
    for _ in range(10):
        p0 = _PHILOX_M[0] * c[0]
        p1 = _PHILOX_M[1] * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & _MASK32,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & _MASK32]
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c


def box_muller(a, b):
    """(..., 2) float32 normals from two Philox words a, b (their top 24
    bits): csrc/elbo_math.cuh::qv_box_muller up to the last-bit rounding
    of float32 log/sin/cos."""
    scale = np.float32(2.0 ** -24)
    u1 = ((a >> np.uint64(8)) + np.uint64(1)).astype(np.float32) * scale
    u2 = (b >> np.uint64(8)).astype(np.float32) * scale
    r = np.sqrt(np.float32(-2.0) * np.log(u1))
    th = np.float32(2.0 * np.pi) * u2
    return np.stack([r * np.cos(th), r * np.sin(th)], -1).astype(np.float32)


def philox_normals(seed: int, n: int, draws: int, first: int = 0,
                   offset: int = 0):
    """(draws, n, 2) float32 normals of draws first.. first+draws-1 of
    voxels offset..offset+n-1, bit for bit the counters of
    csrc/elbo_math.cuh::qv_normal2 (Philox4x32-10, counter (v lo, v hi,
    draw, 0), key (seed lo, seed hi); Box-Muller on words 0 and 1) up to
    the last-bit rounding of float32 log/sin/cos."""
    v = np.arange(offset, offset + n, dtype=np.uint64)
    d = np.arange(first, first + draws, dtype=np.uint64)
    c = philox_block(seed, v[None, :], d[:, None])
    return box_muller(c[0], c[1])


def _seed_normals(seed, n, s_nll, s_kl, device, offset=0):
    z = torch.from_numpy(philox_normals(seed, n, s_nll + s_kl,
                                        offset=offset)).to(device)
    return z[:s_nll], z[s_nll:]


# ---- plain versions ------------------------------------------------------------

def _unpack(raw, mvg: bool):
    """Squashed (mu0, ls0, mu1, ls1, od) and the tanh chain factors of
    ls0, ls1, od (pallas_elbo._unpack_q)."""
    t1, t3 = torch.tanh(raw[:, 1]), torch.tanh(raw[:, 3])
    if mvg:
        t4 = torch.tanh(raw[:, 4])
        od, c4 = t4 * _EXP_M2, _EXP_M2 * (1.0 - t4 * t4)
    else:
        od = c4 = torch.zeros_like(t1)
    return ((raw[:, 0], t1 * 3.0 - 1.0, raw[:, 2], t3 * 3.0 - 1.0, od),
            (3.0 * (1.0 - t1 * t1), 3.0 * (1.0 - t3 * t3), c4))


def _draw(q, std0, std1, z0, z1, C: DecodeConsts):
    l0 = q[0] + z0 * std0
    l1 = q[2] + z0 * q[4] + z1 * std1
    s0, s1 = torch.sigmoid(l0), torch.sigmoid(l1)
    s = C.scalars
    return (s0, s1, s0 * s["oef_range"] + s["min_oef"],
            s1 * s["dbv_range"] + s["min_dbv"])


def _kl_logits(q, std0, std1, z0, z1, bound):
    l0 = torch.clamp(q[0] + z0 * std0, -bound, bound)
    l1 = torch.clamp(q[2] + z0 * q[4] + z1 * std1, -bound, bound)
    return l0, l1


def elbo_rows_plain(q, p, y, sigma, mask, z_nll, z_kl, C: DecodeConsts,
                    mvg: bool):
    """(nll_rows, kl_rows) (N,) of pallas_elbo._elbo_fwd_kernel, given the
    normals (z_kl unused for a diagonal posterior)."""
    qs, _ = _unpack(q, mvg)
    ps, _ = _unpack(p, mvg)
    std0, std1 = torch.exp(qs[1]), torch.exp(qs[3])
    nll = torch.zeros_like(std0)
    for s in range(z_nll.shape[0]):
        *_, oef, dbv = _draw(qs, std0, std1, z_nll[s, :, 0], z_nll[s, :, 1], C)
        nll = nll + nll_row_plain(oef, dbv, y, sigma, mask, C)
    if mvg:
        qf = whiten_factors(qs[1], qs[3], qs[4])
        pf = whiten_factors(ps[1], ps[3], ps[4])
        acc = torch.zeros_like(std0)
        for s in range(z_kl.shape[0]):
            l0, l1 = _kl_logits(qs, std0, std1, z_kl[s, :, 0], z_kl[s, :, 1],
                                C.scalars["kl_bound"])
            _, _, wq0, wq1 = whiten_apply(l0, l1, qs[0], qs[2], qf)
            _, _, wp0, wp1 = whiten_apply(l0, l1, ps[0], ps[2], pf)
            acc = acc + 0.5 * ((wp0 * wp0 + wp1 * wp1)
                               - (wq0 * wq0 + wq1 * wq1))
        kl = acc * (1.0 / float(z_kl.shape[0])) + (
            (ps[1] + ps[3]) - (qs[1] + qs[3]))
    else:
        vr0 = torch.exp(2.0 * (qs[1] - ps[1]))
        vr1 = torch.exp(2.0 * (qs[3] - ps[3]))
        d0 = (qs[0] - ps[0]) * torch.exp(-ps[1])
        d1 = (qs[2] - ps[2]) * torch.exp(-ps[3])
        kl = (0.5 * (vr0 + d0 * d0 - 1.0) + ps[1] - qs[1]
              + 0.5 * (vr1 + d1 * d1 - 1.0) + ps[3] - qs[3])
    return nll * mask, torch.where(mask > 0, kl, 0.0)


def elbo_grads_plain(q, p, y, sigma, mask, z_nll, z_kl, ct_n, ct_k,
                     C: DecodeConsts, mvg: bool):
    """(dq, dp, dy, dsigma) of sum(ct_n * nll_rows + ct_k * kl_rows), the
    closed form of pallas_elbo._elbo_bwd_kernel."""
    qs, (qc1, qc3, qc4) = _unpack(q, mvg)
    ps, (pc1, pc3, pc4) = _unpack(p, mvg)
    std0, std1 = torch.exp(qs[1]), torch.exp(qs[3])
    ct_n = ct_n * mask
    ct_k = ct_k * torch.where(mask > 0, 1.0, 0.0)
    zero = torch.zeros_like(std0)
    g = [zero] * 5
    dsig_acc = dy_acc = 0.0
    s_ = C.scalars
    for s in range(z_nll.shape[0]):
        z0, z1 = z_nll[s, :, 0], z_nll[s, :, 1]
        s0, s1, oef, dbv = _draw(qs, std0, std1, z0, z1, C)
        doef, ddbv, dsig, dy = nll_row_grads_plain(oef, dbv, y, sigma, mask,
                                                   C)
        dl0 = doef * (s_["oef_range"] * s0 * (1.0 - s0))
        dl1 = ddbv * (s_["dbv_range"] * s1 * (1.0 - s1))
        g = [g[0] + dl0, g[1] + dl0 * z0 * std0, g[2] + dl1,
             g[3] + dl1 * z1 * std1, g[4] + dl1 * z0]
        dsig_acc = dsig_acc + dsig
        dy_acc = dy_acc + dy
    if mvg:
        q_itl, q_ibr, q_ibl = qf = whiten_factors(qs[1], qs[3], qs[4])
        p_itl, p_ibr, p_ibl = pf = whiten_factors(ps[1], ps[3], ps[4])
        p_ee = torch.exp(-ps[1] - ps[3])
        k = [zero] * 10
        for s in range(z_kl.shape[0]):
            z0, z1 = z_kl[s, :, 0], z_kl[s, :, 1]
            l0, l1 = _kl_logits(qs, std0, std1, z0, z1, s_["kl_bound"])
            rp0, _, wp0, wp1 = whiten_apply(l0, l1, ps[0], ps[2], pf)
            _, _, wq0, wq1 = whiten_apply(l0, l1, qs[0], qs[2], qf)
            dp_l0 = wp0 * p_itl + wp1 * p_ibl
            dp_l1 = wp1 * p_ibr
            dl0 = dp_l0 - (wq0 * q_itl + wq1 * q_ibl)
            dl1 = dp_l1 - wq1 * q_ibr
            k = [k[0] + dl0, k[1] + dl0 * z0 * std0, k[2] + dl1,
                 k[3] + dl1 * z1 * std1, k[4] + dl1 * z0, k[5] - dp_l0,
                 k[6] - (wp0 * wp0 + wp1 * rp0 * p_ibl), k[7] - dp_l1,
                 k[8] - wp1 * wp1, k[9] - wp1 * rp0 * p_ee]
        inv_n = 1.0 / float(z_kl.shape[0])
        k = [a * inv_n for a in k]
        k[6] = k[6] + 1.0       # det term; q's log-det is detached
        k[8] = k[8] + 1.0
    else:
        vr0 = torch.exp(2.0 * (qs[1] - ps[1]))
        vr1 = torch.exp(2.0 * (qs[3] - ps[3]))
        dm0 = (qs[0] - ps[0]) * torch.exp(-2.0 * ps[1])
        dm1 = (qs[2] - ps[2]) * torch.exp(-2.0 * ps[3])
        k = [dm0, vr0 - 1.0, dm1, vr1 - 1.0, zero, -dm0,
             1.0 - vr0 - (qs[0] - ps[0]) * dm0, -dm1,
             1.0 - vr1 - (qs[2] - ps[2]) * dm1, zero]
    dq = [ct_n * g[0] + ct_k * k[0], (ct_n * g[1] + ct_k * k[1]) * qc1,
          ct_n * g[2] + ct_k * k[2], (ct_n * g[3] + ct_k * k[3]) * qc3]
    dp = [ct_k * k[5], ct_k * k[6] * pc1, ct_k * k[7], ct_k * k[8] * pc3]
    if mvg:
        dq.append((ct_n * g[4] + ct_k * k[4]) * qc4)
        dp.append(ct_k * k[9] * pc4)
    return (torch.stack(dq, -1), torch.stack(dp, -1),
            ct_n[:, None] * dy_acc, ct_n[:, None] * dsig_acc)


def kl_state_plain(q, mask, z_kl, C: DecodeConsts):
    """(N, KL_STATE) KL state of an MVG forward: per live voxel the sums
    over its KL draws of z0, z1, z0^2, z0 z1 and z1^2, and 1.0 where some
    draw's logits clamp at +-kl_bound (0.0 otherwise); 0 rows where the
    mask is 0."""
    qs, _ = _unpack(q, True)
    std0, std1 = torch.exp(qs[1]), torch.exp(qs[3])
    z0, z1 = z_kl[..., 0], z_kl[..., 1]
    u0 = qs[0] + z0 * std0
    u1 = qs[2] + z0 * qs[4] + z1 * std1
    b = C.scalars["kl_bound"]
    clamped = ((torch.clamp(u0, -b, b) != u0)
               | (torch.clamp(u1, -b, b) != u1)).any(0)
    state = torch.stack([z0.sum(0), z1.sum(0), (z0 * z0).sum(0),
                         (z0 * z1).sum(0), (z1 * z1).sum(0),
                         clamped.to(z0.dtype)], -1)
    return torch.where((mask != 0)[:, None], state, 0.0)


# ---- kernel wrappers ------------------------------------------------------------

def _noise_args(z_nll, z_kl, seed, n, s_nll, s_kl, mvg):
    """Host normals (checked, contiguous) or the seed, for the kernel."""
    if seed is not None:
        return 0, 0, int(seed)
    if z_nll is None or (mvg and z_kl is None):
        raise ValueError("host noise needs z_nll (and z_kl for MVG), or "
                         "pass a seed")
    if tuple(z_nll.shape) != (s_nll, n, 2) or (
            mvg and tuple(z_kl.shape) != (s_kl, n, 2)):
        raise ValueError("z_nll / z_kl must be (s_nll|s_kl, N, 2)")
    (z_nll,) = _check_cuda("fused ELBO", z_nll)
    zk = _check_cuda("fused ELBO", z_kl)[0] if mvg else None
    return z_nll, zk, 0


def _plain_noise(z_nll, z_kl, seed, n, s_nll, s_kl, device, offset):
    if seed is not None:
        return _seed_normals(seed, n, s_nll, s_kl, device, offset)
    return z_nll, z_kl


def _check_state(state, q, n: int, mvg: bool):
    if state is None:
        return
    if not mvg:
        raise ValueError("the KL state is an MVG posterior's")
    if (tuple(state.shape) != (n, KL_STATE) or state.dtype != torch.float32
            or state.device != q.device or not state.is_contiguous()):
        raise ValueError(f"state must be a contiguous float32 (N, {KL_STATE}) "
                         "tensor on the device of q")


def fused_elbo_forward(q, p, y, sigma, mask, C: DecodeConsts, *, mvg: bool,
                       s_nll: int, s_kl: int, z_nll=None, z_kl=None,
                       seed=None, offset: int = 0, state=None):
    """(nll_rows, kl_rows). CUDA: kernel F's forward (counted in
    ``fused_elbo_forward.launches``); CPU: the plain version, with the
    normals of ``philox_normals`` (rows offset..) when given a seed.
    ``state``: an (N, KL_STATE) float32 tensor (MVG) that receives the KL
    state."""
    n = mask.shape[0]
    _check_state(state, q, n, mvg)
    if _device_of(q) == "cpu":
        zn, zk = _plain_noise(z_nll, z_kl, seed, n, s_nll, s_kl, q.device,
                              offset)
        if state is not None:
            state.copy_(kl_state_plain(q, mask, zk, C))
        return elbo_rows_plain(q, p, y, sigma, mask, zn, zk, C, mvg)
    q, p, y, sigma, mask = _check_cuda("fused ELBO", q, p, y, sigma, mask)
    zn, zk, sd = _noise_args(z_nll, z_kl, seed, n, s_nll, s_kl, mvg)
    nll, kl = torch.empty_like(mask), torch.empty_like(mask)
    if n == 0:
        return nll, kl
    table = C.device_table(q.device)
    ptr = (lambda t: t.data_ptr() if torch.is_tensor(t) else None)  # noqa: E731
    with torch.cuda.device(q.device):
        err = _cuda.library().qv_elbo_fwd(
            q.data_ptr(), p.data_ptr(), y.data_ptr(), sigma.data_ptr(),
            mask.data_ptr(), ptr(zn), ptr(zk), sd, int(offset), n, int(mvg),
            s_nll, s_kl, C.struct(), table.data_ptr(), table.numel(),
            nll.data_ptr(),
            kl.data_ptr(), ptr(state),
            _grid(n),
            torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.check(err, "fused ELBO forward")
    fused_elbo_forward.launches += 1
    return nll, kl


def fused_elbo_backward(q, p, y, sigma, mask, ct_n, ct_k, C: DecodeConsts, *,
                        mvg: bool, s_nll: int, s_kl: int, z_nll=None,
                        z_kl=None, seed=None, offset: int = 0, state=None):
    """(dq, dp, dy, dsigma) of sum(ct_n * nll_rows + ct_k * kl_rows).
    CUDA: kernel F's backward (counted in ``fused_elbo_backward.launches``;
    given the forward's ``state``, also in ``.from_state``: the KL side
    from the moments where no draw clamped); CPU: the plain version."""
    n = mask.shape[0]
    _check_state(state, q, n, mvg)
    if _device_of(q) == "cpu":
        zn, zk = _plain_noise(z_nll, z_kl, seed, n, s_nll, s_kl, q.device,
                              offset)
        return elbo_grads_plain(q, p, y, sigma, mask, zn, zk, ct_n, ct_k, C,
                                mvg)
    q, p, y, sigma, mask, ct_n, ct_k = _check_cuda(
        "fused ELBO", q, p, y, sigma, mask, ct_n, ct_k)
    zn, zk, sd = _noise_args(z_nll, z_kl, seed, n, s_nll, s_kl, mvg)
    dq, dp = torch.empty_like(q), torch.empty_like(q)
    dsig, dy = torch.empty_like(y), torch.empty_like(y)
    if n == 0:
        return dq, dp, dy, dsig
    table = C.device_table(q.device)
    ptr = (lambda t: t.data_ptr() if torch.is_tensor(t) else None)  # noqa: E731
    with torch.cuda.device(q.device):
        err = _cuda.library().qv_elbo_bwd(
            q.data_ptr(), p.data_ptr(), y.data_ptr(), sigma.data_ptr(),
            mask.data_ptr(), ptr(zn), ptr(zk), sd, int(offset), n, int(mvg),
            s_nll, s_kl, ct_n.data_ptr(), ct_k.data_ptr(), ptr(state), C.struct(),
            table.data_ptr(), table.numel(), dq.data_ptr(), dp.data_ptr(),
            dsig.data_ptr(), dy.data_ptr(),
            _grid(_BWD_LANES * n),
            torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.check(err, "fused ELBO backward")
    fused_elbo_backward.launches += 1
    fused_elbo_backward.from_state += state is not None
    return dq, dp, dy, dsig


fused_elbo_forward.launches = 0
fused_elbo_backward.launches = 0
fused_elbo_backward.from_state = 0


class _FusedELBO(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, p, y, sigma, mask, z_nll, z_kl, kw):
        # the backward reads the state on the card; the plain one needs none
        state = (q.new_empty((mask.shape[0], KL_STATE))
                 if kw["mvg"] and q.is_cuda else None)
        rows = fused_elbo_forward(q, p, y, sigma, mask, z_nll=z_nll,
                                  z_kl=z_kl, state=state, **kw)
        ctx.save_for_backward(q, p, y, sigma, mask, z_nll, z_kl, state)
        ctx.kw = kw
        return rows

    @staticmethod
    def backward(ctx, ct_n, ct_k):
        q, p, y, sigma, mask, z_nll, z_kl, state = ctx.saved_tensors
        dq, dp, dy, dsig = fused_elbo_backward(
            q, p, y, sigma, mask, ct_n, ct_k, z_nll=z_nll, z_kl=z_kl,
            state=state, **ctx.kw)
        return dq, dp, dy, dsig, None, None, None, None


def fused_elbo(q, p, y, sigma, mask, C: DecodeConsts, *, mvg: bool,
               s_nll: int, s_kl: int, z_nll=None, z_kl=None, seed=None,
               offset: int = 0):
    """(nll_rows, kl_rows) (N,), differentiable in q, p (N, 5|4), y and
    sigma (N, T). Host noise (z_nll (s_nll, N, 2), z_kl (s_kl, N, 2) for
    MVG) or a seed (device noise, row v's counter offset + v)."""
    kw = dict(C=C, mvg=mvg, s_nll=s_nll, s_kl=s_kl, seed=seed,
              offset=offset)
    return _FusedELBO.apply(q, p, y, sigma, mask, z_nll, z_kl, kw)
