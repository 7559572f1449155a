"""Logit-Normal / logit-MVN toolkit (PyTorch).

The counterpart of ``qbold_vi_tpu/dist/logit_mvn.py``: the raw-head
squashes, the logit <-> physical transforms, the (negative) log-probs of
the pretraining loss, reparameterised sampling, the whitening algebra and
the KL forms the fine-tune loss uses. Where the
JAX module draws from a PRNG key, the functions here take the standard
normals as an argument (``z``: ``(..., 2)`` for one draw, ``(S, ..., 2)``
for S draws -- the layout of ``jax.random.normal(key, shape + (2,))``),
so a test can hand both packages the same numbers.

Parameterisation (the encoder's raw head outputs):
    diag (K=4): [oef_mu, oef_logstd_raw, dbv_mu, dbv_logstd_raw]
    mvg  (K=5): [... , offdiag_raw]
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

__all__ = ["LogitMVN", "logit", "whiten_factors", "whiten_apply", "KL_BOUND",
           "OFFDIAG_SCALE"]

OFFDIAG_SCALE = math.exp(-2.0)
_LOG_2PI = math.log(2.0 * math.pi)
# the reference clips u = sigmoid(l) to [1e-6, 1 - 1e-6] with a
# straight-through gradient: in logit space a clamp at logit(1e-6)
KL_BOUND = math.log((1.0 - 1e-6) / 1e-6)


def logit(x: torch.Tensor) -> torch.Tensor:
    """Inverse sigmoid (reference logit_mvn.py:9-11)."""
    return torch.log(x / (1.0 - x))


def _clip_preserve_gradient(x: torch.Tensor, lo: float, hi: float):
    """The clipped value with the identity's gradient
    (tfp.math.clip_by_value_preserve_gradient, reference logit_mvn.py:65)."""
    return x + (torch.clamp(x, lo, hi) - x).detach()


def whiten_factors(ls0, ls1, od):
    """(inv_tl, inv_br, inv_bl) of the inverse Cholesky factor: depends on
    the distribution only, so loops over draws hoist it."""
    inv_tl = torch.exp(-ls0)
    inv_br = torch.exp(-ls1)
    inv_bl = -torch.exp(-ls0 - ls1) * od
    return inv_tl, inv_br, inv_bl


def whiten_apply(l0, l1, mu0, mu1, factors):
    """(r0, r1, w0, w1): residuals of a draw and their whitened form."""
    inv_tl, inv_br, inv_bl = factors
    r0 = l0 - mu0
    r1 = l1 - mu1
    return r0, r1, r0 * inv_tl, r1 * inv_br + r0 * inv_bl


def _kl_draw(q, z0, z1):
    q_mu0, q_ls0, q_mu1, q_ls1, q_od = q
    l0 = torch.clamp(q_mu0 + z0 * torch.exp(q_ls0), -KL_BOUND, KL_BOUND)
    l1 = torch.clamp(q_mu1 + z0 * q_od + z1 * torch.exp(q_ls1),
                     -KL_BOUND, KL_BOUND)
    return l0, l1


class _MvgKLStreamed(torch.autograd.Function):
    """mean_s 0.5 (swr_p(l_s) - swr_q(l_s)) + (ls_p0 + ls_p1) - (ls_q0 +
    ls_q1), l_s = clip(draw s of q): the reduced sampled KL of
    logit_mvn.py::_mvg_kl_streamed, one draw at a time (O(voxels) state),
    with its closed-form backward. q's own parameters are stop-gradiented
    inside swr_q and the clip is straight-through, as in the reference
    (model.py:592-610)."""

    @staticmethod
    def forward(ctx, z, *qp):
        q, p = qp[:5], qp[5:]
        p_mu0, p_ls0, p_mu1, p_ls1, p_od = p
        pf = whiten_factors(p_ls0, p_ls1, p_od)
        qf = whiten_factors(q[1], q[3], q[4])
        acc = torch.zeros_like(q[0])
        for s in range(z.shape[0]):
            l0, l1 = _kl_draw(q, z[s, ..., 0], z[s, ..., 1])
            _, _, wp0, wp1 = whiten_apply(l0, l1, p_mu0, p_mu1, pf)
            _, _, wq0, wq1 = whiten_apply(l0, l1, q[0], q[2], qf)
            acc = acc + 0.5 * ((wp0 * wp0 + wp1 * wp1)
                               - (wq0 * wq0 + wq1 * wq1))
        ctx.save_for_backward(z, *qp)
        return acc / float(z.shape[0]) + ((p_ls0 + p_ls1) - (q[1] + q[3]))

    @staticmethod
    def backward(ctx, g):
        z, *qp = ctx.saved_tensors
        q, p = qp[:5], qp[5:]
        q_mu0, q_ls0, q_mu1, q_ls1, q_od = q
        p_mu0, p_ls0, p_mu1, p_ls1, p_od = p
        p_itl, p_ibr, p_ibl = pf = whiten_factors(p_ls0, p_ls1, p_od)
        q_itl, q_ibr, q_ibl = qf = whiten_factors(q_ls0, q_ls1, q_od)
        q_std0, q_std1 = torch.exp(q_ls0), torch.exp(q_ls1)
        p_ee = torch.exp(-p_ls0 - p_ls1)
        acc = [torch.zeros_like(q_mu0) for _ in range(10)]
        for s in range(z.shape[0]):
            z0, z1 = z[s, ..., 0], z[s, ..., 1]
            l0, l1 = _kl_draw(q, z0, z1)
            rp0, _, wp0, wp1 = whiten_apply(l0, l1, p_mu0, p_mu1, pf)
            _, _, wq0, wq1 = whiten_apply(l0, l1, q_mu0, q_mu1, qf)
            dp_l0 = wp0 * p_itl + wp1 * p_ibl
            dp_l1 = wp1 * p_ibr
            dl0 = dp_l0 - (wq0 * q_itl + wq1 * q_ibl)
            dl1 = dp_l1 - wq1 * q_ibr
            terms = (dl0, dl0 * z0 * q_std0, dl1, dl1 * z1 * q_std1,
                     dl1 * z0, -dp_l0, -(wp0 * wp0 + wp1 * rp0 * p_ibl),
                     -dp_l1, -(wp1 * wp1), -(wp1 * rp0 * p_ee))
            acc = [a + t for a, t in zip(acc, terms)]
        inv_n = 1.0 / float(z.shape[0])
        grads = [a * inv_n for a in acc]
        grads[6] = grads[6] + 1.0      # + (ls_p0 + ls_p1); q side detached
        grads[8] = grads[8] + 1.0
        return (None, *(g * d for d in grads))


@dataclass(frozen=True)
class LogitMVN:
    """Bivariate (OEF, DBV) logit-Normal with optional full covariance."""

    oef_range: float = 0.8
    min_oef: float = 0.04
    dbv_range: float = 0.2
    min_dbv: float = 0.001

    @staticmethod
    def transform_std(raw: torch.Tensor) -> torch.Tensor:
        """Raw head output -> log-std in (-4, 2)."""
        return torch.tanh(raw) * 3.0 - 1.0

    @staticmethod
    def transform_offdiag(raw: torch.Tensor) -> torch.Tensor:
        """Raw head output -> Cholesky off-diagonal in (-e^-2, e^-2)."""
        return torch.tanh(raw) * OFFDIAG_SCALE

    def forward_transform(self, logits: torch.Tensor) -> torch.Tensor:
        """Logit-space (..., 2) -> physical (OEF, DBV) (..., 2)."""
        oef = torch.sigmoid(logits[..., 0:1]) * self.oef_range + self.min_oef
        dbv = torch.sigmoid(logits[..., 1:2]) * self.dbv_range + self.min_dbv
        return torch.cat([oef, dbv], dim=-1)

    def backwards_transform(self, signal: torch.Tensor,
                            include_logit: bool) -> torch.Tensor:
        """Physical (OEF, DBV) (..., 2) -> the unit interval, and on to
        logit space with ``include_logit`` (reference logit_mvn.py:80-89).
        Divides by 0-d tensors: torch's CUDA kernels take a Python scalar
        divisor as a product with its reciprocal."""
        rng = signal.new_tensor([self.oef_range, self.dbv_range])
        oef = (signal[..., 0:1] - self.min_oef) / rng[0]
        dbv = (signal[..., 1:2] - self.min_dbv) / rng[1]
        out = torch.cat([oef, dbv], dim=-1)
        return logit(out) if include_logit else out

    def _unit_obs(self, observations: torch.Tensor) -> torch.Tensor:
        """Observations in the unit interval, clipped to [1e-6, 1 - 1e-6]
        with the identity's gradient: an observation at a range bound
        would otherwise logit to +-inf."""
        x = self.backwards_transform(observations[..., 0:2],
                                     include_logit=False)
        return _clip_preserve_gradient(x, 1e-6, 1.0 - 1e-6)

    def logit_gaussian_mvg_log_prob(self, observations: torch.Tensor,
                                    params: torch.Tensor) -> torch.Tensor:
        """The NEGATIVE log-density of physical (OEF, DBV) observations
        (..., 2) under the full-covariance logit-Normal of raw heads
        (..., 5), the reference's sign despite the name (reference
        logit_mvn.py:46-70). Returns (...,)."""
        mu0, ls0, mu1, ls1, od = self.unpack(params, mvg=True)
        x = self._unit_obs(observations)
        swr = self.squared_whitened_residual(
            logit(x), torch.stack([mu0, mu1], -1), ls0, ls1, od)
        nll = _LOG_2PI + 0.5 * self.log_chol_det(ls0, ls1) + 0.5 * swr
        return nll + torch.sum(torch.log(x) + torch.log(1.0 - x), -1)

    @staticmethod
    def gaussian_nll(obs, mean, log_std):
        """Diagonal Gaussian NLL without its log(2 pi) / 2 constant, as the
        reference drops it (model.py:402-404)."""
        return log_std + 0.5 * torch.square((obs - mean) / torch.exp(log_std))

    def logit_gaussian_log_prob(self, observations: torch.Tensor,
                                params: torch.Tensor) -> torch.Tensor:
        """The diagonal counterpart of ``logit_gaussian_mvg_log_prob``
        (reference model.py:406-421), with the same sign and the same
        dropped constant as ``gaussian_nll``."""
        mu0, ls0, mu1, ls1, _ = self.unpack(params, mvg=False)
        x = self._unit_obs(observations)
        lx = logit(x)
        nll = (self.gaussian_nll(lx[..., 0], mu0, ls0)
               + self.gaussian_nll(lx[..., 1], mu1, ls1))
        return nll + torch.sum(torch.log(x * (1.0 - x)), -1)

    def unpack(self, params: torch.Tensor, mvg: bool):
        """(..., 4|5) head -> (oef_mu, oef_log_std, dbv_mu, dbv_log_std,
        offdiag), squashed; offdiag is 0 for a diagonal head."""
        oef_mu = params[..., 0]
        offdiag = (self.transform_offdiag(params[..., 4]) if mvg
                   else torch.zeros_like(oef_mu))
        return (oef_mu, self.transform_std(params[..., 1]), params[..., 2],
                self.transform_std(params[..., 3]), offdiag)

    def sample(self, z: torch.Tensor, params: torch.Tensor, mvg: bool):
        """Reparameterised draw from normals z (..., 2) -> physical
        (OEF, DBV) (..., 2); the MVG draw shares z0 through the Cholesky
        off-diagonal (model.py:24-31)."""
        oef_mu, oef_ls, dbv_mu, dbv_ls, offd = self.unpack(params, mvg)
        oef = oef_mu + z[..., 0] * torch.exp(oef_ls)
        if mvg:
            dbv = dbv_mu + z[..., 0] * offd + z[..., 1] * torch.exp(dbv_ls)
        else:
            dbv = dbv_mu + z[..., 1] * torch.exp(dbv_ls)
        return self.forward_transform(torch.stack([oef, dbv], -1))

    def sample_many(self, z: torch.Tensor, params: torch.Tensor, mvg: bool):
        """S draws from normals z (S, ..., 2) -> (S, ..., 2)."""
        return self.sample(z, params, mvg)

    @staticmethod
    def squared_whitened_residual(obs, mean, oef_log_std, dbv_log_std,
                                  offdiag):
        """||L^-1 (obs - mean)||^2, L = [[e^a, 0], [c, e^b]]."""
        _, _, w0, w1 = whiten_apply(
            obs[..., 0], obs[..., 1], mean[..., 0], mean[..., 1],
            whiten_factors(oef_log_std, dbv_log_std, offdiag))
        return torch.square(w0) + torch.square(w1)

    @staticmethod
    def log_chol_det(oef_log_std, dbv_log_std):
        return 2.0 * (oef_log_std + dbv_log_std)

    @staticmethod
    def normal_kl(q_mu, q_log_std, p_mu, p_log_std):
        """KL(N_q || N_p), univariate (and of the matching LogitNormals)."""
        var_ratio = torch.exp(2.0 * (q_log_std - p_log_std))
        t1 = torch.square(q_mu - p_mu) * torch.exp(-2.0 * p_log_std)
        return 0.5 * (var_ratio + t1 - 1.0) + p_log_std - q_log_std

    def diag_kl(self, q_params, p_params):
        """Analytic KL of the diagonal pair, summed over OEF and DBV."""
        q0, q1, q2, q3, _ = self.unpack(q_params, mvg=False)
        p0, p1, p2, p3, _ = self.unpack(p_params, mvg=False)
        return self.normal_kl(q0, q1, p0, p1) + self.normal_kl(q2, q3, p2, p3)

    def mvg_kl_closed_form(self, q_params, p_params):
        """Exact KL between two 2x2 Gaussians in Cholesky form:
        0.5 [tr(P^-1 Q) + swr + log|P| - log|Q| - 2], with
        tr(P^-1 Q) = ||L_p^-1 L_q||_F^2 (the statistical oracle of the
        sampled KL)."""
        q_mu0, q_ls0, q_mu1, q_ls1, q_od = self.unpack(q_params, mvg=True)
        p_mu0, p_ls0, p_mu1, p_ls1, p_od = self.unpack(p_params, mvg=True)
        det = (self.log_chol_det(p_ls0, p_ls1)
               - self.log_chol_det(q_ls0, q_ls1))
        swr = self.squared_whitened_residual(
            torch.stack([p_mu0, p_mu1], -1), torch.stack([q_mu0, q_mu1], -1),
            p_ls0, p_ls1, p_od)
        it, ir = torch.exp(-p_ls0), torch.exp(-p_ls1)
        ib = -p_od * torch.exp(-p_ls0 - p_ls1)
        la, lb = torch.exp(q_ls0), torch.exp(q_ls1)
        m00 = it * la
        m10 = ib * la + ir * q_od
        m11 = ir * lb
        trace = torch.square(m00) + torch.square(m10) + torch.square(m11)
        return 0.5 * (trace + swr + det - 2.0)

    def mvg_kl_samples(self, z: torch.Tensor, q_params, p_params,
                       mvg: bool = True):
        """Sampled KL(q || p) over the draws z (S, ..., 2) of q, in the
        reduced streamed form, exact in value and gradient against the
        JAX ``mvg_kl_samples`` given the same normals; ``mvg=False`` reads
        (..., 4) diagonal heads (off-diagonal 0). Returns (...,)."""
        q = self.unpack(q_params, mvg)
        p = self.unpack(p_params, mvg)
        return _MvgKLStreamed.apply(z, *q, *p)

    def posterior_means_streamed(self, z: torch.Tensor, params, mvg: bool,
                                 dw_coeff: float):
        """MC posterior means and biased variances of physical (OEF, DBV)
        and R2' = (dw_coeff * OEF) * DBV over the draws z (S, ..., 2),
        accumulating sums and sums of squares one draw at a time (O(voxels)
        state). The variances E[x^2] - E[x]^2 are clamped at 0. Returns
        (means (..., 3), vars (..., 3))."""
        n = z.shape[0]
        s1 = params.new_zeros(params.shape[:-1] + (3,))
        s2 = s1
        for i in range(n):
            s = self.sample(z[i], params, mvg)
            r = dw_coeff * s[..., 0] * s[..., 1]
            s = torch.cat([s, r[..., None]], -1)
            s1 = s1 + s
            s2 = s2 + torch.square(s)
        # a product with 1/S, as the kernel (ops/summarize.py) takes it
        inv_n = 1.0 / float(n)
        mean = s1 * inv_n
        var = s2 * inv_n - torch.square(mean)
        return mean, torch.clamp(var, min=0.0)
