"""Sampled posterior summaries and the sampled KL map (kernels D and E).

The counterpart of ``qbold_vi_tpu/ops/pallas_summarize.py``:

* ``mc_posterior_summaries(params (N, 4|5))`` -> (means (N, 3),
  vars (N, 3)) and ``mc_posterior_summaries_packed(q_t (5, N))`` ->
  channel-major (means (3, N), vars (3, N)): the S-draw Monte-Carlo means
  and biased variances of (OEF, DBV, R2'), one kernel D with strides for
  both layouts (csrc/summarize.cu). Draws come in antithetic pairs
  (z, -z), z accumulated first; odd S or S < 2 falls back to S iid draws.
* ``mc_kl_map(q, p (N, 4|5))`` -> (N,): the S-draw reduced sampled
  KL(q || p) of ``LogitMVN.mvg_kl_samples``, kernel E, ``KL_LANES``
  lanes a voxel: lane j sums the draws of the voxel's Philox blocks
  k = j (mod KL_LANES), and the lanes' sums meet in a fixed tree, so the
  map is deterministic but sums the draws in another order than the
  plain version.

Noise: host normals ``z`` in the JAX layout -- (pairs or draws, N, 2)
for D, (draws, N, 2) for E -- or a ``seed``: normal pairs 2k and 2k + 1 of
voxel v then come from words (0, 1) and (2, 3) of the Philox4x32-10 block
with counter (offset + v, k) keyed by the seed (one block for two pairs;
kernel F, ops/fused_elbo.py, takes one block a pair), drawn by the kernel
on the card and replayed bit for bit by ``mc_philox_normals`` for the
plain versions (up to the last-bit rounding of float32 log/sin/cos).
``offset`` is the global index of the first voxel, so a request cut into
chunks draws what the whole request would.

A CUDA tensor launches the kernel (counted in ``<wrapper>.launches``) or
raises; a CPU tensor runs the plain version, which repeats the kernel's
arithmetic in its order: ``mc_posterior_summaries_plain`` (through
``LogitMVN.posterior_means_streamed``) and ``mc_kl_map_plain`` (through
``LogitMVN.mvg_kl_samples``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..dist.logit_mvn import KL_BOUND, LogitMVN
from . import _cuda
from .decode_nll import _BLOCK, _check_cuda, _device_of, _grid
from .fused_elbo import box_muller, philox_block

__all__ = ["mc_posterior_summaries", "mc_posterior_summaries_packed",
           "mc_posterior_summaries_plain", "mc_kl_map", "mc_kl_map_plain",
           "mc_draws", "mc_normals", "mc_philox_normals", "KL_LANES"]

KL_LANES = 2     # kernel E's lanes a voxel: csrc/summarize.cu::QV_KL_LANES


def _check_samples(no_samples: int) -> None:
    if no_samples < 1:
        raise ValueError(f"no_samples must be >= 1, got {no_samples}")


def _antithetic(no_samples: int, antithetic: bool) -> bool:
    """(z, -z) pairing needs an even sample count >= 2; otherwise the
    estimator falls back to iid draws rather than drop a sample."""
    return antithetic and no_samples >= 2 and no_samples % 2 == 0


def mc_draws(no_samples: int, antithetic: bool = True) -> int:
    """The number of normal pairs kernel D reads or draws per voxel: S/2
    antithetic pairs, or S iid draws."""
    _check_samples(no_samples)
    return no_samples // 2 if _antithetic(no_samples, antithetic) \
        else no_samples


def mc_philox_normals(seed: int, n: int, draws: int, offset: int = 0):
    """(draws, n, 2) float32 normals of kernels D and E's device noise for
    voxels offset..offset+n-1: pairs 2k and 2k + 1 of voxel v from words
    (0, 1) and (2, 3) of the Philox4x32-10 block with counter (v, k)
    (csrc/summarize.cu::qv_mc_normals), up to the last-bit rounding of
    float32 log/sin/cos."""
    v = np.arange(offset, offset + n, dtype=np.uint64)
    k = np.arange((draws + 1) // 2, dtype=np.uint64)
    c = philox_block(seed, v[None, :], k[:, None])
    z = np.stack([box_muller(c[0], c[1]), box_muller(c[2], c[3])], 1)
    return z.reshape(-1, n, 2)[:draws]


def mc_normals(z, seed, offset: int, n: int, draws: int, device):
    """(draws, N, 2) normals for a plain version: host normals z (checked)
    or, for a seed, mc_philox_normals' replay of the kernel's draws of
    voxels offset.. offset+N-1."""
    if z is not None:
        if tuple(z.shape) != (draws, n, 2):
            raise ValueError(f"z must be ({draws}, {n}, 2), got "
                             f"{tuple(z.shape)}")
        return z
    if seed is None:
        raise ValueError("pass host normals z or a seed")
    return torch.from_numpy(mc_philox_normals(seed, n, draws,
                                              offset)).to(device)


# ---- kernel D --------------------------------------------------------------

def mc_posterior_summaries_plain(params, z, *, no_samples: int = 200,
                                 mvg: bool = True, oef_range: float = 0.8,
                                 min_oef: float = 0.04,
                                 dbv_range: float = 0.2,
                                 min_dbv: float = 0.001,
                                 dw_coeff: float = 1.0,
                                 antithetic: bool = True):
    """Plain version of kernel D: params (N, 4|5), z (mc_draws, N, 2) ->
    (means (N, 3), vars (N, 3)). With antithetic pairs each z is taken
    before its negation, as the kernel accumulates them."""
    _check_samples(no_samples)
    draws = mc_draws(no_samples, antithetic)
    if z.shape[0] != draws:
        raise ValueError(f"z holds {z.shape[0]} draws, the estimator "
                         f"needs {draws}")
    if _antithetic(no_samples, antithetic):
        z = torch.stack([z, -z], 1).reshape((2 * draws,) + z.shape[1:])
    dist = LogitMVN(oef_range, min_oef, dbv_range, min_dbv)
    return dist.posterior_means_streamed(z, params, mvg, dw_coeff)


def _summaries(wrapper, x, packed: bool, seed, z, offset, no_samples, mvg,
               ranges, antithetic):
    _check_samples(no_samples)
    if x.ndim != 2:
        raise ValueError(f"params must be 2-D, got {tuple(x.shape)}")
    k, n = x.shape if packed else x.shape[::-1]
    if packed and k != 5:
        raise ValueError(f"packed params must be (5, N), got {tuple(x.shape)}")
    if k not in (4, 5) or (mvg and k != 5):
        raise ValueError(f"params must be (N, 5) (MVG) or (N, 4|5), got "
                         f"{tuple(x.shape)}")
    draws = mc_draws(no_samples, antithetic)
    kw = dict(no_samples=no_samples, mvg=mvg, antithetic=antithetic,
              **ranges)
    if _device_of(x, "MC summaries") == "cpu":
        zz = mc_normals(z, seed, offset, n, draws, x.device)
        means, variances = mc_posterior_summaries_plain(
            x.T if packed else x, zz, **kw)
        return (means.T, variances.T) if packed else (means, variances)
    (x,) = _check_cuda("MC summaries", x)
    if z is not None:
        (z,) = _check_cuda("MC summaries", mc_normals(z, None, 0, n, draws,
                                                       x.device))
    elif seed is None:
        raise ValueError("pass host normals z or a seed")
    shape = (3, n) if packed else (n, 3)
    means = torch.empty(shape, device=x.device, dtype=torch.float32)
    variances = torch.empty_like(means)
    if n == 0:
        return means, variances
    # element strides (voxel, channel) of the input and the outputs
    p_vox, p_chan = (1, n) if packed else (k, 1)
    o_vox, o_chan = (1, n) if packed else (3, 1)
    with torch.cuda.device(x.device):
        err = _cuda.library().qv_mc_summaries(
            x.data_ptr(), n, p_vox, p_chan, int(mvg),
            _cuda.quad_ranges(**ranges),
            None if z is None else z.data_ptr(), int(offset),
            0 if seed is None else int(seed), draws,
            int(_antithetic(no_samples, antithetic)), 1.0 / float(no_samples),
            means.data_ptr(), variances.data_ptr(), o_vox, o_chan, _grid(n),
            _BLOCK, torch.cuda.current_stream(x.device).cuda_stream)
    _cuda.check(err, "MC summaries")
    wrapper.launches += 1
    return means, variances


def mc_posterior_summaries(params, seed=None, *, z=None, offset: int = 0,
                           no_samples: int = 200, mvg: bool = True,
                           oef_range: float = 0.8, min_oef: float = 0.04,
                           dbv_range: float = 0.2, min_dbv: float = 0.001,
                           dw_coeff: float = 1.0, antithetic: bool = True):
    """S-draw MC means/variances of (OEF, DBV, R2'): params (N, 4|5) raw
    heads, host normals z (mc_draws, N, 2) or a seed -> (means (N, 3),
    vars (N, 3)). CUDA: kernel D (counted in
    ``mc_posterior_summaries.launches``); CPU: the plain version."""
    ranges = dict(oef_range=oef_range, min_oef=min_oef, dbv_range=dbv_range,
                  min_dbv=min_dbv, dw_coeff=dw_coeff)
    return _summaries(mc_posterior_summaries, params, False, seed, z, offset,
                      no_samples, mvg, ranges, antithetic)


def mc_posterior_summaries_packed(params_t, seed=None, *, z=None,
                                  offset: int = 0, no_samples: int = 200,
                                  mvg: bool = True, oef_range: float = 0.8,
                                  min_oef: float = 0.04,
                                  dbv_range: float = 0.2,
                                  min_dbv: float = 0.001,
                                  dw_coeff: float = 1.0,
                                  antithetic: bool = True):
    """The channel-major entry: ``params_t (5, N)`` as kernel C writes it
    (row 4 zero for a diagonal head) -> (means_t (3, N), vars_t (3, N)).
    Same noise and estimator as ``mc_posterior_summaries``; counted in
    ``mc_posterior_summaries_packed.launches``."""
    ranges = dict(oef_range=oef_range, min_oef=min_oef, dbv_range=dbv_range,
                  min_dbv=min_dbv, dw_coeff=dw_coeff)
    return _summaries(mc_posterior_summaries_packed, params_t, True, seed, z,
                      offset, no_samples, mvg, ranges, antithetic)


# ---- kernel E --------------------------------------------------------------

def mc_kl_map_plain(q_params, p_params, z, mvg: bool = True):
    """Plain version of kernel E: the sampled KL(q || p) (N,) of
    ``LogitMVN.mvg_kl_samples`` over the draws z (S, N, 2), no gradient."""
    with torch.no_grad():
        return LogitMVN().mvg_kl_samples(z, q_params, p_params, mvg=mvg)


def mc_kl_map(q_params, p_params, seed=None, *, z=None, offset: int = 0,
              no_samples: int = 100, mvg: bool = True):
    """Per-voxel S-draw sampled KL(q || p): q, p (N, 4|5) raw heads, host
    normals z (S, N, 2) or a seed -> (N,). CUDA: kernel E (counted in
    ``mc_kl_map.launches``); CPU: the plain version. Gradient-free (the
    export path)."""
    _check_samples(no_samples)
    if q_params.ndim != 2 or q_params.shape != p_params.shape or \
            q_params.shape[1] != (5 if mvg else 4):
        raise ValueError(f"q and p must both be (N, {5 if mvg else 4}), got "
                         f"{tuple(q_params.shape)} and "
                         f"{tuple(p_params.shape)}")
    n = q_params.shape[0]
    if _device_of(q_params, "MC KL") == "cpu":
        zz = mc_normals(z, seed, offset, n, no_samples, q_params.device)
        return mc_kl_map_plain(q_params, p_params, zz, mvg)
    q, p = _check_cuda("MC KL", q_params, p_params)
    if z is not None:
        (z,) = _check_cuda("MC KL", mc_normals(z, None, 0, n, no_samples,
                                                q.device))
    elif seed is None:
        raise ValueError("pass host normals z or a seed")
    kl = torch.empty((n,), device=q.device, dtype=torch.float32)
    if n == 0:
        return kl
    with torch.cuda.device(q.device):
        err = _cuda.library().qv_mc_kl_map(
            q.data_ptr(), p.data_ptr(), n, int(mvg),
            None if z is None else z.data_ptr(), int(offset),
            0 if seed is None else int(seed), no_samples, KL_BOUND,
            kl.data_ptr(), _BLOCK,
            torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.check(err, "MC KL")
    mc_kl_map.launches += 1
    return kl


mc_posterior_summaries.launches = 0
mc_posterior_summaries_packed.launches = 0
mc_kl_map.launches = 0
