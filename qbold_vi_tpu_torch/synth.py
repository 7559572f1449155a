"""Synthetic qBOLD training data (pretraining).

The port's copy of ``qbold_vi_tpu/synth.py`` (reference signals.py:251-300),
which it cannot import:

* ``create_synthetic_dataset_host``: the fixed synthetic set of host-fed
  pretraining. All its randomness is numpy -- the OEF/DBV mixture (with
  ``scipy.special.ndtri`` for the truncated normal), the meshgrid cross
  product, the permutation, misalignment and acquisition noise -- so with
  the same integer seed it draws the very numbers the JAX function draws;
  the signals are decoded by ``ops.physics.ase_signal`` on the given
  device and come back as numpy.
* ``pretrain_data_seed``: that integer seed as the JAX trainer derives it,
  the last word of ``jax.random.fold_in(PRNGKey(seed), 0x5EED)``
  (qbold_vi_tpu/train/trainer.py:421-422), by Threefry-2x32 in plain
  integers.
* ``truncated_normal``, ``sample_population_params``,
  ``sample_batch_params``: the samplers of the on-device paths, taking
  their uniform and normal draws as arguments (``jax.random.uniform``'s
  [0, 1) floats, ``jax.random.normal``'s normals), so a test can feed them
  the JAX key's draws.
* ``synth_oef_bound``: the OEF bound the data path can reach.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .config import ScanParams, SynthParams
from .ops import physics

__all__ = ["pretrain_data_seed", "threefry_fold_in", "truncated_normal",
           "sample_population_params", "sample_batch_params",
           "synth_oef_bound", "create_synthetic_dataset_host"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(key: tuple, x: tuple) -> tuple:
    """Threefry-2x32 (20 rounds) of the counter words x under key, as
    jax.random's default generator computes it."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x0, x1 = (x[0] + ks[0]) & _M32, (x[1] + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def threefry_fold_in(key: tuple, data: int) -> tuple:
    """jax.random.fold_in on a raw (2,) uint32 key, as two Python ints."""
    return _threefry2x32(key, (0, int(data) & _M32))


def pretrain_data_seed(seed: int) -> int:
    """The integer seed of the JAX trainer's fixed synthetic set: the last
    word of fold_in(PRNGKey(seed), 0x5EED); PRNGKey(s) is (s >> 32, s)."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return threefry_fold_in(((s >> 32) & _M32, s & _M32), 0x5EED)[1]


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def truncated_normal(u: torch.Tensor, loc: float, scale: float, low: float,
                     high: float) -> torch.Tensor:
    """N(loc, scale) conditioned on [low, high] from [0, 1) uniforms u, as
    jax.random.truncated_normal maps its uniforms: sqrt(2) erfinv of a
    uniform on [erf(a / sqrt 2), erf(b / sqrt 2)), clipped to the open
    interval (a, b) (reference signals.py:265-267)."""
    dev = u.device
    a, b = _f32((low - loc) / scale, dev), _f32((high - loc) / scale, dev)
    sqrt2 = _f32(math.sqrt(2.0), dev)
    v = physics.uniform_map(u, torch.erf(a / sqrt2), torch.erf(b / sqrt2))
    z = sqrt2 * torch.erfinv(v)
    z = torch.clamp(z, torch.nextafter(a, _f32(math.inf, dev)),
                    torch.nextafter(b, _f32(-math.inf, dev)))
    return z * scale + loc


def sample_population_params(synth: SynthParams, draws: dict):
    """The 1-D OEF and DBV population samples (signals.py:255-268): a
    ``uniform_prop`` share uniform on the range, the rest clipped N(mean,
    std) for OEF and truncated N(mean, std) for DBV. ``draws``: [0, 1)
    uniforms "oef_u", "dbv_u" (n_uni,) and "dbv_n" (n_norm,), normals
    "oef_n" (n_norm,), n_uni = round(sample_size * uniform_prop). Returns
    (oefs, dbvs), each (sample_size,)."""
    s = synth
    oef_u = physics.uniform_map(draws["oef_u"], s.oef_start, s.oef_end)
    oef_n = torch.clamp(draws["oef_n"] * s.oef_std + s.oef_mean, s.oef_start,
                        s.oef_end)
    dbv_u = physics.uniform_map(draws["dbv_u"], s.dbv_start, s.dbv_end)
    dbv_n = truncated_normal(draws["dbv_n"], s.dbv_mean, s.dbv_std,
                             s.dbv_start, s.dbv_end)
    return torch.cat([oef_u, oef_n]), torch.cat([dbv_u, dbv_n])


def sample_batch_params(synth: SynthParams, draws: dict):
    """n iid (OEF, DBV) pairs from the population mixture, each element
    choosing its component by its own uniform. ``draws``, each (n,): [0, 1)
    uniforms "sel_o", "sel_d", "oef_u", "dbv_u", "dbv_n" and normals
    "oef_n". Returns (oef, dbv)."""
    s = synth
    oef_u = physics.uniform_map(draws["oef_u"], s.oef_start, s.oef_end)
    oef_n = torch.clamp(draws["oef_n"] * s.oef_std + s.oef_mean, s.oef_start,
                        s.oef_end)
    oef = torch.where(draws["sel_o"] < s.uniform_prop, oef_u, oef_n)
    dbv_u = physics.uniform_map(draws["dbv_u"], s.dbv_start, s.dbv_end)
    dbv_n = truncated_normal(draws["dbv_n"], s.dbv_mean, s.dbv_std,
                             s.dbv_start, s.dbv_end)
    dbv = torch.where(draws["sel_d"] < s.uniform_prop, dbv_u, dbv_n)
    return oef, dbv


def synth_oef_bound(synth: SynthParams) -> float:
    """The largest OEF the synthetic data path can decode: the samplers'
    oef_end, or the misalignment's own clip when it is on."""
    hi = float(synth.oef_end)
    if synth.misalign_prob > 0.0:
        hi = max(hi, physics.MISALIGN_OEF_CLIP[1])
    return hi


def create_synthetic_dataset_host(seed: int, scan: ScanParams,
                                  synth: SynthParams, *,
                                  full_model: bool = True,
                                  use_blood: bool = True,
                                  quad_rule: str = "auto", device=None):
    """(x (N, n_taus), y (N, 3)) float32 numpy, N = sample_size ** 2: the
    meshgrid cross product of the OEF and DBV population samples in a
    random order, y = (oef, dbv, r2') before misalignment, x the decoded
    signals (misaligned and noisy where configured). ``seed`` is the
    integer the numpy generator starts from (``pretrain_data_seed`` of the
    config seed in the trainer); the decode runs on ``device``: the CUDA
    card unless the caller asks for another (``device="cpu"``)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "create_synthetic_dataset_host decodes on the CUDA card unless "
            "asked otherwise, and no CUDA device is available: pass "
            "device='cpu'")
    rng = np.random.default_rng(int(seed))
    n = synth.sample_size

    def mixture(lo, hi, mean, std, truncated):
        n_uni = round(n * synth.uniform_prop)
        n_norm = n - n_uni
        uni = rng.uniform(lo, hi, size=n_uni)
        if truncated:
            import scipy.special as sps
            a, b = (lo - mean) / std, (hi - mean) / std
            u = rng.uniform(sps.ndtr(a), sps.ndtr(b), size=n_norm)
            norm = sps.ndtri(u) * std + mean
        else:
            norm = np.clip(rng.normal(mean, std, size=n_norm), lo, hi)
        return np.concatenate([uni, norm]).astype(np.float32)

    oefs = mixture(synth.oef_start, synth.oef_end, synth.oef_mean,
                   synth.oef_std, truncated=False)
    dbvs = mixture(synth.dbv_start, synth.dbv_end, synth.dbv_mean,
                   synth.dbv_std, truncated=True)
    oef, dbv = [a.reshape(-1) for a in np.meshgrid(oefs, dbvs,
                                                   indexing="ij")]
    perm = rng.permutation(oef.shape[0])
    oef, dbv = oef[perm], dbv[perm]
    r2p = scan.dw_coeff * scan.hct * oef * dbv
    y = np.stack([oef, dbv, r2p], -1).astype(np.float32)

    sig_oef, sig_dbv = oef, dbv
    per_tau = synth.misalign_prob > 0.0
    if per_tau:
        # the numpy form of physics.misalign_params, in the JAX host
        # function's draw order
        n_vox = oef.shape[0]
        mis = rng.uniform(size=(n_vox, 1)) < synth.misalign_prob
        from_idx = rng.integers(4, scan.n_taus - 1, size=(n_vox, 1))
        m = np.logical_and(np.arange(scan.n_taus)[None, :] > from_idx, mis)
        mis_oef = np.clip(rng.normal(size=(n_vox, 1)) * 0.15 + oef[:, None],
                          *physics.MISALIGN_OEF_CLIP)
        mis_dbv = np.clip(rng.normal(size=(n_vox, 1)) * 0.05 + dbv[:, None],
                          0.002, 0.3)
        sig_oef = np.where(m, mis_oef, oef[:, None]).astype(np.float32)
        sig_dbv = np.where(m, mis_dbv, dbv[:, None]).astype(np.float32)

    with torch.no_grad():
        x = physics.ase_signal(
            torch.from_numpy(np.ascontiguousarray(sig_oef)).to(device),
            torch.from_numpy(np.ascontiguousarray(sig_dbv)).to(device), scan,
            full_model=full_model, include_blood=use_blood,
            per_tau_params=per_tau, quad_rule=quad_rule,
            max_oef=synth_oef_bound(synth)).cpu().numpy()
    if scan.simulate_noise:
        prof = physics.norm_snr_profile(scan.taus())
        snr = rng.uniform(50.0, 120.0, size=(x.shape[0], 1)) * prof[None, :]
        std = x.mean(0, keepdims=True) / snr
        x = (x + rng.normal(size=x.shape) * std).astype(np.float32)
    return x, y
