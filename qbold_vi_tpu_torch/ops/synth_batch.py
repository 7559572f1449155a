"""The streaming synthetic pretraining batch (kernel S).

No TPU kernel stands behind this one: the JAX package draws its streaming
batch with ``qbold_vi_tpu/train/steps.py::stream_synthetic_batch`` inside
the jitted step, where XLA fuses it. Its plain version in the port is
``train/steps.py::stream_synthetic_batch``, a chain of eager launches;
kernel S (``csrc/synth_batch.cu``) draws the population parameters,
misaligns them where configured, decodes every tau through the full SDR +
blood model and adds the SNR-profiled noise in two passes (the second for
the noise, which needs the batch-mean signal per tau: pass 1's last block
reduces it once, under a ticket the wrapper keeps a word a trial of, per
device and stream, at 0 between launches).

* ``synth_batch(cfg, batch_size, seed, device=...)`` -> {x (B, X, Y, Z, T),
  y (B, X, Y, Z, 3)}, or with ``seeds=[s_0, ..., s_{P-1}]`` a trial axis:
  x (P, B, X, Y, Z, T), y (P, B, X, Y, Z, 3), batch j the one of seed
  s_j (the population sweep's P trials a step). On the card kernel S,
  one launch of each pass for every trial (pass 1 counted in
  ``synth_batch.launches``, the noise pass in
  ``synth_batch.noise_launches``), trial j bit-equal to the one-trial
  launch under s_j; on the CPU the plain version fed
  ``synth_philox_draws`` -- the kernel's draws replayed on the host, each
  trial's stacked -- so one seed gives one batch on either device, up to
  float32 rounding.
  Kernel S decodes the full SDR model only: a configuration with
  ``train.full_model=False`` (the asymptotic tissue model) is routed by
  its config, before any launch, to the plain version on the card, fed
  the same replayed draws -- as a configuration kernel F leaves out is
  routed to kernel G. The JAX package decodes either model in its batch
  (qbold_vi_tpu/train/steps.py:410-415).
* ``synth_philox_draws(seed, n, n_taus)``: the Philox4x32-10 words of
  counters (voxel, k) under the seed, mapped as the kernel maps them
  (csrc/synth_batch.cu's header), in the draws layout of
  ``stream_synthetic_batch``; normals up to the last-bit rounding of
  float32 log/sin/cos (numpy's on the host against the card's).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..config import QBoldConfig
from . import _cuda, physics
from .decode_nll import DecodeConsts, decode_consts
from .fused_elbo import box_muller, philox_block

__all__ = ["synth_batch", "synth_philox_draws"]

SNR_RANGE = (50.0, 120.0)   # physics.add_acquisition_noise's defaults
_TICKETS: dict = {}          # (device, stream) -> pass 1's ticket words


def synth_consts(cfg: QBoldConfig) -> _cuda.QvSynthConsts:
    """The kernel's scalars, each rounded once to float32 as the plain
    version's Python floats meet its float32 tensors; the truncated
    normal's bounds (low - loc) / scale in double first, as
    synth.truncated_normal forms them."""
    s, scan = cfg.synth, cfg.scan
    return _cuda.QvSynthConsts(
        int(s.misalign_prob > 0.0), int(scan.simulate_noise),
        s.oef_start, s.oef_end, s.oef_mean, s.oef_std, s.dbv_start,
        s.dbv_end, s.dbv_mean, s.dbv_std,
        (s.dbv_start - s.dbv_mean) / s.dbv_std,
        (s.dbv_end - s.dbv_mean) / s.dbv_std, s.uniform_prop,
        s.misalign_prob, scan.dw_coeff * scan.hct, *SNR_RANGE)


@functools.lru_cache(maxsize=16)
def synth_decode_consts(cfg: QBoldConfig) -> DecodeConsts:
    """The decode constants of the batch: the model's scan and blood
    setting, with the quadrature rule that ``physics.ase_signal`` picks
    for the data path's OEF bound (synth.synth_oef_bound)."""
    from ..synth import synth_oef_bound

    rule = physics.select_quad_rule(cfg.scan, cfg.model.quad_rule,
                                    max_oef=synth_oef_bound(cfg.synth))
    c = decode_consts(cfg.model, cfg.scan, cfg.train.use_blood)
    return dataclasses.replace(c, cheb=rule == "cheb")


def _unit(w: np.ndarray) -> np.ndarray:
    """A word's top 24 bits as a float32 uniform on [0, 1)."""
    return (w >> np.uint64(8)).astype(np.float32) * np.float32(2.0 ** -24)


def synth_philox_draws(seed: int, n: int, n_taus: int) -> dict:
    """Kernel S's draws of voxels 0..n-1 under ``seed``, as numpy arrays in
    ``train.steps.stream_synthetic_batch``'s layout: "sel_o", "sel_d",
    "oef_u", "oef_n", "dbv_u", "dbv_n" (n,); "mis_u", "from_idx" (int64),
    "z_oef", "z_dbv", "snr_u" (n, 1); "z" (n, n_taus). Block k of voxel v
    is the Philox4x32-10 block with counter (v, k) (the layout of
    csrc/synth_batch.cu's header)."""
    v = np.arange(n, dtype=np.uint64)[None, :]
    n_blk = 3 + -(-n_taus // 4)
    c = philox_block(seed, v, np.arange(n_blk, dtype=np.uint64)[:, None])
    w = [[c[i][k] for i in range(4)] for k in range(n_blk)]
    bm1, bm2 = box_muller(w[1][0], w[1][1]), box_muller(w[2][0], w[2][1])
    span = np.uint64(max(n_taus - 5, 0))
    from_idx = 4 + (((w[2][2] >> np.uint64(8)) * span) >> np.uint64(24))
    z = np.concatenate([np.stack([box_muller(b[0], b[1]),
                                  box_muller(b[2], b[3])], 1).reshape(n, 4)
                        for b in w[3:]], 1)
    col = lambda a: a.reshape(n, 1)                           # noqa: E731
    return {"sel_o": _unit(w[0][0]), "sel_d": _unit(w[0][1]),
            "oef_u": _unit(w[0][2]), "dbv_u": _unit(w[0][3]),
            "oef_n": bm1[:, 0], "dbv_n": _unit(w[1][2]),
            "mis_u": col(_unit(w[1][3])), "z_oef": col(bm1[:, 1]),
            "z_dbv": col(bm2[:, 0]),
            "from_idx": col(from_idx.astype(np.int64)),
            "snr_u": col(_unit(w[2][3])),
            "z": np.ascontiguousarray(z[:, :n_taus])}


def _tickets(device: torch.device, stream: int, trials: int) -> torch.Tensor:
    """Pass 1's ticket words (a trial each) for launches on ``stream``:
    zeros when made, and each launch's last block leaves its word at 0, so
    launches ordered on one stream share them."""
    key = (device, stream)
    words = _TICKETS.get(key)
    if words is None or words.numel() < trials:
        words = torch.zeros(max(trials, 4), device=device, dtype=torch.int32)
        _TICKETS[key] = words
    return words


@functools.lru_cache(maxsize=None)
def _profile(n_taus: int, device: torch.device) -> torch.Tensor:
    """physics.norm_snr_profile (it reads only the tau count) on device."""
    return torch.from_numpy(physics.norm_snr_profile(
        np.zeros(n_taus, np.float32))).to(device)


def synth_batch(cfg: QBoldConfig, batch_size: int, seed: int = None, *,
                seeds=None, device=None, vol_shape=(10, 10, 5)) -> dict:
    """A fresh synthetic batch {x (B, *vol_shape, T), y (B, *vol_shape, 3)}
    drawn under ``seed`` on ``device`` (the CUDA card unless given another):
    kernel S on the card, the plain version on the CPU fed the kernel's
    replayed draws, and on the card too for the asymptotic tissue model
    (``train.full_model=False``), which kernel S does not decode. With
    ``seeds`` (a sequence of P seeds) and no ``seed``: P batches stacked on
    a leading trial axis, batch j drawn under seeds[j] -- one launch of
    each pass on the card."""
    device = torch.device("cuda" if device is None else device)
    if (seed is None) == (seeds is None):
        raise ValueError("synth_batch takes a seed or a sequence of seeds")
    trials = None if seeds is None else [int(s) for s in seeds]
    if trials is not None and not trials:
        raise ValueError("synth_batch needs at least one seed")
    scan = cfg.scan
    n = int(batch_size) * int(np.prod(vol_shape))
    shape = (int(batch_size),) + tuple(vol_shape)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no synthetic-batch kernel for device {device}")
    if device.type == "cpu" or not cfg.train.full_model:
        from ..train.steps import stream_synthetic_batch

        def plain(s):
            return stream_synthetic_batch(
                cfg, batch_size, synth_philox_draws(s, n, scan.n_taus),
                device=device, vol_shape=vol_shape)

        if trials is None:
            return plain(seed)
        parts = [plain(s) for s in trials]
        return {k: torch.stack([p[k] for p in parts]) for k in ("x", "y")}
    p_n = 1 if trials is None else len(trials)
    lead = () if trials is None else (p_n,)
    C = synth_decode_consts(cfg)
    table = C.device_table(device)
    x = torch.empty(lead + shape + (scan.n_taus,), device=device,
                    dtype=torch.float32)
    y = torch.empty(lead + shape + (3,), device=device, dtype=torch.float32)
    if n == 0:
        return {"x": x, "y": y}
    lib = _cuda.library()
    # each block's per-tau sums, then the trial's mean in the last row
    partial = torch.empty((p_n, lib.qv_synth_grid(n) + 1, scan.n_taus),
                          device=device, dtype=torch.float64)
    prof = _profile(scan.n_taus, device)
    consts = synth_consts(cfg)
    stream = torch.cuda.current_stream(device).cuda_stream
    tickets = _tickets(device, stream, p_n)
    with torch.cuda.device(device):
        if trials is None:
            err = lib.qv_synth_batch(
                n, C.struct(), table.data_ptr(), table.numel(), consts,
                int(seed) & 0xFFFFFFFFFFFFFFFF, x.data_ptr(), y.data_ptr(),
                partial.data_ptr(), tickets.data_ptr(), prof.data_ptr(),
                stream)
        else:
            # the seeds as uint64 words, through int64's bits
            words = np.array([s & 0xFFFFFFFFFFFFFFFF for s in trials],
                             np.uint64).view(np.int64)
            keys = torch.from_numpy(words).to(device)
            err = lib.qv_synth_batch_trials(
                n, p_n, C.struct(), table.data_ptr(), table.numel(), consts,
                keys.data_ptr(), x.data_ptr(), y.data_ptr(),
                partial.data_ptr(), tickets.data_ptr(), prof.data_ptr(),
                stream)
    _cuda.check(err, "synthetic batch")
    synth_batch.launches += 1
    synth_batch.noise_launches += int(bool(consts.noise))
    return {"x": x, "y": y}


synth_batch.launches = 0
synth_batch.noise_launches = 0
