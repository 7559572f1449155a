"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--weights params.npz]

Drives the port's main paths at the published OPTIMAL width (60 units x
2 blocks, 11 taus, MVG head), with random weights from a fixed seed or a
converted JAX checkpoint: serving by quadrature (``infer.save_predictions``,
kernels A and B), serving by sampling and the fine-tuned export
(``save_predictions(method="mc")`` and ``(fine_tuned=True, priors=...)``,
kernels C, D and E), ELBO fine-tuning (``train.trainer.Trainer``, kernels
F and G, forward and backward), and the two-phase pipeline from scratch
(``Trainer.pretrain`` -> ``finetune`` with the 3x3 convs through kernel H,
forward and backward), and checks them:

1. device: a CUDA card is required (otherwise exit 1, no result line);
2. build: the kernels of all six sources in csrc/ are compiled by nvcc;
3. kernel vs plain: A and B against their plain torch versions on the
   card at 1,032,192 and 1,000,003 voxels (tolerances in CHECKS);
4. main path: three export requests per encoder stream, with the launch
   counters reset before and read after; maps must be finite, in range,
   written to NIfTI and read back equal, and the smallest request must
   agree with the plain versions run on the CPU;
5. timings: each kernel's device time (the median launch in a profiler
   trace of 21 calls), its wrapper's and its plain version's time a call
   (CUDA events, warm-up, median of 7 blocks), and the host wall of
   posterior_maps on the 1.03 M-voxel request;
6. F and G against their plain versions at the fine-tune shapes: F at
   190,000 voxels (38 crops of 25 x 25 x 8 through the encoder; MVG,
   s_nll 1, s_kl 70, host noise) and at a ragged 190,003 (diagonal; and
   Student-t df 2 + multi-image normalisation + s_nll 2), G at 190,000;
   rows at rtol 1e-5 / atol 1e-5, gradients scale-normalised at rtol
   5e-4 / atol 5e-5;
7. F's device noise: the Philox draws are philox_normals' (rows against
   the plain version fed them, rtol 1e-4: numpy's log/sin/cos on the host
   against the card's), a seed replays rows and gradients bit for bit,
   another seed differs, and the mean over masked voxels of kl_rows -
   mvg_kl_closed_form lies within 5 standard errors of 0;
8. the training main path: Trainer.prepare_real + Trainer.finetune, 2
   epochs x 100 steps at batch 38 with device noise, on 6 x 96 x 96 x 8
   volumes from seed 0 (F forward and backward launched once per step),
   then a 10-step epoch with fused_elbo="off" (G launched), then one
   step on the card against the same step on the CPU plain path;
9. timings: F and G forward and backward against their plain versions,
   one fine-tune step, and the wall of one 100-step epoch;
10. C against its plain version at 1,032,192 and 1,000,003 voxels (both
   layouts, mask channel); D (both layouts, MVG and diagonal, antithetic
   and iid, S = 200) and E (S = 100) against their plain versions fed
   philox_normals at 65,536 and 65,537 voxels (means and KL rows at
   rtol 1e-4, variances as CHECKS); a seed replays bit for bit, another
   differs, and a request cut at a voxel offset draws what the whole
   one does;
11. statistics: D's means at 1,032,192 voxels within 8 standard errors
   of kernel A's quadrature means, and the mean of E - mvg_kl_closed_form
   over live voxels within 5 standard errors of 0;
12. the sampled main paths: save_predictions(method="mc") on the three
   requests per stream (C and D launched on stream 1, D on stream 2),
   and save_predictions(fine_tuned=True, priors=predict_priors(...)) on
   6 x 96 x 96 x 8 (E launched once per subject); maps finite, in
   range, read back equal from NIfTI; the smallest request against the
   CPU plain path fed the same Philox draws, and at chunk 1 against
   chunk 2; elbo_maps on the card against the CPU given the same normals;
13. timings: C, D and E against their plain versions, the MC
   posterior_maps wall per stream and the elbo_maps wall per subject;
14. kernel H (the 3x3 trunk conv; forward, dx, dw and db) against its
   plain version and against cuDNN (TF32 off) at the fine-tune fold
   (304, 25, 25, 60 -> 60), a serving chunk (16, 96, 96), prepare_real's
   chunk (32, 62, 76) and two ragged planes: the output and dx within 1e-5
   of their largest magnitude, dw and db within 1e-4 of theirs; dw and db
   replay bit for bit; a non-contiguous input is refused; H's, the plain
   version's and cuDNN's largest errors against a float64 conv at the
   fold; the device times of H, its plain version and cuDNN at the three
   main shapes, beside the 3xTF32 tensor-core and CUDA-core bounds;
15. the two-phase path, OPTIMAL with fused_conv="on": Trainer.pretrain
   for 2 epochs at full data size (6.25 M synthetic voxels, 21 steps of
   512 pseudo-volumes an epoch; no kernel H, stream 1 only), and one
   pretrain step on the card against the CPU;
16. then Trainer.finetune (prepare_real + 2 x 100 steps) through kernels H
   and F, launches asserted (4 H forward and backward a step, 4 forward a
   prepare_real chunk, F once a step), and one step through H against
   the same step through cuDNN;
17. stream-2 save_predictions on the three requests under fused_conv="on"
   (4 H launches a chunk), maps against cuDNN's at the map tolerances;
18. timings: the stream-2 posterior_maps wall under "on" and "off", the
   pretrain step, the fine-tune step both ways, the epoch under "on".

It also traces posterior_maps (each stream and estimator), elbo_maps,
the fine-tune step (both conv routes) and the pretrain step with
torch.profiler: device time by kernel and the device's busy share of the
wall.

Prints the card's name and power limit, one JSON line with the kernel
table (launches, max_abs_err, ms, plain_ms, bound_ms, bound_by,
library_ms), and as its last line {"ok": true, "device": {...}}. Any
failure exits non-zero before that line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_FULL = 14 * 96 * 96 * 8            # 1,032,192 voxels
N_RAGGED = 1_000_003
REQUESTS = ((14, 96, 96, 8), (6, 96, 96, 8), (3, 64, 64, 8))
# kernel vs plain on the card: means, raw and q at rtol 1e-4 / atol 3e-5,
# variances at rtol 1e-3 / atol 3e-5 (E[x^2] - E[x]^2 cancels); the R2'
# variance (dw ~ 300) with an absolute floor of 16 float32 ulps of its
# second moment, where that cancellation lives.
CHECKS = dict(mean=(1e-4, 3e-5), var=(1e-3, 3e-5), raw=(1e-4, 3e-5))
EPS32 = float(np.finfo(np.float32).eps)
FT_SHAPE = (38, 25, 25, 8)           # one fine-tune batch: 190,000 voxels
N_FT = 38 * 25 * 25 * 8
N_FT_RAGGED = 190_003
TRAIN_VOLUMES = (6, 96, 96, 8)       # subjects x X x Y x Z, + a mask channel
N_MC = 65_536                        # D and E against philox_normals
N_SUBJ = 96 * 96 * 8                 # one subject: the ELBO export's chunk
S_MC, S_KL = 200, 100                # the sampled summaries' and KL's draws
ROW_TOL = (1e-5, 1e-5)
GRAD_TOL = (5e-4, 5e-5)
# the card's peaks (NVIDIA H100 SXM data sheet): float32 outside the
# tensor cores, dense TF32 on the tensor cores, and HBM3 bandwidth
PEAK_FLOPS = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line(fields: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def log_clocks(when: str) -> None:
    """The card's SM clock (and its maximum), power draw and temperature,
    beside a timing window."""
    log(f"clocks {when}: " + gpu_line(
        "clocks.sm,clocks.max.sm,power.draw,temperature.gpu"))


def check_close(name, got, ref, kind, mean_ref=None) -> float:
    """Raise unless got ~ ref (channel-last (N, 3) arrays); returns the
    largest absolute difference."""
    rtol, atol = CHECKS[kind]
    got, ref = got.double(), ref.double()
    err = (got - ref).abs()
    bound = atol + rtol * ref.abs()
    if kind == "var":
        second = ref[:, 2] + mean_ref.double()[:, 2] ** 2
        bound[:, 2] = rtol * ref[:, 2].abs() + torch.clamp(
            16 * EPS32 * second, min=atol)
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    excess = (err - bound).max().item()
    if excess > 0:
        raise AssertionError(f"{name}: {kind} differs from the plain "
                             f"version by {err.max().item():.3e} (excess "
                             f"{excess:.3e} over rtol {rtol} atol {atol})")
    return err.max().item()


def check_rows(name, got, ref, rtol=ROW_TOL[0], atol=ROW_TOL[1]) -> float:
    """Raise unless got ~ ref elementwise; returns the largest absolute
    difference."""
    got, ref = got.double(), ref.double()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got - ref).abs()
    excess = (err - (atol + rtol * ref.abs())).max().item()
    if excess > 0:
        raise AssertionError(f"{name}: differs from the plain version by "
                             f"{err.max().item():.3e} (excess {excess:.3e} "
                             f"over rtol {rtol} atol {atol})")
    return err.max().item()


def check_grad(name, got, ref) -> float:
    """Gradients, scale-normalised by the reference's largest entry, at
    GRAD_TOL; returns the largest absolute (unscaled) difference."""
    scale = ref.double().abs().max().clamp(min=1e-8)
    check_rows(name, got.double() / scale, ref.double() / scale,
               *GRAD_TOL)
    return (got.double() - ref.double()).abs().max().item()


def raw_head(rng, n):
    q = rng.normal(size=(n, 5)).astype(np.float32)
    q[:, [0, 2]] *= 3.0
    q[:, [1, 3]] *= 1.5             # logit stds straddle the s = 1.5 split
    return q


def cuda_ms(fn, reps: int = 10, blocks: int = 7) -> float:
    """Median over blocks of the mean per-call time, by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(blocks):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def kernel_ms(fn, symbol: str, calls: int = 21, need: int | None = None,
              tries: int = 3) -> float:
    """Median device duration of the launches of the kernel ``symbol``
    over ``calls`` calls of fn, from the profiler's CUDA activity: the
    kernel alone. CUDA events around a loop of calls also count the gaps
    where the host has not yet queued the next launch, which a kernel
    shorter than its wrapper's host work (G's ~0.04 ms) cannot hide. A
    trace can drop launch records (on the H100: one of 21 once, most of
    kernel H's 2 us weight split, once all 21 of a dx pass): a trace with
    fewer than ``need`` (half the calls) is taken again, up to ``tries``
    times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    need = calls // 2 if need is None else need
    for _ in range(tries):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                 if e.device_type == DeviceType.CUDA and symbol in e.name]
        if len(spans) >= need:
            return statistics.median(spans)
        log(f"{symbol}: {len(spans)} launches traced in {calls} calls; "
            "tracing again")
    raise AssertionError(f"{symbol}: fewer than {need} launches traced in "
                         f"{calls} calls, {tries} times")


def time_kernel(fn, symbol: str, plain) -> tuple:
    """(the kernel's device ms, the wrapper's ms a call by CUDA events,
    the plain version's ms a call by CUDA events)."""
    return kernel_ms(fn, symbol), cuda_ms(fn), cuda_ms(plain, reps=2)


def log_times(times: dict, n: int, card: str) -> None:
    for k, (ms, call, plain) in times.items():
        log(f"{k}: kernel {ms:.4f} ms on the device ({call:.4f} ms a call by "
            f"CUDA events), plain {plain:.4f} ms at N={n} [{card}]")


def wall_ms(fn, blocks: int = 7) -> float:
    fn()
    times = []
    for _ in range(blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile(fn, n: int, label: str, card: str) -> None:
    """torch.profiler over n calls of fn (after one warm-up): the device
    time of the kernels by name, and the device's busy share of the wall
    (the union of the kernels' intervals over the host wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict = {}
    spans = []
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
        spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, None
    for s, t in sorted(spans):
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    busy /= 1e3
    total = sum(t for t, _ in by_name.values())
    log(f"profile of {label} x {n}: wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms ({100.0 * busy / wall:.1f}% of the wall), kernel "
        f"time {total:.3f} ms in {len(kernels)} launches [{card}]")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"  {t / n:9.4f} ms/call {c // n:5d} launches/call  {name[:90]}")


def check_maps(maps: dict, shape: tuple, prefix: str) -> None:
    """Raise unless the exported maps have their shapes, are finite and in
    range, and read back equal from their NIfTI files (subjects folded
    into the last axis)."""
    from qbold_vi_tpu_torch.io import nifti

    want = {"oef": 1, "dbv": 1, "r2p": 1, "stds": 3, "raw_log_stds": 3,
            "likelihood": 1, "kl": 1, "residual": 1}
    files = {"stds": "_logstds", "raw_log_stds": "_raw_logstds"}
    for key, m in maps.items():
        if m.shape != shape + (want[key],):
            raise AssertionError(f"{key} shape {m.shape}")
        if not np.isfinite(m).all():
            raise AssertionError(f"{key} not finite")
        back = nifti.load_nifti(prefix + files.get(key, "_" + key)
                                + ".nii.gz")
        if not np.array_equal(back, np.concatenate(np.split(m, shape[0], 0),
                                                   -1)[0]):
            raise AssertionError(f"{key}: NIfTI read-back differs")
    if not (0.04 <= maps["oef"].min() and maps["oef"].max() <= 0.84):
        raise AssertionError("OEF outside [0.04, 0.84]")
    if not (0.001 <= maps["dbv"].min() and maps["dbv"].max() <= 0.201):
        raise AssertionError("DBV outside [0.001, 0.201]")
    if maps["stds"].min() < 0 or maps.get("residual", maps["stds"]).min() < 0:
        raise AssertionError("negative posterior variance or residual")


def volumes(rng, shape, n_taus):
    data = (np.abs(rng.normal(size=shape + (n_taus + 1,)))
            .astype(np.float32) * 50.0 + 100.0)
    data[..., -1] = rng.uniform(size=shape) > 0.2
    return data


# ---- bounds -----------------------------------------------------------------
# Float32 operations per unit of work, counted from csrc/: an add, multiply,
# divide, min/max or one exp/log/tanh/sqrt/sin/cos counts 1, an FMA 2 (as
# the 67 TFLOP/s peak counts it). The Philox rounds are integer work and
# are not counted, so each bound stays a lower bound.
OPS = dict(
    # quad_math.cuh, per voxel and 1-D moment routine: 16 Gauss-Hermite
    # nodes below the s = 1.5 split, 16 Gauss-Laguerre nodes + the exact
    # step at or above it; the rest of the summaries
    omom=(25 * 16, 49 * 16 + 47), mom=(10 * 16, 19 * 16 + 25),
    gmom=(17 * 16, 31 * 16 + 31), quad_fixed=114,
    # encode_quad.cu, per tau: clip, divide by the reference, log
    normalise=4,
    # elbo_math.cuh, per tau: the Clenshaw sums of the 21-term surrogate
    # and of its 20-term derivative, the rest of the signal, the Gaussian
    # NLL term (Student-t: 3 more), the rest of the backward's chain
    clen_i=64, clen_d=61, signal=18, nll_tau=9, grad_tau=50,
    # per draw: reparameterised sample and two sigmoids; one reduced-KL
    # draw forward / backward; one Box-Muller pair
    draw=18, kl_fwd=28, kl_bwd=52, box_muller=12,
    # per voxel: unpacking q and p (the backward with its tanh chain
    # factors), and the KL / gradient tails
    unpack=22, unpack_bwd=42, tail=40,
    # summarize.cu, kernel D: one sample's transform to (OEF, DBV, R2')
    # and its six sums, the negation of an antithetic pair, the means and
    # variances; kernel E: the hoisted whitening factors of q and p
    mc_draw=27, negate=2, mc_tail=15, whiten=14)


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: bytes over the HBM rate or
    operations over the float32 peak, whichever is larger."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def squashed(q: torch.Tensor, mvg: bool) -> torch.Tensor:
    """(3, N) (ls0, ls1, od) of raw head rows q (N, 5|4)."""
    q = q.double()
    od = (torch.tanh(q[:, 4]) * np.exp(-2.0) if mvg
          else torch.zeros_like(q[:, 0]))
    return torch.stack([torch.tanh(q[:, 1]) * 3.0 - 1.0,
                        torch.tanh(q[:, 3]) * 3.0 - 1.0, od])


def ops_quad(raw: torch.Tensor, mvg: bool) -> float:
    """Operations of the quadrature summaries of squashed rows raw (3, N):
    each 1-D moment routine takes its branch by its own std."""
    ls0, ls1, od = raw.double()
    s0, s1 = ls0.exp(), ls1.exp()
    sm1 = (od * od + s1 * s1).sqrt() if mvg else s1
    n = ls0.numel()
    total = OPS["quad_fixed"] * n
    for key, s in (("omom", s0), ("mom", sm1), ("gmom", s1)):
        gl = int((s >= 1.5).sum())
        total += OPS[key][0] * (n - gl) + OPS[key][1] * gl
    return float(total)


def ops_encode(units: int, n_taus: int, n_blocks: int) -> int:
    """Kernel C, per voxel: normalisation and the dense chain T -> U ->
    nb x (U -> U) -> 5 (FMAs, biases, activations)."""
    u, t = units, n_taus
    return (2 * u * t + 2 * u + n_blocks * (2 * u * u + 2 * u) + 2 * u * 5
            + 5 + OPS["normalise"] * t)


def ops_encode_quad(units: int, n_taus: int, n_blocks: int,
                    raw: torch.Tensor, mvg: bool) -> float:
    """Kernel B: kernel C's encode, then the quadrature of its rows."""
    return (raw.shape[1] * ops_encode(units, n_taus, n_blocks)
            + ops_quad(raw, mvg))


def ops_mc_summaries(no_samples: int, antithetic: bool) -> int:
    """Kernel D, per voxel: S/2 Box-Muller pairs each taken as (z, -z), or
    S iid draws."""
    if antithetic:
        pair = OPS["box_muller"] + OPS["negate"] + 2 * OPS["mc_draw"]
        draws = (no_samples // 2) * pair
    else:
        draws = no_samples * (OPS["box_muller"] + OPS["mc_draw"])
    return OPS["unpack"] // 2 + draws + OPS["mc_tail"]


def ops_mc_kl(no_samples: int) -> int:
    """Kernel E, per voxel: S reduced-KL draws of q against p."""
    return (OPS["unpack"] + OPS["whiten"]
            + no_samples * (OPS["box_muller"] + OPS["kl_fwd"]) + 5)


def ops_decode(t: int, student: bool, grads: bool) -> int:
    """One draw's decode + NLL row over t taus (or its closed-form
    gradients) on the Chebyshev surrogate."""
    per_tau = OPS["clen_i"] + OPS["signal"] + OPS["nll_tau"] + 3 * student
    if grads:
        per_tau += OPS["clen_d"] + OPS["grad_tau"]
    return t * per_tau


def bound_elbo(n, live, k, t, s_nll, s_kl, student, device_noise,
               backward) -> dict:
    """Kernel F (MVG): q, p (n, k), y, sigma (n, t) and the mask read once
    (+ the cotangents and the written gradients for the backward, + the
    normals in host-noise mode); the operations of the live voxels'
    s_nll decodes and s_kl reduced-KL draws."""
    floats = 2 * k + 2 * t + 1 + 2 + (2 * k + 2 * t if backward else 0)
    noise = 0 if device_noise else 2 * (s_nll + s_kl)
    draws = OPS["box_muller"] * (s_nll + s_kl) if device_noise else 0
    per = (OPS["unpack_bwd" if backward else "unpack"]
           + s_nll * (OPS["draw"] + ops_decode(t, student, backward))
           + s_kl * OPS["kl_bwd" if backward else "kl_fwd"] + draws
           + OPS["tail"])
    return bound(4 * n * (floats + noise), live * per)


def bound_decode(n, live, t, student, backward) -> dict:
    """Kernel G: oef, dbv, the mask, y and sigma read once (+ the
    cotangent; rows or the four gradients written)."""
    floats = (2 * t + 4) + (2 * t + 2 if backward else 0)
    return bound(4 * n * floats, live * ops_decode(t, student, backward))


def stepped(tuner, metrics) -> tuple:
    """(loss, parameters, gradients) of a tuner after one train step, in
    float64 on the host."""
    return (float(metrics["loss"]),
            {k: p.detach().cpu().double() for k, p in tuner.named_parameters()},
            {k: p.grad.cpu().double() for k, p in tuner.named_parameters()
             if p.grad is not None})


def check_step(label, got, ref, before, lr) -> float:
    """Raise unless one step from the weights ``before`` agrees between two
    runs (``stepped`` triples): the loss at rtol 1e-5, the gradients
    within 1e-2 of their scale, the updates as below. Returns the largest
    gradient difference over its scale."""
    (loss_c, after_c, grad_c), (loss_r, after_r, grad_r) = got, ref
    if not abs(loss_c - loss_r) <= 1e-5 * abs(loss_r):
        raise AssertionError(f"{label}: loss {loss_c} vs {loss_r}")
    worst_grad = 0.0
    for k, g_r in grad_r.items():
        # relu kinks: a pre-activation within float32 rounding of 0 may
        # take the other side on the card, moving a conv gradient by
        # ~1e-4 of its scale; a wrong gradient moves it by O(1)
        scale = float(g_r.abs().max()) + 1e-30
        worst_grad = max(worst_grad,
                         float((grad_c[k] - g_r).abs().max()) / scale)
        # Adam's first update is lr * g / (|g| + 1e-7): held tight where g
        # is clear of zero and of eps (a last-bit or kink difference in g
        # then barely moves it), and to the step's own bound elsewhere
        before_k = before[k].cpu().double()
        d_c, d_r = after_c[k] - before_k, after_r[k] - before_k
        e = (d_c - d_r).abs()
        clear = g_r.abs() > max(1e-2 * scale, 1e-4)
        if not (bool((e[clear] <= 1e-6 + 1e-4 * d_r[clear].abs()).all())
                and float(e.max()) <= 2.0 * lr):
            raise AssertionError(
                f"{label}: update of {k} differs by {float(e.max()):.3e} "
                f"(gradient scale {scale:.3e})")
    if worst_grad > 1e-2:
        raise AssertionError(f"{label}: gradients differ by {worst_grad:.3e}"
                             " of their scale")
    return worst_grad


def ft_rows(tuner, rng, dev, n_taus) -> dict:
    """One fine-tune batch (38 crops of 25 x 25 x 8) through the encoder,
    as (N, .) rows: q the raw posterior head, sigma, the masked images y
    and the mask; p the head of a second batch (the priors of the real
    path are encoder outputs too)."""
    rows = {}
    with torch.no_grad():
        for key in ("q", "p"):
            vol = torch.from_numpy(volumes(rng, FT_SHAPE, n_taus)).to(dev)
            mask = vol[..., -1:]
            images = vol[..., :-1] * mask
            _, q, sigma = tuner.encode(images)
            rows[key] = q.reshape(N_FT, -1).contiguous()
            if key == "q":
                rows.update(y=images.reshape(N_FT, n_taus),
                            sigma=sigma.reshape(N_FT, n_taus).contiguous(),
                            mask=mask.reshape(N_FT))
    return rows


def fine_tune_phases(dev, card, cfg, tuner) -> dict:
    """Phases 6-9: kernels F and G against their plain versions, F's
    device noise, the training main path, and the timings. Returns the
    kernels' JSON entries and the step and epoch walls."""
    from qbold_vi_tpu_torch.dist.logit_mvn import LogitMVN
    from qbold_vi_tpu_torch.models.vi import FineTuner
    from qbold_vi_tpu_torch.ops import decode_nll as dn
    from qbold_vi_tpu_torch.ops import fused_elbo as fe
    from qbold_vi_tpu_torch.train import optim, steps
    from qbold_vi_tpu_torch.train.trainer import Trainer

    mcfg, scan = cfg.model, cfg.scan
    t_n, s_nll, s_kl = scan.n_taus, mcfg.no_samples, 70
    rng = np.random.default_rng(3)
    gpu = lambda a: torch.from_numpy(                             # noqa: E731
        np.ascontiguousarray(a, np.float32)).to(dev)
    normal = lambda *shape: gpu(rng.normal(size=shape))           # noqa: E731
    err = {}

    # ---- 6. F and G against their plain versions ------------------------
    def check_f(tag, rows, model, s_n):
        mvg = model.use_mvg
        k = 5 if mvg else 4
        n = rows["mask"].shape[0]
        c = dn.decode_consts(model, scan, True)
        main = (rows["q"][:, :k].contiguous(), rows["p"][:, :k].contiguous(),
                rows["y"], rows["sigma"], rows["mask"])
        zn, zk, ct_n, ct_k = (normal(s_n, n, 2), normal(s_kl, n, 2),
                              normal(n), normal(n))
        kw = dict(mvg=mvg, s_nll=s_n, s_kl=s_kl, z_nll=zn, z_kl=zk)
        got = fe.fused_elbo_forward(*main, c, **kw)
        grads = fe.fused_elbo_backward(*main, ct_n, ct_k, c, **kw)
        torch.cuda.synchronize()
        ref = fe.elbo_rows_plain(*main, zn, zk, c, mvg)
        gref = fe.elbo_grads_plain(*main, zn, zk, ct_n, ct_k, c, mvg)
        e_rows = max(check_rows(f"F fwd {tag} {nm}", x, r)
                     for nm, x, r in zip(("nll", "kl"), got, ref))
        e_grads = max(check_grad(f"F bwd {tag} {nm}", x, r)
                      for nm, x, r in zip(("dq", "dp", "dy", "dsigma"),
                                          grads, gref))
        log(f"kernel F vs plain ok: {tag}, N={n} (rows {e_rows:.3e}, "
            f"gradients {e_grads:.3e} max abs)")
        return e_rows, e_grads

    rows = ft_rows(tuner, rng, dev, t_n)
    err["F_fwd"], err["F_bwd"] = check_f("MVG, s_nll 1, host noise", rows,
                                         mcfg, s_nll)
    ragged = {k: torch.cat([v, v[:N_FT_RAGGED - N_FT]])
              for k, v in rows.items()}
    check_f("diagonal", ragged, dataclasses.replace(mcfg, use_mvg=False),
            s_nll)
    check_f("Student-t df 2, multi-image, s_nll 2", ragged,
            dataclasses.replace(mcfg, student_t_df=2.0,
                                multi_image_normalisation=True), 2)

    c_opt = dn.decode_consts(mcfg, scan, True)
    draws = tuner.dist.sample_many(normal(1, N_FT, 2), rows["q"],
                                   mcfg.use_mvg)[0]
    g_args = (draws[:, 0].contiguous(), draws[:, 1].contiguous(), rows["y"],
              rows["sigma"], rows["mask"])
    ct = normal(N_FT)
    got = dn.decode_nll_forward(*g_args, c_opt)
    grads = dn.decode_nll_backward(*g_args, ct, c_opt)
    torch.cuda.synchronize()
    err["G_fwd"] = check_rows(
        "G fwd", got, dn.nll_row_plain(*g_args, c_opt) * rows["mask"])
    ctm = ct * rows["mask"]
    err["G_bwd"] = max(
        check_grad(f"G bwd {nm}", x, r * (ctm if r.ndim == 1 else ctm[:, None]))
        for nm, x, r in zip(("doef", "ddbv", "dsigma", "dy"), grads,
                            dn.nll_row_grads_plain(*g_args, c_opt)))
    log(f"kernel G vs plain ok at N={N_FT} (rows {err['G_fwd']:.3e}, "
        f"gradients {err['G_bwd']:.3e} max abs)")

    # ---- 7. F's device noise ----------------------------------------------
    qd, pd = normal(N_FT, 5) * 0.7, normal(N_FT, 5) * 0.7
    qd[:, [1, 3]] *= 0.3                 # logits clear of the KL clamp
    pd[:, [1, 3]] *= 0.3
    main_d = (qd, pd, rows["y"], rows["sigma"], rows["mask"])
    ct_n, ct_k = normal(N_FT), normal(N_FT)
    kw = dict(mvg=True, s_nll=s_nll, s_kl=s_kl)
    r1 = fe.fused_elbo_forward(*main_d, c_opt, seed=5, **kw)
    r2 = fe.fused_elbo_forward(*main_d, c_opt, seed=5, **kw)
    r3 = fe.fused_elbo_forward(*main_d, c_opt, seed=6, **kw)
    g1 = fe.fused_elbo_backward(*main_d, ct_n, ct_k, c_opt, seed=5, **kw)
    g2 = fe.fused_elbo_backward(*main_d, ct_n, ct_k, c_opt, seed=5, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(r1 + g1, r2 + g2)):
        raise AssertionError("F device noise: one seed did not replay")
    if torch.equal(r1[0], r3[0]):
        raise AssertionError("F device noise: two seeds gave equal rows")
    z = gpu(fe.philox_normals(5, N_FT, s_nll + s_kl))
    ref = fe.elbo_rows_plain(*main_d, z[:s_nll], z[s_nll:], c_opt, True)
    for nm, x, r in zip(("nll", "kl"), r1, ref):
        check_rows(f"F device noise {nm} vs philox_normals", x, r, 1e-4, 1e-4)
    live = rows["mask"] > 0
    diff = (r1[1] - LogitMVN().mvg_kl_closed_form(qd, pd))[live].double()
    se = float(diff.std()) / diff.numel() ** 0.5
    if not abs(float(diff.mean())) < 5.0 * se:
        raise AssertionError(f"F device-noise KL biased: mean {diff.mean():.3e}"
                             f" vs standard error {se:.3e}")
    log(f"F device noise ok: replay bit-equal, seeds differ, KL - closed "
        f"form mean {float(diff.mean()):.3e} (standard error {se:.3e})")

    # ---- 8. the training main path ----------------------------------------
    counters = {"F_fwd": fe.fused_elbo_forward, "F_bwd": fe.fused_elbo_backward,
                "G_fwd": dn.decode_nll_forward,
                "G_bwd": dn.decode_nll_backward}
    logged = []

    def logger(phase, epoch, m):
        logged.append(dict(m))
        log(f"[{phase}] epoch {epoch}: " + " ".join(
            f"{k}={v:.6g}" for k, v in m.items()) + f" [{card}]")

    data = volumes(np.random.default_rng(0), TRAIN_VOLUMES, t_n)
    trainer = Trainer(cfg, state_dict=tuner.state_dict(), device=dev,
                      logger=logger)
    before = {k: v.clone() for k, v in trainer.tuner.state_dict().items()}
    for f in counters.values():
        f.launches = 0
    trainer.finetune(data, epochs=2)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    n_steps = 2 * cfg.train.ft_steps_per_epoch
    log(f"fine-tune (2 epochs x {cfg.train.ft_steps_per_epoch} steps, batch "
        f"{cfg.train.ft_batch_size}, device noise) launches: {launches}")
    if (launches["F_fwd"], launches["F_bwd"]) != (n_steps, n_steps) or \
            launches["G_fwd"] or launches["G_bwd"]:
        raise AssertionError(f"F did not run once a step: {launches}")
    if not all(np.isfinite(v) for m in logged for v in m.values()):
        raise AssertionError("non-finite fine-tune metrics")
    if all(torch.equal(before[k], v)
           for k, v in trainer.tuner.state_dict().items()):
        raise AssertionError("fine-tuning changed no parameter")
    epoch_ms = logged[1]["epoch_time_s"] * 1e3

    trainer.cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, fused_elbo="off", ft_steps_per_epoch=10))
    for f in counters.values():
        f.launches = 0
    trainer.finetune(data, epochs=1)
    torch.cuda.synchronize()
    launches_g = {k: f.launches for k, f in counters.items()}
    log(f"fine-tune (1 epoch x 10 steps, fused_elbo off) launches: "
        f"{launches_g}")
    if (launches_g["G_fwd"], launches_g["G_bwd"]) != (10, 10) or \
            launches_g["F_fwd"] or launches_g["F_bwd"]:
        raise AssertionError(f"G did not run once a step: {launches_g}")
    launches.update(G_fwd=launches_g["G_fwd"], G_bwd=launches_g["G_bwd"])
    trainer.cfg = cfg

    # one step on the card (F, injected normals) against the same step on
    # the CPU plain path: same weights, crops and normals
    vol = torch.from_numpy(trainer.sampler.data).to(dev)
    pri = torch.from_numpy(trainer.sampler.priors).to(dev)
    batch = steps.sample_crop_batch(torch.Generator().manual_seed(7), vol,
                                    pri, 4, cfg.train.crop_size)
    shape = tuple(batch["images"].shape[:-1])
    noise = {"z_nll": rng.normal(size=(s_nll,) + shape + (2,)),
             "z_kl": rng.normal(size=(s_kl,) + shape + (2,))}
    noise = {k: v.astype(np.float32) for k, v in noise.items()}
    state = trainer.tuner.state_dict()
    result = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        t = FineTuner(mcfg, scan, device=device)
        t.load_state_dict(state)
        opt = optim.make_finetune_optimizer(t.parameters(), cfg.train)
        result[name] = stepped(t, steps.make_finetune_step(t, cfg, opt)(
            {k: v.to(device) for k, v in batch.items()}, noise=noise))
    worst_grad = check_step("one fine-tune step on the card vs the CPU",
                            result["card"], result["cpu"], state,
                            float(cfg.train.ft_lr))
    log(f"one step on the card agrees with the CPU plain path: loss "
        f"{result['card'][0]:.7g} vs {result['cpu'][0]:.7g}, gradients "
        f"within {worst_grad:.2e} of their scale, updates within tolerance")

    # ---- 9. timings ---------------------------------------------------------
    log_clocks("before the fine-tune timings")
    main = (rows["q"], rows["p"], rows["y"], rows["sigma"], rows["mask"])
    ct_n, ct_k = normal(N_FT), normal(N_FT)
    seed = 11
    z = gpu(fe.philox_normals(seed, N_FT, s_nll + s_kl))
    zn, zk = z[:s_nll], z[s_nll:]
    kwd = dict(mvg=True, s_nll=s_nll, s_kl=s_kl, seed=seed)
    kwh = dict(mvg=True, s_nll=s_nll, s_kl=s_kl, z_nll=zn, z_kl=zk)
    times = {
        "F_fwd": time_kernel(
            lambda: fe.fused_elbo_forward(*main, c_opt, **kwd),
            "qv_elbo_fwd_kernel",
            lambda: fe.elbo_rows_plain(*main, zn, zk, c_opt, True)),
        "F_bwd": time_kernel(
            lambda: fe.fused_elbo_backward(*main, ct_n, ct_k, c_opt, **kwd),
            "qv_elbo_bwd_kernel",
            lambda: fe.elbo_grads_plain(*main, zn, zk, ct_n, ct_k, c_opt,
                                        True)),
        "G_fwd": time_kernel(
            lambda: dn.decode_nll_forward(*g_args, c_opt),
            "qv_decode_nll_fwd_kernel",
            lambda: dn.nll_row_plain(*g_args, c_opt) * rows["mask"]),
        "G_bwd": time_kernel(
            lambda: dn.decode_nll_backward(*g_args, ct, c_opt),
            "qv_decode_nll_bwd_kernel",
            lambda: dn.nll_row_grads_plain(*g_args, c_opt)),
    }
    host = (kernel_ms(lambda: fe.fused_elbo_forward(*main, c_opt, **kwh),
                      "qv_elbo_fwd_kernel"),
            kernel_ms(lambda: fe.fused_elbo_backward(*main, ct_n, ct_k,
                                                     c_opt, **kwh),
                      "qv_elbo_bwd_kernel"))
    log_times(times, N_FT, card)
    log(f"F with host noise: forward {host[0]:.4f} ms, backward "
        f"{host[1]:.4f} ms on the device at N={N_FT} [{card}]")
    log_clocks("after the kernel timings")
    step = steps.make_finetune_step(trainer.tuner, cfg, trainer.optimizer)
    batch = steps.sample_crop_batch(torch.Generator().manual_seed(9), vol,
                                    pri, cfg.train.ft_batch_size,
                                    cfg.train.crop_size)
    step_ms = wall_ms(lambda: step(batch, seed=seed))
    log(f"fine-tune step (loss + backward + AdamW, F with device noise) wall "
        f"{step_ms:.3f} ms at batch {cfg.train.ft_batch_size} x {shape[1:]} "
        f"[{card}]")
    profile(lambda: step(batch, seed=seed), 5, "fine-tune step", card)
    log(f"fine-tune epoch ({cfg.train.ft_steps_per_epoch} steps, crops drawn "
        f"on the card, metrics read back once) wall {epoch_ms:.1f} ms "
        f"[{card}]")

    n_live = int(live.sum())
    student = c_opt.student
    bounds = {
        "F_fwd": bound_elbo(N_FT, n_live, 5, t_n, s_nll, s_kl, student, True,
                            False),
        "F_bwd": bound_elbo(N_FT, n_live, 5, t_n, s_nll, s_kl, student, True,
                            True),
        "G_fwd": bound_decode(N_FT, n_live, t_n, student, False),
        "G_bwd": bound_decode(N_FT, n_live, t_n, student, True),
    }
    sources = {"F": ("fused_elbo", "qbold_vi_tpu_torch/csrc/fused_elbo.cu",
                     "qbold_vi_tpu/ops/pallas_elbo.py", (464, 492)),
               "G": ("decode_nll", "qbold_vi_tpu_torch/csrc/decode_nll.cu",
                     "qbold_vi_tpu/ops/pallas_decode.py", (399, 431))}
    kernels = []
    for key, (name, src, tpu, lines) in sources.items():
        for way, line in zip(("fwd", "bwd"), lines):
            k = f"{key}_{way}"
            kernels.append({
                "name": f"{name}_{'forward' if way == 'fwd' else 'backward'}",
                "route": "cuda", "source": src, "replaces": f"{tpu}:{line}",
                "launches": launches[k], "max_abs_err": err[k],
                "ms": times[k][0], "plain_ms": times[k][2], **bounds[k],
                "library_ms": None})
    return {"kernels": kernels, "step_ms": step_ms, "epoch_ms": epoch_ms}


def host_normals(stream, seed, start, shape, draws, device, index=None):
    """An infer.draw_noise replacement: numpy normals from (seed, stream,
    subject, pass), the same on every device."""
    g = np.random.default_rng([seed, start, ("summaries", "kl",
                                             "decode").index(stream),
                               0 if index is None else index + 1])
    lead = () if index is not None else (draws,)
    z = g.normal(size=lead + tuple(shape) + (2,)).astype(np.float32)
    return {"z": torch.from_numpy(z).to(device)}


@torch.no_grad()
def sampled_phases(dev, card, cfg, tuner, ranges, enc_kw) -> dict:
    """Phases 10-13: kernels C, D and E against their plain versions and
    their statistics, the sampled serving path and the fine-tuned export,
    and the timings. Returns the kernels' JSON entries and the walls."""
    from qbold_vi_tpu_torch import infer
    from qbold_vi_tpu_torch.dist.logit_mvn import LogitMVN
    from qbold_vi_tpu_torch.models.vi import FineTuner
    from qbold_vi_tpu_torch.ops import fused_elbo as fe
    from qbold_vi_tpu_torch.ops import fused_infer as fi
    from qbold_vi_tpu_torch.ops import quadrature as quad
    from qbold_vi_tpu_torch.ops import summarize as sm
    from qbold_vi_tpu_torch.train.data import predict_priors

    mcfg, scan = cfg.model, cfg.scan
    rng = np.random.default_rng(5)
    gpu = lambda a: torch.from_numpy(                             # noqa: E731
        np.ascontiguousarray(a, np.float32)).to(dev)
    err = {}

    # ---- 10. C, D and E against their plain versions ------------------------
    for n in (N_FULL, N_RAGGED):
        x = volumes(rng, (n,), scan.n_taus)
        for layout in ("voxel", "channel"):
            xt = gpu(x) if layout == "voxel" else gpu(x.T)
            kw = dict(enc_kw, mask_channel=True, input_layout=layout)
            got = fi.encode_q1_packed(xt, tuner.encoder, **kw)
            ref = fi.encode_q_plain(xt, tuner.encoder, **kw)
            e = check_close(f"C n={n} {layout}", got.T, ref.T, "raw")
            if n == N_FULL and layout == "voxel":
                err["C"] = e
        torch.cuda.synchronize()
        log(f"kernel C vs plain ok at N={n} (voxel and channel layouts, "
            "mask channel)")

    seed = 7
    z = gpu(fe.philox_normals(seed, N_MC + 1, S_MC))
    q_all = gpu(raw_head(rng, N_MC + 1))
    p_all = gpu(rng.normal(size=(N_MC + 1, 5)) * 0.7)
    for n in (N_MC, N_MC + 1):
        for mvg in (True, False):
            k = 5 if mvg else 4
            q, p = q_all[:n, :k].contiguous(), p_all[:n, :k].contiguous()
            q_t = torch.cat([q.T, q.new_zeros((5 - k, n))]).contiguous()
            for anti in (True, False):
                kw = dict(ranges, mvg=mvg, no_samples=S_MC, antithetic=anti)
                got = sm.mc_posterior_summaries(q, seed, **kw)
                got_t = sm.mc_posterior_summaries_packed(q_t, seed, **kw)
                if not all(torch.equal(a, b.T) for a, b in zip(got, got_t)):
                    raise AssertionError("D: the packed entry differs")
                ref = sm.mc_posterior_summaries_plain(
                    q, z[:sm.mc_draws(S_MC, anti), :n], **kw)
                tag = f"D n={n} mvg={mvg} antithetic={anti}"
                e = max(check_close(tag, got[0], ref[0], "mean"),
                        check_close(tag, got[1], ref[1], "var", ref[0]))
                if n == N_MC and mvg and anti:
                    err["D"] = e
            kl = sm.mc_kl_map(q, p, seed, no_samples=S_KL, mvg=mvg)
            e = check_rows(f"E n={n} mvg={mvg}", kl,
                           sm.mc_kl_map_plain(q, p, z[:S_KL, :n], mvg),
                           1e-4, 1e-4)
            if n == N_MC and mvg:
                err["E"] = e
        torch.cuda.synchronize()
        log(f"kernels D and E vs plain fed philox_normals ok at N={n} (MVG "
            "and diagonal; D antithetic and iid, both layouts)")

    q, p = q_all[:N_MC].contiguous(), p_all[:N_MC].contiguous()
    kw = dict(ranges, no_samples=S_MC)
    half = N_MC // 2 + 3
    d1 = sm.mc_posterior_summaries(q, seed, **kw)
    d2 = sm.mc_posterior_summaries(q, seed, **kw)
    d3 = sm.mc_posterior_summaries(q, seed + 1, **kw)
    parts = [sm.mc_posterior_summaries(q[:half], seed, **kw),
             sm.mc_posterior_summaries(q[half:], seed, offset=half, **kw)]
    e1, e2, e3 = (sm.mc_kl_map(q, p, s_, no_samples=S_KL)
                  for s_ in (seed, seed, seed + 1))
    e_parts = torch.cat([sm.mc_kl_map(q[:half], p[:half], seed,
                                      no_samples=S_KL),
                         sm.mc_kl_map(q[half:], p[half:], seed,
                                      offset=half, no_samples=S_KL)])
    torch.cuda.synchronize()
    if not (all(torch.equal(a, b) for a, b in zip(d1, d2))
            and torch.equal(e1, e2)):
        raise AssertionError("D/E device noise: one seed did not replay")
    if torch.equal(d1[0], d3[0]) or torch.equal(e1, e3):
        raise AssertionError("D/E device noise: two seeds gave equal output")
    whole = all(torch.equal(torch.cat([parts[0][i], parts[1][i]]), d1[i])
                for i in range(2))
    if not (whole and torch.equal(e_parts, e1)):
        raise AssertionError("D/E: a request cut at an offset draws other "
                             "normals than the whole one")
    log("D and E device noise ok: replay bit-equal, seeds differ, a cut at "
        "an offset draws what the whole request does")

    # ---- 11. statistics -----------------------------------------------------
    qf = gpu(raw_head(rng, N_FULL))
    m_d, v_d = (t.double() for t in sm.mc_posterior_summaries(qf, 11, **kw))
    m_a, v_a = (t.double() for t in quad.quad_posterior_summaries(qf,
                                                                  **ranges))
    # the iid standard error (antithetic pairs only lower it), from the
    # larger variance estimate: in a narrow posterior E[x^2] - E[x]^2
    # cancels in float32, so either may read 0, and none is read below
    # 16 ulps of the second moment
    gap, var_raw = (m_d - m_a).abs(), torch.maximum(v_a, v_d)
    floor = 16 * EPS32 * (v_a + m_a**2)
    worst = float((gap / torch.sqrt(torch.maximum(var_raw, floor) / S_MC)
                   ).max())
    # the reading without the floor where a variance survived, the
    # (voxel, channel) that sets it, and the gaps where both cancelled to 0
    kept = var_raw > 0
    raw = torch.where(kept, gap / torch.sqrt(var_raw / S_MC), 0.0)
    vox, ch = divmod(int(torch.argmax(raw)), 3)
    dead = torch.where(kept, 0.0, gap / m_a.abs())
    log(f"D vs A without the variance floor: {float(raw[vox, ch]):.2f} "
        f"standard errors at voxel {vox} channel {ch} (means A "
        f"{float(m_a[vox, ch]):.9g}, D {float(m_d[vox, ch]):.9g}; variances "
        f"A {float(v_a[vox, ch]):.3e}, D {float(v_d[vox, ch]):.3e}; floor "
        f"{float(floor[vox, ch]):.3e}; q "
        f"{[round(x, 4) for x in qf[vox].tolist()]}); both variances 0 in "
        f"{int((~kept).sum())} of {kept.numel()} elements, largest relative "
        f"mean gap there {float(dead.max()):.3e}")
    if worst > 8.0:
        raise AssertionError(f"D's means lie {worst:.2f} standard errors "
                             "from the quadrature's")
    qe = gpu(rng.normal(size=(N_SUBJ, 5)) * 0.7)
    pe = gpu(rng.normal(size=(N_SUBJ, 5)) * 0.7)
    qe[:, [1, 3]] *= 0.3                 # logits clear of the KL clamp
    pe[:, [1, 3]] *= 0.3
    live = gpu(rng.uniform(size=N_SUBJ) > 0.2) > 0
    diff = (sm.mc_kl_map(qe, pe, 13, no_samples=S_KL)
            - LogitMVN().mvg_kl_closed_form(qe, pe))[live].double()
    kl_se = float(diff.std()) / diff.numel() ** 0.5
    if not abs(float(diff.mean())) < 5.0 * kl_se:
        raise AssertionError(f"E biased: mean {float(diff.mean()):.3e} vs "
                             f"standard error {kl_se:.3e}")
    log(f"statistics ok: D's means within {worst:.2f} standard errors of "
        f"A's at N={N_FULL}; E - closed form mean {float(diff.mean()):.3e} "
        f"(standard error {kl_se:.3e}) at N={N_SUBJ}")

    # ---- 12. the sampled main paths -----------------------------------------
    counters = {"C": fi.encode_q1_packed,
                "D_packed": sm.mc_posterior_summaries_packed,
                "D": sm.mc_posterior_summaries, "E": sm.mc_kl_map}
    reqs = [volumes(rng, shape, scan.n_taus) for shape in REQUESTS]
    ft_data = volumes(np.random.default_rng(0), TRAIN_VOLUMES, scan.n_taus)
    launches, small = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for first in (True, False):
            stream = "stream1" if first else "stream2"
            for f in counters.values():
                f.launches = 0
            for i, data in enumerate(reqs):
                prefix = f"{tmp}/mc{i}_{stream}"
                maps = infer.save_predictions(tuner, cfg, data, prefix,
                                              use_first_op=first, method="mc",
                                              seed=21)
                check_maps(maps, data.shape[:-1], prefix)
                small[first] = maps
                log(f"request {i} {data.shape[:-1]} {stream}, method mc: ok,"
                    f" mean OEF {maps['oef'].mean():.4f}")
            launches[stream] = {k: f.launches for k, f in counters.items()}
        log(f"sampled main-path launches: {launches}")
        if not (launches["stream1"]["C"] and launches["stream1"]["D_packed"]
                and launches["stream2"]["D"]):
            raise AssertionError(f"a kernel of the path never ran: {launches}")

        def encode_fn(images):
            return [t.cpu().numpy() for t in tuner.encode(gpu(images))]

        priors = predict_priors(encode_fn, ft_data, 5)
        for f in counters.values():
            f.launches = 0
        prefix = f"{tmp}/fine_tuned"
        maps = infer.save_predictions(tuner, cfg, ft_data, prefix,
                                      fine_tuned=True, priors=priors, seed=22)
        launches["fine_tuned"] = {k: f.launches for k, f in counters.items()}
        log(f"fine-tuned export launches: {launches['fine_tuned']}")
        if launches["fine_tuned"]["E"] != TRAIN_VOLUMES[0]:
            raise AssertionError("E did not run once a subject")
        check_maps(maps, ft_data.shape[:-1], prefix)
        log(f"fine-tuned export {TRAIN_VOLUMES}: ok, mean likelihood "
            f"{maps['likelihood'].mean():.4f}, KL {maps['kl'].mean():.4f}, "
            f"residual {maps['residual'].mean():.4f}")

    # the smallest request against the CPU plain path (the same Philox
    # counters, replayed on the host) and against itself at chunk 1
    cpu = FineTuner(mcfg, scan, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in tuner.state_dict().items()})
    flat = lambda d, k: torch.from_numpy(                         # noqa: E731
        d[k].reshape(-1, d[k].shape[-1]).astype(np.float64))
    means = lambda d: torch.cat([flat(d, k) for k in              # noqa: E731
                                 ("oef", "dbv", "r2p")], -1)
    for first in (True, False):
        kw_m = dict(use_first_op=first, method="mc", seed=21)
        # chunk 1 against chunk 2: the same draws; the encoder's rounding
        # may follow the batch shape, the Monte-Carlo spread is ~1e-2
        again = infer.posterior_maps(tuner, reqs[-1], chunk=1, **kw_m)
        ref = infer.posterior_maps(cpu, reqs[-1], **kw_m)
        for tag, other in (("chunk 1", again), ("CPU", ref)):
            tag = f"MC stream {1 if first else 2} vs {tag}"
            check_close(tag, means(small[first]), means(other), "mean")
            check_close(tag, flat(small[first], "stds"), flat(other, "stds"),
                        "var", means(other))
            check_close(tag, flat(small[first], "raw_log_stds"),
                        flat(other, "raw_log_stds"), "raw")
    log("MC maps of the smallest request agree with the CPU plain path and "
        "with themselves at chunk 1")
    draw = infer.draw_noise
    infer.draw_noise = host_normals
    try:
        cut = ft_data[:1, :32, :32]
        pri = priors[:1, :32, :32]
        got = infer.elbo_maps(tuner, cfg, cut, pri, seed=3)
        ref = infer.elbo_maps(cpu, cfg, cut, pri, seed=3)
    finally:
        infer.draw_noise = draw
    for k in got:
        check_rows(f"elbo_maps {k} vs CPU", torch.from_numpy(got[k]),
                   torch.from_numpy(ref[k]), 1e-4, 1e-4)
    log("elbo_maps on the card (kernel E) agree with the CPU plain path "
        "given the same normals")

    # ---- 13. timings --------------------------------------------------------
    log_clocks("before the sampled-path timings")
    x = gpu(volumes(rng, (N_FULL,), scan.n_taus))
    kw_c = dict(enc_kw, mask_channel=True, input_layout="voxel")
    q_t = fi.encode_q1_packed(x, tuner.encoder, **kw_c)
    z_d = torch.randn((S_MC // 2, N_FULL, 2), device=dev)
    subj = gpu(ft_data[:1])
    images = subj[..., :-1] * subj[..., -1:]
    q_e = tuner.encode(images)[1].reshape(N_SUBJ, 5).contiguous()
    p_e = gpu(priors[:1]).reshape(N_SUBJ, 5).contiguous()
    z_e = torch.randn((S_KL, N_SUBJ, 2), device=dev)
    times = {
        "C": time_kernel(
            lambda: fi.encode_q1_packed(x, tuner.encoder, **kw_c),
            "qv_encode_q_kernel",
            lambda: fi.encode_q_plain(x, tuner.encoder, **kw_c)),
        "D": time_kernel(
            lambda: sm.mc_posterior_summaries_packed(q_t, 3, **kw),
            "qv_mc_summaries_kernel",
            lambda: sm.mc_posterior_summaries_plain(q_t.T, z_d, **kw)),
        "E": time_kernel(
            lambda: sm.mc_kl_map(q_e, p_e, 3, no_samples=S_KL),
            "qv_mc_kl_kernel",
            lambda: sm.mc_kl_map_plain(q_e, p_e, z_e)),
    }
    log_times({k: v for k, v in times.items() if k != "E"}, N_FULL, card)
    log_times({"E": times["E"]}, N_SUBJ, card)
    big = reqs[0]
    walls = {f"stream{1 if first else 2}": wall_ms(
        lambda: infer.posterior_maps(tuner, big, use_first_op=first,
                                     method="mc"))
        for first in (True, False)}
    for k, ms in walls.items():
        log(f"posterior_maps method=mc {k} wall {ms:.2f} ms on {REQUESTS[0]}"
            f" (1.03 M voxels, S = {S_MC}) [{card}]")
    one = (ft_data[:1], priors[:1])
    elbo_ms = wall_ms(lambda: infer.elbo_maps(tuner, cfg, *one), blocks=3)
    log(f"elbo_maps wall {elbo_ms:.2f} ms per {TRAIN_VOLUMES[1:]} subject "
        f"(100 decode passes, KL by kernel E) [{card}]")
    log_clocks("after the sampled-path timings")
    for first in (True, False):
        profile(lambda: infer.posterior_maps(tuner, big, use_first_op=first,
                                             method="mc"),
                2, f"posterior_maps method=mc stream {1 if first else 2} on "
                f"{REQUESTS[0]}", card)
    profile(lambda: infer.elbo_maps(tuner, cfg, *one), 1,
            f"elbo_maps on one {TRAIN_VOLUMES[1:]} subject", card)

    bounds = {
        "C": bound(N_FULL * 4 * (scan.n_taus + 1 + 5),
                   N_FULL * ops_encode(mcfg.no_units, scan.n_taus,
                                       mcfg.no_intermediate_layers)),
        "D": bound(N_FULL * 4 * (5 + 6),
                   N_FULL * ops_mc_summaries(S_MC, True)),
        "E": bound(N_SUBJ * 4 * (5 + 5 + 1), N_SUBJ * ops_mc_kl(S_KL)),
    }
    main = {"C": launches["stream1"]["C"],
            "D": (launches["stream1"]["D_packed"]
                  + launches["stream2"]["D"]),
            "E": launches["fine_tuned"]["E"]}
    sources = {
        "C": ("encode_q1_packed", "encode_quad.cu", "pallas_infer.py:246"),
        "D": ("mc_posterior_summaries", "summarize.cu",
              "pallas_summarize.py:319"),
        "E": ("mc_kl_map", "summarize.cu", "pallas_summarize.py:221")}
    kernels = [{
        "name": name, "route": "cuda",
        "source": f"qbold_vi_tpu_torch/csrc/{src}",
        "replaces": f"qbold_vi_tpu/ops/{tpu}", "launches": main[k],
        "max_abs_err": err[k], "ms": times[k][0], "plain_ms": times[k][2],
        **bounds[k], "library_ms": None}
        for k, (name, src, tpu) in sources.items()]
    return {"kernels": kernels, "mc_walls": walls, "elbo_ms": elbo_ms}


# ---- kernel H and the two-phase path -----------------------------------------
# (N, H, W, Ci, Co): the fine-tune fold (38 crops of 25 x 25 x 8), one
# serving chunk (2 subjects of 96 x 96 x 8), prepare_real's chunk (4
# blank-cropped subjects of 62 x 76 x 8), and two ragged planes
CONV_SHAPES = ((304, 25, 25, 60, 60), (16, 96, 96, 60, 60),
               (32, 62, 76, 60, 60), (5, 7, 6, 4, 3), (9, 3, 11, 5, 7))
# the output and dx within 1e-5 of their largest magnitude: sums of 9 Ci
# products in another order; dw and db within 1e-4 of theirs: sums of
# N H W (up to 190,000) terms in another order
CONV_TOL = dict(y=1e-5, dx=1e-5, dw=1e-4, db=1e-4)
H_SYMBOLS = dict(fwd=("qv_conv3x3_wsplit_kernel", "qv_conv3x3_fwd_kernel"),
                 bwd=("qv_conv3x3_wsplit_kernel", "qv_conv3x3_dx_kernel",
                      "qv_conv3x3_dw_kernel", "qv_conv3x3_reduce_kernel"))


def scaled_err(name, got, ref, tol) -> float:
    """Raise unless |got - ref| <= tol * max |ref|; returns max |got - ref|."""
    got, ref = got.double(), ref.double()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = float((got - ref).abs().max())
    if err > tol * float(ref.abs().max()):
        raise AssertionError(f"{name}: differs by {err:.3e}, over {tol} of "
                             f"the largest magnitude {float(ref.abs().max()):.3e}")
    return err


def cudnn_conv(x, w_oihw, b):
    """cuDNN's float32 conv (TF32 off by the caller) on NHWC x, as NHWC."""
    import torch.nn.functional as F

    return F.conv2d(x.permute(0, 3, 1, 2), w_oihw, b,
                    padding=1).permute(0, 2, 3, 1)


def cudnn_conv_backward(x, w_oihw, ct):
    """The one aten.convolution_backward call with output_mask (True, True,
    True): (dx NHWC, dw OIHW, db)."""
    return torch.ops.aten.convolution_backward(
        ct.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w_oihw, [w_oihw.shape[0]],
        [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [True, True, True])


def conv_bound(shape, backward: bool) -> dict:
    """Kernel H: x, w, b (and ct) read once, y (dx, dw, db) written once;
    2 * 9 * Ci * Co operations a pixel a pass (an FMA counts 2; the
    backward is two passes), taken on the tensor cores as 3xTF32 -- three
    TF32 products for each float32 one, over the dense TF32 peak -- plus
    the bias (forward) or db (backward) adds on the CUDA cores.
    ``cuda_core_bound_ms``: the same work at the float32 CUDA-core peak."""
    n, h, w, ci, co = shape
    p = n * h * w
    passes = 2 if backward else 1
    floats = passes * (p * ci + p * co + 9 * ci * co) + co
    fma_ops = passes * 2 * 9 * ci * co * p
    adds = p * co
    t_bytes = 4 * floats / PEAK_BYTES * 1e3
    t_ops = (3 * fma_ops / PEAK_TF32 + adds / PEAK_FLOPS) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "cuda_core_bound_ms": bound(4 * floats, fma_ops + adds)["bound_ms"]}


def device_ms(fn, calls: int = 21) -> float:
    """The device time of all kernels of one call of fn (the sum of their
    profiled durations over ``calls`` calls, divided by ``calls``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3 / calls


def kernel_ms_parts(fn, symbols, calls: int = 21) -> dict:
    """Each of the ``symbols``' median device time over ``calls`` calls.
    The trace drops most records of H's ~2 us weight split (6 of 21 on the
    H100), so one traced launch suffices for it."""
    return {s: kernel_ms(fn, s, calls, 1 if "wsplit" in s else None)
            for s in symbols}


def conv_phases(dev, card) -> dict:
    """Phase 14: kernel H against its plain version and against cuDNN at the
    main paths' shapes and two ragged ones, dw's bit-equal replay, a refused
    launch; and the timings of H, its plain version and cuDNN at each
    main-path shape. Returns errors and times at the fine-tune fold."""
    from qbold_vi_tpu_torch.models.encoder import _full_fp32
    from qbold_vi_tpu_torch.ops import conv3x3 as cv

    rng = np.random.default_rng(17)
    out = {}
    with torch.no_grad(), _full_fp32():
        for shape in CONV_SHAPES:
            n, h, w, ci, co = shape
            x = torch.from_numpy(rng.normal(size=(n, h, w, ci)).astype(
                np.float32)).to(dev)
            wt = torch.from_numpy((rng.normal(size=(3, 3, ci, co)) * 0.1
                                   ).astype(np.float32)).to(dev)
            b = torch.from_numpy((rng.normal(size=co) * 0.1).astype(
                np.float32)).to(dev)
            ct = torch.from_numpy(rng.normal(size=(n, h, w, co)).astype(
                np.float32)).to(dev)
            w_oihw = wt.permute(3, 2, 0, 1).contiguous()
            got = (cv.conv3x3_forward(x, wt, b),) + cv.conv3x3_backward(
                x, wt, ct)
            again = cv.conv3x3_backward(x, wt, ct)
            torch.cuda.synchronize()
            if not (torch.equal(got[2], again[1])
                    and torch.equal(got[3], again[2])):
                raise AssertionError(f"H {shape}: dw/db differ between two "
                                     "calls of the backward")
            plain = (cv.conv3x3_plain(x, wt, b),) + cv.conv3x3_grads_plain(
                x, wt, ct)
            lib_dx, lib_dw, lib_db = cudnn_conv_backward(x, w_oihw, ct)
            lib = (cudnn_conv(x, w_oihw, b), lib_dx.permute(0, 2, 3, 1),
                   lib_dw.permute(2, 3, 1, 0), lib_db)
            errs = {}
            for i, key in enumerate(("y", "dx", "dw", "db")):
                errs[key] = scaled_err(f"H {shape} {key} vs plain", got[i],
                                       plain[i], CONV_TOL[key])
                scaled_err(f"H {shape} {key} vs cuDNN", got[i], lib[i],
                           CONV_TOL[key])
            log(f"kernel H vs plain and vs cuDNN ok at {shape}: "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + " max abs; dw/db replay bit-equal")
            if shape == CONV_SHAPES[0]:
                out["err_fwd"] = errs["y"]
                out["err_bwd"] = max(errs["dx"], errs["dw"], errs["db"])
                ref64 = (cv.conv3x3_plain(x.double(), wt.double(),
                                          b.double()),) + \
                    cv.conv3x3_grads_plain(x.double(), wt.double(), ct.double())
                for name, res in (("H", got), ("plain", plain),
                                  ("cuDNN", lib)):
                    errs64 = [float((r.double() - f).abs().max())
                              for r, f in zip(res, ref64)]
                    log(f"{name} vs float64 at {shape}: " + ", ".join(
                        f"{k} {e:.3e} ({e / float(f.abs().max()):.2e} of the "
                        "largest)" for k, e, f in zip(("y", "dx", "dw", "db"),
                                                      errs64, ref64)))
                del ref64
            if shape in CONV_SHAPES[:3]:
                parts = {
                    "fwd": kernel_ms_parts(
                        lambda: cv.conv3x3_forward(x, wt, b), H_SYMBOLS["fwd"]),
                    "bwd": kernel_ms_parts(
                        lambda: cv.conv3x3_backward(x, wt, ct),
                        H_SYMBOLS["bwd"])}
                times = {
                    "fwd": (sum(parts["fwd"].values()),
                            cuda_ms(lambda: cv.conv3x3_plain(x, wt, b), reps=2),
                            cuda_ms(lambda: cudnn_conv(x, w_oihw, b))),
                    "bwd": (sum(parts["bwd"].values()),
                            cuda_ms(lambda: cv.conv3x3_grads_plain(x, wt, ct),
                                    reps=2),
                            cuda_ms(lambda: cudnn_conv_backward(x, w_oihw,
                                                                ct)))}
                calls = {
                    "fwd": (lambda: cv.conv3x3_forward(x, wt, b),
                            lambda: cudnn_conv(x, w_oihw, b)),
                    "bwd": (lambda: cv.conv3x3_backward(x, wt, ct),
                            lambda: cudnn_conv_backward(x, w_oihw, ct))}
                for way, (ms, plain_ms, lib_ms) in times.items():
                    bd = conv_bound(shape, way == "bwd")
                    h_call, lib_call = calls[way]
                    log(f"H {way} at {shape}: kernel {ms:.4f} ms on the device"
                        " (" + ", ".join(f"{k[11:-7]} {v:.4f}" for k, v in
                                         parts[way].items())
                        + f"), {cuda_ms(h_call):.4f} ms a call by CUDA "
                        f"events; plain {plain_ms:.4f} ms; cuDNN "
                        f"{lib_ms:.4f} ms a call, {device_ms(lib_call):.4f} "
                        f"ms on the device; bound {bd['bound_ms']:.4f} ms "
                        f"({bd['bound_by']}, 3xTF32 tensor cores), CUDA-core "
                        f"bound {bd['cuda_core_bound_ms']:.4f} ms [{card}]")
                if shape == CONV_SHAPES[0]:
                    out["times"] = times
        x = torch.zeros((2, 5, 6, 4), device=dev)
        try:
            cv.conv3x3_forward(x.transpose(1, 2).contiguous().transpose(1, 2),
                               torch.zeros((3, 3, 4, 3), device=dev),
                               torch.zeros(3, device=dev))
        except ValueError as e:
            log(f"H refuses a non-contiguous input: {e}")
        else:
            raise AssertionError("H launched on a non-contiguous input")
    return out


def two_phase_path(dev, card, base, conv: dict) -> dict:
    """Phases 15-17: Trainer.pretrain at full data size (2 epochs), then
    prepare_real + finetune (2 x 100 steps) with fused_conv="on" through
    kernels H and F; one pretrain step and one fine-tune step checked
    across devices and conv routes; stream-2 serving under "on"; timings.
    Returns H's JSON entries and the walls."""
    from qbold_vi_tpu_torch import infer, synth
    from qbold_vi_tpu_torch.models.vi import FineTuner
    from qbold_vi_tpu_torch.ops import conv3x3 as cv
    from qbold_vi_tpu_torch.ops import fused_elbo as fe
    from qbold_vi_tpu_torch.train import data as data_pipe
    from qbold_vi_tpu_torch.train import optim, steps
    from qbold_vi_tpu_torch.train.trainer import Trainer, WeightStatus

    cfg = dataclasses.replace(
        base, model=dataclasses.replace(base.model, fused_conv="on"),
        train=dataclasses.replace(base.train, no_pt_epochs=2))
    mcfg, scan = cfg.model, cfg.scan
    off = dataclasses.replace(cfg, model=dataclasses.replace(mcfg,
                                                             fused_conv="off"))
    logged = []

    def logger(phase, epoch, m):
        logged.append((phase, dict(m)))
        log(f"[{phase}] epoch {epoch}: " + " ".join(
            f"{k}={v:.6g}" for k, v in m.items()) + f" [{card}]")

    # ---- 15. pretraining at full data size --------------------------------
    trainer = Trainer(cfg, device=dev, logger=logger)
    if trainer.status is not WeightStatus.NOT_TRAINED:
        raise AssertionError("a Trainer without weights is not NOT_TRAINED")
    try:
        trainer.finetune(np.zeros((1, 8, 8, 1, scan.n_taus + 1), np.float32))
    except RuntimeError as e:
        log(f"finetune before pretrain raises: {e}")
    else:
        raise AssertionError("finetune ran before pretrain")
    cv.conv3x3.fwd_launches = cv.conv3x3.bwd_launches = 0
    t0 = time.perf_counter()
    trainer.pretrain()
    torch.cuda.synchronize()
    pt_wall = time.perf_counter() - t0
    pt = [m for phase, m in logged if phase == "pretrain"]
    n_vox = cfg.synth.sample_size ** 2
    n_vol = n_vox // 500
    spe = (n_vol - max(1, n_vol // 10)) // cfg.train.pt_batch_size
    log(f"pretrain: {len(pt)} epochs x {spe} steps at batch "
        f"{cfg.train.pt_batch_size} pseudo-volumes of 10 x 10 x 5 from "
        f"{n_vox:,} synthetic voxels; dataset build "
        f"{pt[0]['data_time_s']:.2f} s, epochs "
        + ", ".join(f"{m['epoch_time_s']:.3f} s" for m in pt)
        + f", whole call {pt_wall:.2f} s; H launches "
        f"{cv.conv3x3.fwd_launches}/{cv.conv3x3.bwd_launches} [{card}]")
    if len(pt) != 2 or not all(np.isfinite(v) for m in pt for v in m.values()):
        raise AssertionError(f"pretraining metrics: {pt}")
    if cv.conv3x3.fwd_launches or cv.conv3x3.bwd_launches:
        raise AssertionError("pretraining launched kernel H (stream 1 only)")
    if trainer.status is not WeightStatus.PRE_TRAINED:
        raise AssertionError("pretrain() left the trainer unpretrained")
    pretrained = {k: v.clone() for k, v in trainer.tuner.state_dict().items()}

    # one pretrain step on the card against the same step on the CPU
    x, y = synth.create_synthetic_dataset_host(7, scan, dataclasses.replace(
        cfg.synth, sample_size=560), device=dev)
    (tx, ty), _ = data_pipe.split_synthetic(x, y)
    big = {"x": torch.from_numpy(tx[:cfg.train.pt_batch_size]).to(dev),
           "y": torch.from_numpy(ty[:cfg.train.pt_batch_size]).to(dev)}
    small = {k: v[:32] for k, v in big.items()}
    result = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        t = FineTuner(mcfg, scan, device=device)
        t.load_state_dict(pretrained)
        opt = optim.make_pretrain_optimizer(t.named_parameters(), cfg.train)
        result[name] = stepped(t, steps.make_pretrain_step(t, cfg, opt)(
            {k: v.to(device) for k, v in small.items()}, seed=3))
    worst = check_step("one pretrain step on the card vs the CPU",
                       result["card"], result["cpu"], pretrained,
                       float(cfg.train.pt_lr))
    log(f"one pretrain step on the card agrees with the CPU: loss "
        f"{result['card'][0]:.7g} vs {result['cpu'][0]:.7g}, gradients within"
        f" {worst:.2e} of their scale, updates within tolerance")

    # ---- 16. the two-phase path: prepare_real + finetune under "on" -------
    data = volumes(np.random.default_rng(0), TRAIN_VOLUMES, scan.n_taus)
    cv.conv3x3.fwd_launches = cv.conv3x3.bwd_launches = 0
    fe.fused_elbo_forward.launches = fe.fused_elbo_backward.launches = 0
    trainer.finetune(data, epochs=2)
    torch.cuda.synchronize()
    n_steps = 2 * cfg.train.ft_steps_per_epoch
    n_conv = 2 * mcfg.no_intermediate_layers
    cropped = data_pipe.blank_crop(data)
    prior_fwd = n_conv * -(-cropped.shape[0] // 4)      # predict_priors chunks
    launches = {"H_fwd": cv.conv3x3.fwd_launches,
                "H_bwd": cv.conv3x3.bwd_launches,
                "F_fwd": fe.fused_elbo_forward.launches,
                "F_bwd": fe.fused_elbo_backward.launches}
    log(f"two-phase fine-tune (2 epochs x {cfg.train.ft_steps_per_epoch} "
        f"steps, fused_conv on) launches: {launches}; expected H "
        f"{n_conv * n_steps} + {prior_fwd} (prepare_real) forward, "
        f"{n_conv * n_steps} backward")
    if (launches["H_fwd"], launches["H_bwd"]) != (
            n_conv * n_steps + prior_fwd, n_conv * n_steps) or \
            (launches["F_fwd"], launches["F_bwd"]) != (n_steps, n_steps):
        raise AssertionError(f"H or F did not run as counted: {launches}")
    ft = [m for phase, m in logged if phase == "finetune"]
    if len(ft) != 2 or not all(np.isfinite(v) for m in ft for v in m.values()):
        raise AssertionError(f"fine-tune metrics: {ft}")
    epoch_on_ms = ft[1]["epoch_time_s"] * 1e3

    # one fine-tune step under "on" against "off" (cuDNN), on the card
    vol = torch.from_numpy(trainer.sampler.data).to(dev)
    pri = torch.from_numpy(trainer.sampler.priors).to(dev)
    batch = steps.sample_crop_batch(torch.Generator().manual_seed(7), vol,
                                    pri, cfg.train.ft_batch_size,
                                    cfg.train.crop_size)
    state = {k: v.clone() for k, v in trainer.tuner.state_dict().items()}
    result, tuners = {}, {}
    for name, c in (("on", cfg), ("off", off)):
        t = FineTuner(c.model, scan, device=dev)
        t.load_state_dict(state)
        opt = optim.make_finetune_optimizer(t.parameters(), c.train)
        result[name] = stepped(t, steps.make_finetune_step(t, c, opt)(
            batch, seed=11))
        tuners[name] = (t, opt, c)
    worst = check_step("one fine-tune step under fused_conv on vs off",
                       result["on"], result["off"], state,
                       float(cfg.train.ft_lr))
    log(f"one fine-tune step through H agrees with cuDNN: loss "
        f"{result['on'][0]:.7g} vs {result['off'][0]:.7g}, gradients within "
        f"{worst:.2e} of their scale, updates within tolerance")

    # ---- 17. stream-2 serving under "on" ----------------------------------
    serve = tuners["on"][0]
    serve.load_state_dict(pretrained)
    ref_tuner = tuners["off"][0]
    ref_tuner.load_state_dict(pretrained)
    reqs = [volumes(np.random.default_rng(21 + i), shape, scan.n_taus)
            for i, shape in enumerate(REQUESTS)]
    cv.conv3x3.fwd_launches = cv.conv3x3.bwd_launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        maps = [infer.save_predictions(serve, cfg, d, f"{tmp}/h{i}",
                                       use_first_op=False)
                for i, d in enumerate(reqs)]
        for i, (m, d) in enumerate(zip(maps, reqs)):
            check_maps(m, d.shape[:-1], f"{tmp}/h{i}")
    serve_launches = cv.conv3x3.fwd_launches
    chunks = sum(-(-shape[0] // 2) for shape in REQUESTS)
    log(f"stream-2 serving under fused_conv on: 3 requests, H launched "
        f"{serve_launches} times forward ({n_conv} a chunk of 2 subjects, "
        f"{chunks} chunks), {cv.conv3x3.bwd_launches} backward")
    if serve_launches != n_conv * chunks or cv.conv3x3.bwd_launches:
        raise AssertionError("stream-2 serving did not run H once a conv")
    flat = lambda d, k: torch.from_numpy(                         # noqa: E731
        d[k].reshape(-1, d[k].shape[-1]).astype(np.float64))
    means = lambda d: torch.cat([flat(d, k) for k in              # noqa: E731
                                 ("oef", "dbv", "r2p")], -1)
    for i, d in enumerate(reqs):
        ref = infer.posterior_maps(ref_tuner, d, use_first_op=False)
        check_close(f"request {i} H vs cuDNN", means(maps[i]), means(ref),
                    "mean")
        check_close(f"request {i} H vs cuDNN", flat(maps[i], "stds"),
                    flat(ref, "stds"), "var", means(ref))
    log("stream-2 maps through H agree with the maps through cuDNN")

    # ---- 18. timings ------------------------------------------------------
    log_clocks("before the two-phase timings")
    s2_walls = {}
    for name, tn in (("on", serve), ("off", ref_tuner)):
        s2_walls[name] = wall_ms(lambda: infer.posterior_maps(
            tn, reqs[0], use_first_op=False))
        log(f"posterior_maps stream 2 wall, fused_conv {name}: "
            f"{s2_walls[name]:.3f} ms on {REQUESTS[0]} [{card}]")
    profile(lambda: infer.posterior_maps(serve, reqs[0], use_first_op=False),
            2, "posterior_maps stream 2, fused_conv on", card)
    t = FineTuner(mcfg, scan, device=dev)
    t.load_state_dict(pretrained)
    opt = optim.make_pretrain_optimizer(t.named_parameters(), cfg.train)
    pt_step = steps.make_pretrain_step(t, cfg, opt)
    pt_step_ms = wall_ms(lambda: pt_step(big, seed=5))
    log(f"pretrain step (stream-1 loss + backward + AdamW) wall "
        f"{pt_step_ms:.3f} ms at batch {cfg.train.pt_batch_size} x "
        f"{tuple(big['x'].shape[1:4])} [{card}]")
    profile(lambda: pt_step(big, seed=5), 5, "pretrain step", card)
    walls, ft_steps = {}, {}
    for name, (tn, opt, c) in tuners.items():
        ft_steps[name] = steps.make_finetune_step(tn, c, opt)
        walls[name] = wall_ms(lambda: ft_steps[name](batch, seed=13))
        log(f"fine-tune step wall, fused_conv {name}: {walls[name]:.3f} ms at "
            f"batch {cfg.train.ft_batch_size} [{card}]")
    profile(lambda: ft_steps["on"](batch, seed=13), 5,
            "fine-tune step, fused_conv on", card)
    log(f"fine-tune epoch wall, fused_conv on: {epoch_on_ms:.1f} ms "
        f"({cfg.train.ft_steps_per_epoch} steps) [{card}]")
    log_clocks("after the two-phase timings")

    shape = CONV_SHAPES[0]
    times = conv["times"]
    kernels = [{
        "name": f"conv3x3_{'forward' if way == 'fwd' else 'backward'}",
        "route": "cuda", "source": "qbold_vi_tpu_torch/csrc/conv3x3.cu",
        "replaces": f"qbold_vi_tpu/ops/pallas_conv.py:{line}",
        "launches": launches[f"H_{way}"], "max_abs_err": conv[f"err_{way}"],
        "ms": times[way][0], "plain_ms": times[way][1],
        **conv_bound(shape, way == "bwd"), "library_ms": times[way][2]}
        for way, line in (("fwd", 188), ("bwd", 239))]
    return {"kernels": kernels, "pretrain_step_ms": pt_step_ms,
            "pretrain_epoch_s": [m["epoch_time_s"] for m in pt],
            "pretrain_data_s": pt[0]["data_time_s"],
            "finetune_step_ms": walls, "finetune_epoch_on_ms": epoch_on_ms,
            "serve_launches": serve_launches, "stream2_wall_ms": s2_walls}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--weights", help="params .npz (io/from_jax.py "
                    "save_params_npz); default: init_params seed 0")
    args = ap.parse_args()

    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        log("no CUDA device: this smoke run needs the card")
        return 1
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = gpu_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"card: {card}")

    from qbold_vi_tpu_torch import OPTIMAL, FineTuner, init_params
    from qbold_vi_tpu_torch import infer
    from qbold_vi_tpu_torch.io import from_jax
    from qbold_vi_tpu_torch.ops import _cuda
    from qbold_vi_tpu_torch.ops import fused_infer as fi
    from qbold_vi_tpu_torch.ops import quadrature as quad

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    _cuda.library()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for line in _cuda.build_log().splitlines():
        if "registers" in line or "Function properties" in line \
                or "spill" in line:
            log("  nvcc: " + line.strip())

    cfg, scan = OPTIMAL.model, OPTIMAL.scan
    dwc = float(scan.dw_coeff * scan.hct)
    ranges = dict(mvg=cfg.use_mvg, oef_range=cfg.oef_range,
                  min_oef=cfg.min_oef, dbv_range=cfg.dbv_range,
                  min_dbv=cfg.min_dbv, dw_coeff=dwc)
    tuner = FineTuner(cfg, scan, device=dev)
    if args.weights:
        state = from_jax.state_dict_from_jax(
            from_jax.load_params_npz(args.weights))
    else:
        state = init_params(cfg, scan, torch.Generator().manual_seed(0))
    tuner.load_state_dict(state)
    enc_kw = dict(se_idx=scan.se_idx,
                  multi_image=cfg.multi_image_normalisation,
                  activation=cfg.activation,
                  n_blocks=cfg.no_intermediate_layers, trunk="float32")
    rng = np.random.default_rng(0)
    err = {"quad": 0.0, "fused": 0.0}

    # ---- 3. kernel vs plain on the card ----------------------------------
    with torch.no_grad():
        for n in (N_FULL, N_RAGGED):
            q = torch.from_numpy(raw_head(rng, n)).to(dev)
            for mvg in (True, False):
                kw = dict(ranges, mvg=mvg)
                m, v = quad.quad_posterior_summaries(q, **kw)
                mr, vr = quad.posterior_summaries_quadrature(q, **kw)
                e = max(check_close(f"A n={n} mvg={mvg}", m, mr, "mean"),
                        check_close(f"A n={n} mvg={mvg}", v, vr, "var", mr))
                if n == N_FULL and mvg:
                    err["quad"] = e
            torch.cuda.synchronize()
            log(f"kernel A vs plain ok at N={n} (mvg and diag)")
            x = volumes(rng, (n,), scan.n_taus)
            for layout in ("voxel", "channel"):
                xt = torch.from_numpy(x).to(dev)
                if layout == "channel":
                    xt = xt.T.contiguous()
                kw = dict(enc_kw, **ranges, mask_channel=True,
                          input_layout=layout)
                got = fi.encode_quad_fused(xt, tuner.encoder, **kw)
                ref = fi.encode_quad_fused_plain(xt, tuner.encoder, **kw)
                tag = f"B n={n} {layout}"
                e = max(check_close(tag, got[0].T, ref[0].T, "mean"),
                        check_close(tag, got[1].T, ref[1].T, "var",
                                    ref[0].T),
                        check_close(tag, got[2].T, ref[2].T, "raw"))
                if n == N_FULL and layout == "voxel":
                    err["fused"] = e
            torch.cuda.synchronize()
            log(f"kernel B vs plain ok at N={n} (voxel and channel layouts,"
                " mask channel)")

    # ---- 4. main path ----------------------------------------------------
    fi.encode_quad_fused.launches = 0
    quad.quad_posterior_summaries.launches = 0
    reqs = [volumes(rng, shape, scan.n_taus) for shape in REQUESTS]
    small = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, data in enumerate(reqs):
            for first in (True, False):
                prefix = f"{tmp}/req{i}_{'s1' if first else 's2'}"
                maps = infer.save_predictions(tuner, OPTIMAL, data, prefix,
                                              use_first_op=first)
                check_maps(maps, data.shape[:-1], prefix)
                if i == len(reqs) - 1:
                    small[first] = maps
                log(f"request {i} {data.shape[:-1]} stream "
                    f"{1 if first else 2}: ok, mean OEF "
                    f"{maps['oef'].mean():.4f}")
    launches = {"fused": fi.encode_quad_fused.launches,
                "quad": quad.quad_posterior_summaries.launches}
    log(f"main-path launches: {launches}")
    if launches["fused"] == 0 or launches["quad"] == 0:
        raise AssertionError(f"a kernel of the path never ran: {launches}")

    # the smallest request against the plain versions on the CPU
    cpu = FineTuner(cfg, scan, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in tuner.state_dict().items()})
    for first in (True, False):
        ref = infer.posterior_maps(cpu, reqs[-1], use_first_op=first)
        got = small[first]
        flat = lambda d, k: torch.from_numpy(                   # noqa: E731
            d[k].reshape(-1, d[k].shape[-1]).astype(np.float64))
        means = lambda d: torch.cat([flat(d, k) for k in          # noqa: E731
                                     ("oef", "dbv", "r2p")], -1)
        check_close(f"stream {1 if first else 2} vs CPU", means(got),
                    means(ref), "mean")
        check_close(f"stream {1 if first else 2} vs CPU", flat(got, "stds"),
                    flat(ref, "stds"), "var", means(ref))
        log(f"stream {1 if first else 2} maps agree with the CPU plain "
            "versions")

    # ---- 5. timings ------------------------------------------------------
    log_clocks("before the serving timings")
    times = {}
    with torch.no_grad():
        q = torch.from_numpy(raw_head(rng, N_FULL)).to(dev)
        times["quad"] = time_kernel(
            lambda: quad.quad_posterior_summaries(q, **ranges),
            "qv_quad_kernel",
            lambda: quad.posterior_summaries_quadrature(q, **ranges))
        x = torch.from_numpy(volumes(rng, (N_FULL,), scan.n_taus)).to(dev)
        kw = dict(enc_kw, **ranges, mask_channel=True, input_layout="voxel")
        times["fused"] = time_kernel(
            lambda: fi.encode_quad_fused(x, tuner.encoder, **kw),
            "qv_encode_quad_kernel",
            lambda: fi.encode_quad_fused_plain(x, tuner.encoder, **kw))
        raw_b = fi.encode_quad_fused(x, tuner.encoder, **kw)[2]
    big = reqs[0]
    walls = {f"stream{1 if first else 2}": wall_ms(
        lambda: infer.posterior_maps(tuner, big, use_first_op=first))
        for first in (True, False)}
    log_times(times, N_FULL, card)
    for k, ms in walls.items():
        log(f"posterior_maps {k} wall {ms:.2f} ms on {REQUESTS[0]} "
            f"(1.03 M voxels, host upload and copy back included) [{card}]")
    for first in (True, False):
        profile(lambda: infer.posterior_maps(tuner, big, use_first_op=first),
                2, f"posterior_maps stream {1 if first else 2} on "
                f"{REQUESTS[0]}", card)

    # A reads 5 floats and writes 6 a voxel; B reads T + 1 and writes 9
    kernels = [
        {"name": "quad_posterior_summaries", "route": "cuda",
         "source": "qbold_vi_tpu_torch/csrc/quadrature.cu",
         "replaces": "qbold_vi_tpu/ops/quadrature.py:518",
         "launches": launches["quad"], "max_abs_err": err["quad"],
         "ms": times["quad"][0], "plain_ms": times["quad"][2],
         **bound(N_FULL * 4 * 11,
                 ops_quad(squashed(q, cfg.use_mvg), cfg.use_mvg)),
         "library_ms": None},
        {"name": "encode_quad_fused", "route": "cuda",
         "source": "qbold_vi_tpu_torch/csrc/encode_quad.cu",
         "replaces": "qbold_vi_tpu/ops/pallas_infer.py:353",
         "launches": launches["fused"], "max_abs_err": err["fused"],
         "ms": times["fused"][0], "plain_ms": times["fused"][2],
         **bound(N_FULL * 4 * (scan.n_taus + 1 + 9),
                 ops_encode_quad(cfg.no_units, scan.n_taus,
                                 cfg.no_intermediate_layers, raw_b,
                                 cfg.use_mvg)),
         "library_ms": None},
    ]
    sampled = sampled_phases(dev, card, OPTIMAL, tuner, ranges, enc_kw)
    kernels += sampled["kernels"]
    phases = fine_tune_phases(dev, card, OPTIMAL, tuner)
    kernels += phases["kernels"]
    conv = conv_phases(dev, card)
    two = two_phase_path(dev, card, OPTIMAL, conv)
    kernels += two["kernels"]
    print(json.dumps({"posterior_maps_wall_ms": walls,
                      "mc_posterior_maps_wall_ms": sampled["mc_walls"],
                      "elbo_maps_wall_ms_per_subject": sampled["elbo_ms"],
                      "finetune_step_ms": phases["step_ms"],
                      "finetune_epoch_wall_ms": phases["epoch_ms"],
                      "pretrain_step_ms": two["pretrain_step_ms"],
                      "pretrain_epoch_s": two["pretrain_epoch_s"],
                      "pretrain_data_s": two["pretrain_data_s"],
                      "finetune_step_ms_by_conv": two["finetune_step_ms"],
                      "finetune_epoch_wall_ms_conv_on":
                          two["finetune_epoch_on_ms"],
                      "stream2_wall_ms_by_conv": two["stream2_wall_ms"],
                      "card": card}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
