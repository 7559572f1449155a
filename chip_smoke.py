"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--weights params.npz]

Drives the port's serving path -- ``qbold_vi_tpu_torch.infer.
save_predictions`` at the published OPTIMAL width (60 units x 2 blocks,
11 taus, MVG head), with random weights from a fixed seed or a converted
JAX checkpoint -- through both hand-written kernels, and checks it:

1. device: a CUDA card is required (otherwise exit 1, no result line);
2. build: both kernels are compiled from csrc/ by nvcc;
3. kernel vs plain: each kernel against its plain torch version on the
   card at 1,032,192 and 1,000,003 voxels (tolerances in CHECKS);
4. main path: three export requests per encoder stream, with the launch
   counters reset before and read after; maps must be finite, in range,
   written to NIfTI and read back equal, and the smallest request must
   agree with the plain versions run on the CPU;
5. timings: CUDA events (warm-up, median of 7 blocks) for each kernel
   and its plain version, and the host wall of posterior_maps on the
   1.03 M-voxel request.

Prints the card's name and power limit, one JSON line with the kernel
table, and as its last line {"ok": true, "device": {...}}. Any failure
exits non-zero before that line.
"""

from __future__ import annotations

import argparse
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


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def volumes(rng, shape, n_taus):
    data = (np.abs(rng.normal(size=shape + (n_taus + 1,)))
            .astype(np.float32) * 50.0 + 100.0)
    data[..., -1] = rng.uniform(size=shape) > 0.2
    return data


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
    from qbold_vi_tpu_torch.io import from_jax, nifti
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
                shape = data.shape[:-1]
                want = {"oef": 1, "dbv": 1, "r2p": 1, "stds": 3,
                        "raw_log_stds": 3}
                for key, c in want.items():
                    if maps[key].shape != shape + (c,):
                        raise AssertionError(f"{key} shape {maps[key].shape}")
                    if not np.isfinite(maps[key]).all():
                        raise AssertionError(f"{key} not finite")
                if not (0.04 <= maps["oef"].min()
                        and maps["oef"].max() <= 0.84):
                    raise AssertionError("OEF outside [0.04, 0.84]")
                if not (0.001 <= maps["dbv"].min()
                        and maps["dbv"].max() <= 0.201):
                    raise AssertionError("DBV outside [0.001, 0.201]")
                if maps["stds"].min() < 0:
                    raise AssertionError("negative posterior variance")
                back = nifti.load_nifti(prefix + "_oef.nii.gz")
                folded = np.concatenate(
                    np.split(maps["oef"], shape[0], 0), -1)[0]
                if not np.array_equal(back, folded):
                    raise AssertionError("NIfTI read-back differs")
                if i == len(reqs) - 1:
                    small[first] = maps
                log(f"request {i} {shape} stream {1 if first else 2}: ok, "
                    f"mean OEF {maps['oef'].mean():.4f}")
    launches = {"fused": fi.encode_quad_fused.launches,
                "quad": quad.quad_posterior_summaries.launches}
    log(f"main-path launches: {launches}")
    if launches["fused"] == 0 or launches["quad"] == 0:
        raise AssertionError(f"a kernel of the path never ran: {launches}")

    # the smallest request against the plain versions on the CPU
    cpu = FineTuner(cfg, scan)
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
    times = {}
    with torch.no_grad():
        q = torch.from_numpy(raw_head(rng, N_FULL)).to(dev)
        times["quad"] = (
            cuda_ms(lambda: quad.quad_posterior_summaries(q, **ranges)),
            cuda_ms(lambda: quad.posterior_summaries_quadrature(q, **ranges),
                    reps=2, blocks=5))
        x = torch.from_numpy(volumes(rng, (N_FULL,), scan.n_taus)).to(dev)
        kw = dict(enc_kw, **ranges, mask_channel=True, input_layout="voxel")
        times["fused"] = (
            cuda_ms(lambda: fi.encode_quad_fused(x, tuner.encoder, **kw)),
            cuda_ms(lambda: fi.encode_quad_fused_plain(x, tuner.encoder,
                                                       **kw),
                    reps=2, blocks=5))
    big = reqs[0]
    walls = {f"stream{1 if first else 2}": wall_ms(
        lambda: infer.posterior_maps(tuner, big, use_first_op=first))
        for first in (True, False)}
    for k, (ms, plain) in times.items():
        log(f"{k}: kernel {ms:.4f} ms, plain {plain:.4f} ms at N={N_FULL} "
            f"[{card}]")
    for k, ms in walls.items():
        log(f"posterior_maps {k} wall {ms:.2f} ms on {REQUESTS[0]} "
            f"(1.03 M voxels, host upload and copy back included) [{card}]")

    table = {"kernels": [
        {"name": "quad_posterior_summaries", "route": "cuda",
         "source": "qbold_vi_tpu_torch/csrc/quadrature.cu",
         "replaces": "qbold_vi_tpu/ops/quadrature.py:518",
         "launches": launches["quad"], "max_abs_err": err["quad"],
         "ms": times["quad"][0], "plain_ms": times["quad"][1]},
        {"name": "encode_quad_fused", "route": "cuda",
         "source": "qbold_vi_tpu_torch/csrc/encode_quad.cu",
         "replaces": "qbold_vi_tpu/ops/pallas_infer.py:353",
         "launches": launches["fused"], "max_abs_err": err["fused"],
         "ms": times["fused"][0], "plain_ms": times["fused"][1]},
    ]}
    print(json.dumps({"posterior_maps_wall_ms": walls, "card": card}),
          flush=True)
    print(json.dumps(table), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
