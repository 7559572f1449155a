"""At-scale two-phase validation of the PyTorch port on one CUDA card: the
full published schedule on physically generated fake brains, end to end
through ``Trainer``, checked against the generating parameters and
against the classical WLS fit of the same volumes.

    python3 tools/validate_finetune_torch.py [--seed N] [--fused-conv MODE]
        [--fused-elbo MODE] [--compute-dtype float32|bfloat16]
        [--ft-epochs N] [--pt-epochs N] [--out DIR [--resume]]

Run it from the repository's root on the machine with the card (``env
PYTHONPATH=. python3 tools/validate_finetune_torch.py --seed 1``). The
counterpart of benchmarks/validate_finetune.py, with its setup:

* 6 subjects of 64 x 64 x 8 from smooth low-frequency (OEF, DBV) fields
  (OEF in [0.2, 0.6], DBV in [0.01, 0.12]) and an elliptical mask,
  decoded by ``ops.physics.ase_signal``, x 800, plus Gaussian noise of
  the mean signal / 80, all drawn by numpy from seed 0;
* OPTIMAL with the streaming pretrain (``pt_on_device_synth``: a fresh
  batch a step through kernel S), 30 pretrain epochs, 40 fine-tune epochs
  of 100 steps, acquisition noise in the synthetic data, the trunk in
  float32 or, with ``--compute-dtype bfloat16``, in bf16 (the JAX script's
  bf16 A/B, benchmarks/validate_finetune.py:70);
* ``Trainer.pretrain`` -> ``finetune(data, study_data=data[:2])`` ->
  ``infer.posterior_maps(use_first_op=False)`` -> ``save_predictions(
  fine_tuned=True, priors=...)`` with the priors of the fine-tuned
  encoder.

With ``--out DIR`` the checkpoints go to DIR too (the Trainer's
save_directory): a run trains fresh, removing the checkpoints DIR holds,
unless ``--resume`` asks to resume them (pt_model.msgpack skips the
pretrain, final_model.msgpack the fine-tune), as the JAX script's
``--resume`` does (benchmarks/validate_finetune.py:78).

Prints the masked posterior-mean |OEF err|, |DBV err| and their
correlations with the truth; the WLS anchor (``baseline.wls_maps`` on
the same volumes: its own errors and correlations, and the VI maps'
correlation with it); the pretrain wall, the fine-tune wall and epoch,
the export wall; the launches of kernels S, F, H (float32 and bf16), A
and E; the card's name and power limit; and as its last line one JSON
object of all of them. Exits 1 without a card, and 2 when a quality
number lies outside the floors (|OEF err| <= 0.10, OEF corr >= 0.60,
|DBV err| <= 0.019, DBV corr >= 0.84: the JAX record's worst of four
runs, benchmarks/RESULTS.md:377-380, loosened by 7-12%).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

FLOORS = dict(oef_err=0.10, oef_corr=0.60, dbv_err=0.019, dbv_corr=0.84)


def make_subjects(scan, n=6, x=64, y=64, z=8, seed=0):
    """(data (n, x, y, z, T + 1) with a trailing mask channel, oef, dbv,
    mask), benchmarks/validate_finetune.py's subjects."""
    from qbold_vi_tpu_torch.ops import physics

    rng = np.random.default_rng(seed)

    def smooth_field(lo, hi):
        coarse = rng.uniform(0, 1, size=(n, 8, 8, 4))
        f = np.stack([np.kron(c, np.ones((x // 8, y // 8, z // 4)))
                      for c in coarse])
        return (lo + (hi - lo) * f).astype(np.float32)

    oef = smooth_field(0.2, 0.6)
    dbv = smooth_field(0.01, 0.12)
    xx, yy = np.meshgrid(np.linspace(-1, 1, x), np.linspace(-1, 1, y),
                         indexing="ij")
    mask2d = ((xx ** 2 + yy ** 2) < 0.85).astype(np.float32)
    mask = np.broadcast_to(mask2d[None, :, :, None, None],
                           (n, x, y, z, 1)).astype(np.float32)
    with torch.no_grad():
        sig = physics.ase_signal(torch.from_numpy(oef),
                                 torch.from_numpy(dbv), scan).numpy() * 800.0
    noise = rng.normal(size=sig.shape).astype(np.float32) * sig.mean() / 80.0
    data = np.concatenate([(sig + noise) * mask, mask], -1)
    return data.astype(np.float32), oef, dbv, mask[..., 0]


def quality(maps_oef, maps_dbv, oef, dbv, m) -> dict:
    return {"oef_err": float(np.abs(maps_oef - oef)[m].mean()),
            "oef_corr": float(np.corrcoef(maps_oef[m], oef[m])[0, 1]),
            "dbv_err": float(np.abs(maps_dbv - dbv)[m].mean()),
            "dbv_corr": float(np.corrcoef(maps_dbv[m], dbv[m])[0, 1])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=None,
                    help="train.seed (default: OPTIMAL's)")
    ap.add_argument("--fused-conv", default="auto",
                    choices=["auto", "on", "off"],
                    help="the trunk's 3x3 convs: kernel H (on) or cuDNN")
    ap.add_argument("--fused-elbo", default="auto",
                    help="fused_elbo mode (auto|on|off|host)")
    ap.add_argument("--compute-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="the encoder trunk's compute dtype")
    ap.add_argument("--pt-epochs", type=int, default=30)
    ap.add_argument("--ft-epochs", type=int, default=40)
    ap.add_argument("--out", default=None,
                    help="export and checkpoint directory (default: a "
                         "temporary one)")
    ap.add_argument("--resume", action="store_true",
                    help="resume the checkpoints already in --out (default: "
                         "remove them and train fresh, so that a stale "
                         "final_model.msgpack of another run is never "
                         "reported under this run's flags)")
    args = ap.parse_args()
    if args.resume and not args.out:
        ap.error("--resume needs --out")

    if not torch.cuda.is_available():
        print("no CUDA device: this validation runs on the card", flush=True)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]

    from qbold_vi_tpu_torch import OPTIMAL, baseline, infer
    from qbold_vi_tpu_torch.ops import conv3x3, fused_elbo, quadrature
    from qbold_vi_tpu_torch.ops import summarize, synth_batch
    from qbold_vi_tpu_torch.train import data as data_pipe
    from qbold_vi_tpu_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        save = args.out or tmp
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            stale = glob.glob(os.path.join(args.out, "*.msgpack*"))
            if not args.resume:
                for path in stale:
                    os.remove(path)
                if stale:
                    print(f"removed {len(stale)} stale checkpoint(s) from "
                          f"{args.out} (pass --resume to resume them)",
                          flush=True)
        train = dict(pt_on_device_synth=True, no_pt_epochs=args.pt_epochs,
                     no_ft_epochs=args.ft_epochs, save_directory=save,
                     fused_elbo=args.fused_elbo)
        if args.seed is not None:
            train["seed"] = args.seed
        cfg = dataclasses.replace(
            OPTIMAL,
            model=dataclasses.replace(OPTIMAL.model,
                                      fused_conv=args.fused_conv,
                                      compute_dtype=args.compute_dtype),
            train=dataclasses.replace(OPTIMAL.train, **train),
            scan=dataclasses.replace(OPTIMAL.scan, simulate_noise=True))
        data, oef_true, dbv_true, mask = make_subjects(cfg.scan)
        m = mask > 0
        counters = ((synth_batch.synth_batch, "launches"),
                    (synth_batch.synth_batch, "noise_launches"),
                    (fused_elbo.fused_elbo_forward, "launches"),
                    (fused_elbo.fused_elbo_backward, "launches"),
                    (conv3x3.conv3x3, "fwd_launches"),
                    (conv3x3.conv3x3, "bwd_launches"),
                    (conv3x3.conv3x3, "fwd_bf16_launches"),
                    (conv3x3.conv3x3, "bwd_bf16_launches"),
                    (quadrature.quad_posterior_summaries, "launches"),
                    (summarize.mc_kl_map, "launches"))
        for fn, attr in counters:
            setattr(fn, attr, 0)

        tr = Trainer(cfg, logger=lambda *a: None)
        resumed = tr.status.name
        t0 = time.perf_counter()
        pt = tr.pretrain()
        torch.cuda.synchronize()
        t_pt = time.perf_counter() - t0
        print(f"pretrain: {t_pt:.1f} s ({cfg.train.no_pt_epochs} epochs, "
              f"last val_loss {pt.get('val_loss', float('nan')):.5g}; "
              f"started {resumed}) [{card}]", flush=True)

        epochs = []
        tr.logger = lambda phase, e, mt: epochs.append(mt["epoch_time_s"])
        t0 = time.perf_counter()
        tr.finetune(data, study_data=data[:2])
        torch.cuda.synchronize()
        t_ft = time.perf_counter() - t0
        epoch_s = float(np.median(epochs)) if epochs else float("nan")
        print(f"finetune ({cfg.train.no_ft_epochs} epochs x "
              f"{cfg.train.ft_steps_per_epoch} steps): {t_ft:.1f} s, epoch "
              f"{epoch_s:.3f} s median [{card}]", flush=True)

        maps = infer.posterior_maps(tr.tuner, data, seed=9,
                                    use_first_op=False)
        k = 5 if cfg.model.use_mvg else 4
        priors = data_pipe.predict_priors(tr._encode_fn(), data, k)
        out = args.out or tmp
        t0 = time.perf_counter()
        infer.save_predictions(tr.tuner, cfg, data, out + "/pred", seed=10,
                               use_first_op=False, fine_tuned=True,
                               priors=priors)
        torch.cuda.synchronize()
        t_ex = time.perf_counter() - t0
        print(f"fine-tuned export ({data.shape[0]} subjects): {t_ex:.1f} s "
              f"[{card}]", flush=True)

    vi = quality(maps["oef"][..., 0], maps["dbv"][..., 0], oef_true,
                 dbv_true, m)
    t0 = time.perf_counter()
    wls = baseline.wls_maps(data[..., :-1], cfg.scan)
    t_wls = time.perf_counter() - t0
    anchor = quality(wls[..., 0], wls[..., 1], oef_true, dbv_true, m)
    vs_wls = {
        "oef_corr": float(np.corrcoef(maps["oef"][..., 0][m],
                                      wls[..., 0][m])[0, 1]),
        "dbv_corr": float(np.corrcoef(maps["dbv"][..., 0][m],
                                      wls[..., 1][m])[0, 1])}
    launches = {f"{fn.__name__}.{attr}": getattr(fn, attr)
                for fn, attr in counters}
    print(f"masked posterior-mean quality: |OEF err|={vi['oef_err']:.4f} "
          f"(corr {vi['oef_corr']:.3f}), |DBV err|={vi['dbv_err']:.4f} "
          f"(corr {vi['dbv_corr']:.3f})", flush=True)
    print(f"WLS anchor: |OEF err|={anchor['oef_err']:.4f} (corr "
          f"{anchor['oef_corr']:.3f}), |DBV err|={anchor['dbv_err']:.4f} "
          f"(corr {anchor['dbv_corr']:.3f}); VI against WLS: OEF corr "
          f"{vs_wls['oef_corr']:.3f}, DBV corr {vs_wls['dbv_corr']:.3f}; "
          f"WLS wall {t_wls:.3f} s", flush=True)
    print(f"launches: {launches}", flush=True)
    print(f"card: {card}", flush=True)
    failed = [k for k, v in FLOORS.items()
              if (vi[k] > v if k.endswith("err") else vi[k] < v)]
    print(json.dumps({
        "seed": cfg.train.seed, "resumed_from": resumed,
        "fused_conv": args.fused_conv,
        "fused_elbo": args.fused_elbo, "compute_dtype": args.compute_dtype,
        "quality": vi, "wls": anchor,
        "vi_vs_wls": vs_wls, "pretrain_s": t_pt, "finetune_s": t_ft,
        "finetune_epoch_s": epoch_s, "export_s": t_ex, "wls_s": t_wls,
        "launches": launches, "floors": FLOORS, "failed": failed,
        "card": card}), flush=True)
    if failed:
        print(f"outside the floors: {failed}", file=sys.stderr, flush=True)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
