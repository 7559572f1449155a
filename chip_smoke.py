"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--weights params.npz]

Drives the port's main paths at the published OPTIMAL width (60 units x
2 blocks, 11 taus, MVG head), with random weights from a fixed seed or a
converted JAX checkpoint: serving by quadrature (``infer.save_predictions``,
kernels A and B), serving by sampling and the fine-tuned export
(``save_predictions(method="mc")`` and ``(fine_tuned=True, priors=...)``,
kernels C, D and E), ELBO fine-tuning (``train.trainer.Trainer``, kernels
F and G, forward and backward; G on the configuration F leaves out, a
diagonal posterior with a population prior), the two-phase pipeline
from scratch
(``Trainer.pretrain`` -> ``finetune`` with the 3x3 convs through kernel H,
forward and backward), the streaming pretrain (a fresh batch a step
through kernel S), the WLS baseline, and the trunk in bf16
(``compute_dtype="bfloat16"``: kernels B, C and H at bf16 on serving,
fine-tuning and pretraining), the command line (``cli.main``: train
with its checkpoints and their resume, infer and serve), dropout
training, the serving artifacts (``torch.export``; kernel B as a
registered op) and the CLI's synth / transfer / import-weights, and the
data-parallel layer (qbold_vi_tpu_torch/parallel: the sharded steps,
maps and Trainer on one rank over NCCL, on two ranks sharing the card,
and through ``train --mesh``), and the sweep (populations of trials through
kernel S's trial axis and one kernel-F call a step, the searches, the
CLI's sweep, the wandb agent, trials over two ranks), and checks them:

1. device: a CUDA card is required (otherwise exit 1, no result line);
2. build: the kernels of all ten sources in csrc/ are compiled by nvcc;
   kernels A, B, E and G must hold the static MUFU instructions
   (cuobjdump) that the special-function bounds' counts were read with
   (MUFU_SASS);
3. kernel vs plain: A and B against their plain torch versions on the
   card at 1,032,192 and 1,000,003 voxels (tolerances in CHECKS), A on
   heads straddling the s = 1.5 split, entirely below and entirely above
   it, and at 1,032,192 MVG voxels against a float64 evaluation of the
   same node words beside the plain version's error;
4. main path: three export requests per encoder stream, with the launch
   counters reset before and read after; maps must be finite, in range,
   written to NIfTI and read back equal, and the smallest request must
   agree with the plain versions run on the CPU;
5. timings: each kernel's device time (the median launch in a profiler
   trace of 21 calls), its wrapper's and its plain version's time a call
   (CUDA events, warm-up, median of 7 blocks), and the host wall of
   posterior_maps on the 1.03 M-voxel request; the share of A's and B's
   timed problems on each side of the split, and A's and B's bounds;
6. F and G against their plain versions at the fine-tune shapes: F at
   190,000 voxels (38 crops of 25 x 25 x 8 through the encoder; MVG,
   s_nll 1, s_kl 70, host noise) and at a ragged 190,003 (diagonal; and
   Student-t df 2 + multi-image normalisation + s_nll 2); G at 190,000 on
   OPTIMAL's MVG draws and on the path it serves, a diagonal posterior
   with a population prior (rows from that configuration's encoder), at
   190,000, at a ragged 190,003 and under Student-t df 2 + multi-image
   normalisation + no_samples 2 (380,000 rows), each backward with dy
   asked for and not; rows at rtol 1e-5 / atol 1e-5, gradients
   scale-normalised at rtol 5e-4 / atol 5e-5;
7. F's device noise: the Philox draws are philox_normals' (rows against
   the plain version fed them, rtol 1e-4: numpy's log/sin/cos on the host
   against the card's), a seed replays rows and gradients bit for bit,
   another seed differs, and the mean over masked voxels of kl_rows -
   mvg_kl_closed_form lies within 5 standard errors of 0;
8. the training main path: Trainer.prepare_real + Trainer.finetune, 2
   epochs x 100 steps at batch 38 with device noise, on 6 x 96 x 96 x 8
   volumes from seed 0 (F forward and backward launched once per step,
   every backward from the forward's KL state), then a 10-step epoch with
   fused_elbo="off" (G launched), then one step on the card against the
   same step on the CPU plain path (check_step: softplus from the
   initial weights, gradients at GRAD_TOL; relu from the trained
   weights, within 1e-2 of their scale); then the diagonal posterior
   with a population prior from its own initial weights (seed 0):
   Trainer.finetune (prepare_real, then 1 epoch x 100 steps) on the same
   volumes with fused_elbo and fused_decode_nll "auto", G forward and
   backward launched once a step and F never, metrics finite, the
   parameters moved (pop_prior among them), and one step on the card
   against the CPU (check_step, G launched in each card step);
9. timings: F and G forward and backward against their plain versions
   (G on the rows of the path it serves, its backward without dy, as
   that path runs it, and with dy), one fine-tune step, and the wall of
   one 100-step epoch; the step wall, its profile (the device's busy
   share) and the epoch wall of the diagonal + population prior path; G
   beside its bytes bound (with and without dy), its operations bound and
   its special-function bound;
10. C against its plain version at 1,032,192 and 1,000,003 voxels (both
   layouts, mask channel); D (both layouts, MVG and diagonal, antithetic
   and iid, S = 200) and E (S = 100) against their plain versions fed
   mc_philox_normals at 65,536 and 65,537 voxels (means and KL rows at
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
   pretrain step on the card against the CPU (check_step);
16. then Trainer.finetune (prepare_real + 2 x 100 steps) through kernels H
   and F, launches asserted (4 H forward and backward a step, 4 forward a
   prepare_real chunk, F once a step, every F backward from the KL
   state), and one step through H against the same step through cuDNN
   (check_step);
17. stream-2 save_predictions on the three requests under fused_conv="on"
   (4 H launches a chunk), maps against cuDNN's at the map tolerances;
18. timings: the stream-2 posterior_maps wall under "on" and "off", the
   pretrain step, the fine-tune step both ways, the epoch under "on".

Kernel F's KL state (run with phases 6-9): the MVG forward writes per
voxel the moments of its KL draws and a flag "some draw clamped", and the
backward given them forms the KL side of an unflagged voxel in closed
form (ops/fused_elbo.py). In each MVG case of phase 6 the backward runs
without the state (every draw replayed) and from it:
19. F on the fold's rows with q means moved near and past +-kl_bound, so
   that some or all KL draws of most voxels clamp: rows, both backwards
   and the state against the plain versions, the flags exactly;
20. F on the fold with runs of 64 dead voxels (whole warps) and on a
   fold with every voxel dead: dead voxels' rows and gradients are 0, as
   the plain version's;
21. the backward with and without the state (every voxel's KL draws
   replayed on its own lanes), against each other at GRAD_TOL and against
   the plain version (phases 6, 19, 20), and with device noise: the state
   replays bit for bit;
22. F's device times at the fold, forward (writing the state) and
   backward (from it, and replaying every draw), under device and host
   noise, beside the function's bound on this run's data and the counts
   of this design's work and of replaying every draw (bound_elbo).

Kernels B and C (the stream-1 encode on the tensor cores, 3xTF32) and D
and E (one Philox block for two draw pairs), after phase 13:
23. B's raw rows and C's q at 1,032,192 voxels against a float64 encode
   of the same rows (encode_q_f64): the kernels' largest errors beside the
   plain version's (float32, TF32 off), each within CHECKS["raw"];
24. B and C against their plain versions at U = 13 and 30 (padded to 16
   and 32 in the kernel) under gelu and softplus (act(0) != 0 on padded
   channels), both layouts, N = 1,000,003 (a ragged tile of 32); a
   stream-1 request at 256 units under fused_infer "auto" through kernel
   B's wgmma design (B launched, A not) against the CPU at rtol 1e-3 /
   atol 3e-5, and a forced "on" giving the same maps;
25. D at S = 2, 7 (odd: iid) and 200, both layouts, and E at S = 2, 7
   and 100, against their plain versions fed mc_philox_normals (E also fed
   host normals) at 65,536 and 65,537 voxels; each replays bit for bit and
   a cut at a voxel offset draws what the whole request does.
Kernel S (the streaming synthetic batch, csrc/synth_batch.cu; no TPU
kernel behind it: the JAX package's batch is XLA-fused inside its step)
and the modules around it, after phase 18:
26. S against its plain version (train/steps.py::stream_synthetic_batch)
   fed the host replay of S's draws (ops/synth_batch.py::
   synth_philox_draws) at OPTIMAL's full batch (512 x 500 voxels) and at
   16 x 500 with uniform_prop 0.3 and misalign_prob 0.5 (every branch),
   with the Chebyshev rule and with gj16 and no noise: x and y at rtol
   1e-5 / atol 1e-5, a seed replays bit for bit, the labels lie in the
   mixture's ranges with R2' = (k OEF) DBV, and the OEF and DBV means lie
   within 6 standard errors of the mixture's;
27. Trainer.pretrain in streaming mode (pt_on_device_synth), 2 epochs x
   22 steps at batch 512, S and its noise pass launched once a step (the
   counts set to 0 before and read after), metrics finite, and the fold's
   validation (pretrain_val_metrics(fold=True)); the streaming step's wall
   and profile (busy share, launches a step); one streaming step on the
   card (S) against the CPU (the plain version of S's replayed draws)
   from one seed (check_step: softplus from the initial weights at
   GRAD_TOL, relu from the trained ones within 1e-2); S's device time,
   pass by pass (pass 1 with the last block's reduction of the mean, the
   noise pass), beside its bound (the function's bytes: y and x written
   once) and this design's count (x read and written again by the noise
   pass, synth_bound), its launches a step, and its plain version's time
   and launches a batch;
28. baseline.wls_maps on the card against the CPU on 6 x 96 x 96 x 8
   noisy physics signals (rtol 1e-5 plus baseline.fit_rounding: 8
   float32 ulps of ln S carried through the fit), and its wall and device time on 14 x 96 x 96 x 8.
The bf16 trunk (OPTIMAL at compute_dtype="bfloat16", full width, the
weights of phase 3), after phase 28:
29. kernel H at bf16 (forward, dx, dw/db) against its plain version at the
   fine-tune fold (304 planes of 25 x 25 x 60 -> 60), on an odd plane
   (9 x 3 x 11, 5 -> 7) and at a serving chunk (16 x 96 x 96, 60 -> 60),
   within 2 bf16 ulps of each output's largest magnitude, dw/db replaying
   bit for bit; its three passes' static HGMMA (wgmma) instructions in the
   build's SASS (cuobjdump), none failing the phase; at the fold and the
   serving chunk each pass's device time (weight image, forward, dx, dw
   and its reduction; a pass missing from the trace fails the phase)
   beside its own bound and cuDNN bf16's call for it; kernels C and B
   with the bf16 trunk (csrc/encode_quad_bf16.cu, wgmma: HGMMA in both
   kernels' SASS, or the phase fails) against their plain versions at
   1,032,192 voxels, MVG and diagonal heads: C's q rows within 4 bf16
   ulps, B against the plain quadrature of C's q at CHECKS and against
   its plain version at the JAX package's bf16 gate; each error in bf16
   ulps with the share of elements a rounding moved; C's head against a
   float64 head on the plain version's bf16 features (median and 99.9th
   percentile); the device times of H (and cuDNN's bf16 conv2d and
   convolution_backward beside it), B and C, their plain versions' and
   their bounds at the dense bf16 peak (PEAK_BF16), and B beside C + A
   on the same request (A on C's q);
30. serving at bf16: one 14 x 96 x 96 x 8 request a route through
   save_predictions -- stream 1 by quadrature (B) and by mc (C + D),
   stream 2 under "auto" (cuDNN bf16) and "on" (H bf16) -- with the
   counts set to 0 before and read after each; maps finite, in range and
   read back, and against the float32 maps of the same weights at the JAX
   package's bf16 gates (BF16_GATE); the walls;
31. fine-tuning at bf16: Trainer.finetune 1 x 100 steps through H bf16
   and F (counted), 10 steps through cuDNN bf16 (H not launched), the
   parameters float32; one step (softplus, initial weights) on the card
   against the CPU and one through H against cuDNN, at BF16_STEP_TOL;
32. pretraining at bf16: one streaming epoch (22 steps, S launched a step);
33. timings: the bf16 fine-tune step's wall, busy share and launches
   through H and through cuDNN, and the epoch wall;
34. the CLI's train (``cli.main(["train", "--preset", "optimal", ...])``,
   every Trainer of the run in a save_directory of its own) on a
   real-data directory: ASE_scan of 6 brains of 64 x 64 x 8
   (tools/validate_finetune_torch.py::make_subjects) and one hyperv and
   one baseline subject with grey-matter and brain masks; 2 streaming
   pretrain epochs, 2 x 100 fine-tune steps, checkpoint_every_epochs=1:
   pt_model.msgpack, final_model.msgpack, no .partial, the pt_*,
   baseline_* and hyperv_* maps, and S, B, F, A and E launched (counts
   set to 0 before the call and read after); the checkpoint's bytes and
   its write and read times;
35. resume: a pretrain and a fine-tune whose logger raises at epoch 1 leave
   a .partial each; fresh Trainers restore them (params, mu, nu, count,
   SWA and step bit for bit equal to the tensors saved, at epoch 1), and
   two fresh Trainers resumed from the one fine-tune .partial end with
   bit-equal weights;
36. the CLI's infer on a 14 x 96 x 96 x 8 request from phase 34's
   final_model.msgpack in a fresh Trainer, its 8 maps bit-equal to
   save_predictions of the Trainer that trained (seed 7, the same pt
   priors); serve --warm 1 96 96 8 answering a quadrature, an mc and a
   bad request, each ack's wall_s beside the in-process posterior_maps
   wall of the same request;
37. dropout at rate 0.1 (OPTIMAL's width): Trainer.finetune 1 x 10 steps
   under fused_conv "auto" (F) and "on" (H and F), masks drawn on the card
   from each step's seed, launches asserted; one step with the same masks
   (drawn on the card) and host normals through H and F against cuDNN and
   the plain ELBO (check_step, softplus, GRAD_TOL); a train=False pass
   bit-equal to rate 0; the step walls at rates 0.1 and 0 under both conv
   routes; one streaming pretrain step (S) whose loss is rate 0's;
38. the serving artifacts (io/export_model.py): the default .pt2 of
   stream 2, exported, saved and reloaded on the card, against
   posterior_maps at 14 x 96 x 96 x 8 and 3 x 64 x 64 x 8 (CHECKS); the
   fused .pt2 at 1,032,192 voxels, bit-equal to the in-process kernel-B
   route, one B launch a call through the registered op; their export,
   save and load times and bytes, and the calls' walls;
39. the CLI: synth --preset optimal (6.25 M voxels drawn and decoded on
   the card), transfer to the 24-tau grid (the trunk bit for bit) and
   infer on a 3 x 64 x 64 x 8 x 24-tau request (B launched);
   save_predictions(transform_directory=) of stream 2 (A launched; no FSL
   here, so native-space maps); import-weights, which needs h5py, exits 1
   saying so where h5py is missing (its gates run on the CPU);
40. one rank over NCCL in this process (OPTIMAL's width): the sharded
   fine-tune step (F) given a batch and a seed bit-equal to the unsharded
   step, the two steps' walls and launches, the all-reduce's ms a step;
   then, the counts set to 0 before and read after, a 100-step
   make_finetune_epoch_sharded epoch (F once a step), a 22-step sharded
   streaming epoch (S once a step), posterior_maps_sharded of both
   streams on 14 x 96 x 96 x 8 (B, A) and elbo_maps_sharded of 6 subjects
   (E), the maps bit-equal to the unsharded ones; the group destroyed;
41. two ranks sharing the card (gloo on CUDA tensors):
   parallel.multihost.certify at OPTIMAL's width -- the host-draw stages
   (38 crops of 25 x 25 x 8 through F, 511 volumes, the per-rank-fed
   evaluation) and the sharded maps of 15 subjects bit-equal across ranks
   and within rtol 2e-5 / atol 1e-6 of this process alone, the
   device-noise epochs and the Trainer (streaming pretrain, then the
   subject-sharded fine-tune of 3 subjects over 2 ranks) bit-equal across
   ranks; each rank's launches, all-reduce ms and step wall, and the
   unsharded step's wall in this process, both timed as 100-step epochs;
   the ranks then run the sweep's population stage (read in phase 46);
42. two ``python -m qbold_vi_tpu_torch train --mesh --coordinator ...``
   processes on the card on phase 34's synthetic brains (a streaming
   pretrain epoch, one 100-step fine-tune epoch, the exports): both exit
   0 with equal metrics, rank 0 alone logs and writes the checkpoints and
   maps, an unsharded Trainer resumes final_model.msgpack; each rank's
   launches (its last line). The kernels line gives F, S, B, A and E's
   launches by phase and rank under "launches_sharded".
The sweep (qbold_vi_tpu_torch/sweep.py), after phase 42:
43. kernel S's trial axis: synth_batch(seeds=) of 4 seeds x 512 x 500
   voxels in one launch of each pass, each trial bit-equal to its one-trial
   launch and within ROW_TOL of the plain version on its replayed draws;
   the P = 4 launch's device time against 4 single launches, and its
   bytes bound (4 x 14.3 MB);
44. populations at OPTIMAL's width, 4 trials varying pt_lr, the
   inverse-gamma prior, ft_lr and adamw_decay, on phase 34's brains: one
   streaming pretrain epoch (22 steps of 512 volumes a trial) and one
   fine-tune epoch (100 steps of 38 crops of 25 x 25 x 8 a trial, 760,000
   F rows a step) -- no_pt_epochs 60 -> 1, no_ft_epochs 40 -> 1;
   population_pretrain and population_full_run against their serial=True
   oracle under host noise (rtol 2e-4 / 5e-4, atol 1e-5: the JAX
   package's gates), then under device noise (the counts set to 0 before
   and read after): F launched 100 + 100 times, S 22, every metric finite
   and the trials distinct; the walls of the population and of its 4
   trials serially (host noise), and one population fine-tune step's
   profile; F on the 760,000 rows one population step hands it (host
   noise, captured at its call) against the plain rows and gradients at
   ROW_TOL / GRAD_TOL, and its device noise at a row offset bit-equal to
   the whole launch's;
45. bayes_search (8 trials, populations of 4 through full_run) and
   random_search (4 trials, one population through the pretrain
   objective) over configurations/sweep_prior.yaml's space (SWEEP_PRIOR,
   its schedule cut as in 44); ``sweep --preset optimal --layers 2 --units
   60 --seeds 2`` through cli.main (two serial full_run trials, streaming
   pretrain); run_wandb_agent with a stand-in wandb, parallel_trials 2 and
   count 3; F and S launched;
46. 3 trials of a population over 2 ranks sharing the card (gloo; the
   population stage of phase 41's multihost.certify(population_trials=3))
   bit-equal across ranks and within rtol 2e-4 of one process, and
   ``dryrun --devices 2`` with its population stage.
Kernels B and C past the resident blob (csrc/encode_stream_wg.cu in
float32 up to 256 units, encode_stream_wgc.cu at 320 and 384,
encode_stream_wgx.cu at 448-768, encode_stream_wgk.cu at 832-1472, at any
tau count; csrc/encode_stream.cuh in bf16), run after phase 24:
47. OPTIMAL's 1,032,192-voxel request at 256 units x 2 blocks in float32
   (the wgmma kernels) and bf16, at 320 x 2 and 384 x 2 in float32 (the
   chunked kernels), at 448 x 1 (the split kernels), at 833 x 1 (the
   cluster kernels, 896 padded), at 1281 x 1 (the cluster kernels with a
   block's columns in two output chunks, 1344 padded), at 768 x 1 on a
   scan of 51 taus (the split kernels' rows in the activation rows), at
   320 x 2 and 60 x 2 on 330 taus (the chunked and wgmma kernels' rows
   staged a window of k-steps at a time), through posterior_maps
   under "auto" by quadrature (B) and by method="mc" (C, then D), the
   counts set to 0 before and read after each, maps finite; B and C
   against their plain versions at 50,003 voxels (float32 at CHECKS; bf16
   C within Q16_ULPS ulps, B against the plain quadrature of C's q at
   CHECKS), and so at 832 x 1 (init_params seed 832: the 3xTF32 drift
   that the cluster kernels' promoted sums repair), 1280 x 1 (the widest
   of one product a block), 1472 x 1 (the cluster kernels' widest) and
   1472 x 1 on 128 and 330 taus (shared and windowed rows);
   their device ms at full width beside their bounds, their plain
   versions' ms, and (at 256 x 2, 320 x 2, 448 x 1, 833 x 1, 1281 x 1, 768
   x 1 on 51 taus and 320 x 2 on 330) the fused route's ms a call beside
   the "off" route's (the encoder, then A or D) on the same device
   request; the same request in float32 at 100 x 2 (B and C) and 60 x 7
   (B), whose resident blobs do not fit (the wgmma kernels), each kernel
   held against its plain version on the whole request, its ms beside its
   bound; the wgmma, chunked, split and cluster B and C hold HGMMA in the
   SASS. The kernels line gives each design's B and C (B-wgmma, C-wgmma,
   B-chunked, C-chunked and at each further trunk, B-split, C-split,
   B-cluster, C-cluster and at each further trunk, B-bf16-stream,
   C-bf16-stream) their launches on this path.
No phase 43-46 accepts a trial whose status is "failed". The kernels line
gives S and F their launches on the population path under
"launches_sweep", and S its P = 4 time and bound.
Phases 5 and 13 print A-E beside their bounds: B and C's from the chain's
FMAs at the 3xTF32 rate (encode_bound) and at the float32 CUDA-core peak;
A's, B's and E's special-function bound beside OPS's (MUFU: the
instructions of the MUFU unit at 16 results a clock an SM); phase 9
prints G's.

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
import collections
import dataclasses
import functools
import json
import os
import re
import shutil
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
N_MC = 65_536                        # D and E against mc_philox_normals
N_SUBJ = 96 * 96 * 8                 # one subject: the ELBO export's chunk
S_MC, S_KL = 200, 100                # the sampled summaries' and KL's draws
ROW_TOL = (1e-5, 1e-5)
GRAD_TOL = (5e-4, 5e-5)
# the card's peaks (NVIDIA H100 SXM data sheet): float32 outside the
# tensor cores, dense TF32 and dense bf16 on the tensor cores, and HBM3
# bandwidth
PEAK_FLOPS = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989.4e12
PEAK_BYTES = 3.35e12
KL_STATE_FLOATS = 6                  # kernel F's KL state a voxel


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


def raw_head(rng, n, mix="straddling"):
    """Raw MVG head rows: logit stds straddling the s = 1.5 split, or with
    the log-std raws redrawn from [-2, 0.45] ("below": every problem of
    kernel A on the Gauss-Hermite side) or [0.6, 3] ("above": every one on
    the Gauss-Laguerre side)."""
    q = rng.normal(size=(n, 5)).astype(np.float32)
    q[:, [0, 2]] *= 3.0
    q[:, [1, 3]] *= 1.5             # logit stds straddle the s = 1.5 split
    if mix != "straddling":
        lo, hi = {"below": (-2.0, 0.45), "above": (0.6, 3.0)}[mix]
        q[:, [1, 3]] = rng.uniform(lo, hi, size=(n, 2))
    return q


HEAD_MIXES = ("straddling", "below", "above")


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


def launch_total() -> int:
    """Every launch the port's kernel wrappers have counted so far: the sum
    of each ``*launches`` counter on the functions of its ops modules."""
    import importlib
    import pkgutil

    import qbold_vi_tpu_torch.ops as ops

    total = 0
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"qbold_vi_tpu_torch.ops.{info.name}")
        for name, fn in vars(mod).items():
            if callable(fn) and getattr(fn, "__module__", None) == mod.__name__:
                total += sum(v for k, v in getattr(fn, "__dict__", {}).items()
                             if k.endswith("launches") and isinstance(v, int))
    return total


def kernel_ms(fn, symbol: str, calls: int = 21, need: int | None = None,
              tries: int = 3) -> float:
    """Median device duration of the launches of the kernel ``symbol``
    over ``calls`` calls of fn, from the profiler's CUDA activity: the
    kernel alone. CUDA events around a loop of calls also count the gaps
    where the host has not yet queued the next launch, which a kernel
    shorter than its wrapper's host work (G's ~0.04 ms) cannot hide. A
    trace can drop launch records (on the H100: one of 21 once, most of
    kernel H's 2 us weight split, once all 21 of a dx pass, three times in
    a row all 21 of G's backward): a trace with fewer than ``need`` (half
    the calls) is taken again, up to ``tries`` times. If every try falls
    short, the kernel wrappers' launch counters (``launch_total``) must
    show that the last try's calls launched (at least one counted launch a
    call), and the time is then fn's ms a call by CUDA events over
    ``calls`` calls -- every kernel of a call and the gaps between them,
    logged as "events; trace dropped"; a call that launched nothing
    fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    need = calls // 2 if need is None else need
    for _ in range(tries):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        counted = launch_total()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        counted = launch_total() - counted
        spans = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                 if e.device_type == DeviceType.CUDA and symbol in e.name]
        if len(spans) >= need:
            return statistics.median(spans)
        log(f"{symbol}: {len(spans)} launches traced in {calls} calls "
            f"({counted} counted by the wrappers); tracing again")
    if counted < calls:
        raise AssertionError(f"{symbol}: fewer than {need} launches traced in "
                             f"{calls} calls, {tries} times, and the wrappers "
                             f"counted {counted} launches in the last")
    ms = cuda_ms(fn, reps=calls, blocks=1)
    log(f"{symbol}: {ms:.4f} ms a call by CUDA events; trace dropped (the "
        f"wrappers counted {counted} launches in {calls} calls)")
    return ms


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


def profile(fn, n: int, label: str, card: str) -> dict:
    """torch.profiler over n calls of fn (after one warm-up): the device
    time of the kernels by name, and the device's busy share of the wall
    (the union of the kernels' intervals over the host wall). Returns a
    call's wall, busy time (ms) and launches."""
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
    return {"wall_ms": wall / n, "busy_ms": busy / n,
            "launches": len(kernels) / n}


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
    # draw forward (+ the five moments of the KL state and the clamp test)
    # / backward; one Box-Muller pair
    draw=18, kl_fwd=28, kl_moments=12, kl_bwd=52, box_muller=12,
    # per voxel, kernel F's backward from the KL state: the ten KL sums in
    # closed form from the moments (csrc/fused_elbo.cu::qv_kl_grads_moments)
    kl_closed=180,
    # per voxel: unpacking q and p (the backward with its tanh chain
    # factors), and the KL / gradient tails
    unpack=22, unpack_bwd=42, tail=40,
    # summarize.cu, kernel D: one sample's transform to (OEF, DBV, R2')
    # and its six sums, the negation of an antithetic pair, the means and
    # variances; kernel E: the hoisted whitening factors of q and p
    mc_draw=27, negate=2, mc_tail=15, whiten=14,
    # synth_batch.cu, kernel S: per voxel the mixture, the truncated
    # normal and the label (the Philox words' integer work not counted, as
    # for D and E); per tau the noise pass (the SNR, the standard deviation,
    # the sum); the signal is clen_i + signal a tau
    synth_voxel=30, synth_noise=4)


# Special-function (MUFU) instructions a voxel, a design count read from
# the SASS (cuobjdump -sass; tools/bench_stream1.py prints it per kernel)
# of the build whose kernels hold the static MUFU instructions MUFU_SASS,
# and from its loops: a unit of 16 results a clock on each SM (CUDA C
# Programming Guide, compute capability 9.0), so a second floor beside
# OPS's. Phase 2 fails when this run's build holds other static counts, so
# that an edit of the kernels has the counts read again.
MUFU = dict(
    # quad_math.cuh, per 1-D moment problem: a Gauss-Hermite node's
    # exponential and reciprocal (16 nodes); a Gauss-Laguerre node's two
    # exponentials, then 1 / s and the erf's reciprocal and exponential
    # (omom one more density); per voxel the two exponentials and the root
    # of the squash (the tanh's are left out: whether they take the unit
    # depends on the argument)
    gh=2 * 16, gl=2 * 16 + 3, gl_omom=1, squash=3,
    # summarize.cu, kernel E: each draw's Box-Muller pair (rsqrt, sine,
    # cosine; the log is a polynomial), and each voxel's exponentials of q
    # and p (two standard deviations, six whitening; the function needs
    # them once, whichever lanes repeat them)
    box_muller=3, kl_voxel=8,
    # decode_nll.cu, kernel G on the surrogate, forward and backward alike:
    # a tau's two exponentials and its reciprocal of sigma (the Student-t
    # term one more), a row's reciprocals of its two normalisers (the logs
    # are polynomials)
    g_tau=3, g_student=1, g_row=2)
MUFU_SASS = {
    "qv_quad_kernel": {"EX2": 45, "RCP": 25, "RSQ": 2},
    # kernel B's four widths together (62 EX2 before its encode took the
    # trunk as a template policy; the quadrature tail, whose per-voxel
    # counts MUFU holds, is A's routine, unchanged)
    "qv_encode_quad_kernel": {"EX2": 60, "RCP": 59, "RSQ": 2},
    "qv_mc_kl_kernel": {"COS": 2, "EX2": 14, "RCP": 11, "RSQ": 2, "SIN": 2},
    # G's forward; its backward's two instantiations (with and without dy)
    # counted together
    "qv_decode_nll_fwd_kernel": {"EX2": 2, "RCP": 10, "RSQ": 2},
    "qv_decode_nll_bwd_kernel": {"EX2": 4, "LG2": 12, "RCP": 43, "RSQ": 6},
}
MUFU_RATE = 16 * 132                 # results a clock on the card


@functools.lru_cache(maxsize=None)
def sass(so) -> dict:
    """{kernel symbol: (SASS instructions, Counter of MUFU kinds and of
    wgmma instructions, "HGMMA")} of a built library, by cuobjdump (a loop
    body counts once); empty without it. Read once a library: three
    phases read it, and its disassembly took 25 s on the H100's host."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.isfile(tool):
        return {}
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=False).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : \S*?(qv_\w+_kernel)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, [0, collections.Counter()])
            continue
        if name and "HGMMA" in line:      # at any offset
            out[name][1]["HGMMA"] += 1
        if name and re.match(r"\s+/\*[0-9a-f]{4}\*/", line):
            out[name][0] += 1
            mufu = re.search(r"MUFU\.(\w+)", line)
            if mufu:
                out[name][1][mufu.group(1)] += 1
    return out


def check_wgmma_sass() -> None:
    """Fail unless kernel H's bf16 passes (H16_WGMMA) and the bf16 encode
    of kernels B and C (BC16_SYMBOLS) take their products on wgmma: HGMMA
    instructions in the built library's SASS."""
    from qbold_vi_tpu_torch.ops import _cuda

    code = sass(_cuda.library()._name)
    got = {k: code.get(k, (0, {}))[1].get("HGMMA", 0)
           for k in H16_WGMMA + tuple(BC16_SYMBOLS.values())}
    if not all(got.values()):
        raise AssertionError(f"HGMMA instructions of kernels H, B and C at "
                             f"bf16: {got} (each must hold some; or "
                             "cuobjdump is missing)")
    log(f"kernels H, B and C at bf16 take their products on wgmma: static "
        f"HGMMA instructions {got}")


def check_mufu_sass(so) -> None:
    """Fail unless the built kernels of A, B, E and G hold the static MUFU
    instructions that MUFU's counts were read with."""
    code = sass(so)
    got = {k: dict(code.get(k, (0, {}))[1]) for k in MUFU_SASS}
    if got != MUFU_SASS:
        raise AssertionError(
            f"static MUFU instructions {got} differ from MUFU_SASS "
            f"{MUFU_SASS} (or cuobjdump is missing): read MUFU's counts a "
            "voxel again from this build's SASS")
    log(f"static MUFU instructions as MUFU's counts were read: {got}")


def mufu_clock_hz() -> float:
    """The SM clock of the special-function bound: the card's maximum, as
    log_clocks prints it."""
    return float(gpu_line("clocks.max.sm").split()[0]) * 1e6


def mufu_quad(raw: torch.Tensor, mvg: bool) -> float:
    """MUFU instructions of the quadrature summaries of squashed rows raw
    (3, N), each 1-D moment problem on its side."""
    ls0, ls1, od = raw.double()
    s0, s1 = ls0.exp(), ls1.exp()
    sm1 = (od * od + s1 * s1).sqrt() if mvg else s1
    n = ls0.numel()
    total = MUFU["squash"] * n
    for key, s in (("omom", s0), ("mom", sm1), ("gmom", s1)):
        gl = int((s >= 1.5).sum())
        total += MUFU["gh"] * (n - gl) + (MUFU["gl"] + (
            MUFU["gl_omom"] if key == "omom" else 0)) * gl
    return float(total)


def mufu_kl(no_samples: int) -> int:
    """Kernel E, per voxel: each draw's Box-Muller pair and the voxel's
    exponentials."""
    return MUFU["box_muller"] * no_samples + MUFU["kl_voxel"]


def mufu_bound(n_mufu: float, clock_hz: float) -> float:
    return n_mufu / (MUFU_RATE * clock_hz) * 1e3


def branch_shares(raw: torch.Tensor, mvg: bool) -> str:
    """The share of voxels of squashed rows raw (3, N) whose omom, mom and
    gmom problems take the Gauss-Laguerre side, and of 32-voxel warps that
    straddle the split."""
    ls0, ls1, od = raw.double()
    s0, s1 = ls0.exp(), ls1.exp()
    sm1 = (od * od + s1 * s1).sqrt() if mvg else s1
    parts = []
    for key, s in (("omom", s0), ("mom", sm1), ("gmom", s1)):
        gl = (s >= 1.5).double()
        w = gl[:gl.numel() // 32 * 32].reshape(-1, 32).sum(1)
        parts.append(f"{key} {float(gl.mean()):.3f} Laguerre, "
                     f"{float(((w > 0) & (w < 32)).double().mean()):.3f} of "
                     "warps straddle")
    return "; ".join(parts)


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


def encode_q_f64(x, encoder, *, se_idx, multi_image, activation, n_blocks,
                 mask_channel, input_layout, **_):
    """The stream-1 raw head q (5, N) in float64: the plain version's
    operations (ops/fused_infer.py::encode_q_plain) with the inputs and
    weights in double, the yardstick of kernels B and C's accuracy."""
    from qbold_vi_tpu_torch.models.encoder import activation_fn, normalise_data
    from qbold_vi_tpu_torch.ops.fused_infer import _rows, _stream1_weights

    act = activation_fn(activation)
    x, channel_major = _rows(x, input_layout)
    x = (x if channel_major else x.T).double()
    if mask_channel:
        x = x[:-1] * x[-1:]
    wfc, bfc, wb, bb, wf, bf = (t.double() for t in
                                _stream1_weights(encoder, n_blocks))
    h = act(wfc @ normalise_data(x.T, se_idx, multi_image).T + bfc)
    for i in range(n_blocks):
        h = act(wb[i] @ h + bb[i])
    return wf @ h + bf


def ops_encode(units: int, n_taus: int, n_blocks: int) -> int:
    """Kernel C, per voxel: normalisation and the dense chain T -> U ->
    nb x (U -> U) -> 5 (FMAs, biases, activations)."""
    u, t = units, n_taus
    return (2 * u * t + 2 * u + n_blocks * (2 * u * u + 2 * u) + 2 * u * 5
            + 5 + OPS["normalise"] * t)


def encode_bound(n: int, units: int, n_taus: int, n_blocks: int,
                 n_bytes: float, rest_ops: float) -> dict:
    """Kernels B and C: the dense chain's FMAs (U T + nb U^2 + 5 U a voxel,
    unpadded) on the tensor cores as 3xTF32 -- three TF32 products for each
    float32 one over the dense TF32 peak, as conv_bound -- the rest of the
    work (``rest_ops``: normalisation, biases and activations, B's
    quadrature) at the float32 peak, and the bytes: the largest of the
    three, since the units run side by side. ``cuda_core_bound_ms``: the
    whole count at the float32 peak (the bound of a CUDA-core design)."""
    fma = n * (units * n_taus + n_blocks * units * units + 5 * units)
    t_tc = 3 * 2 * fma / PEAK_TF32 * 1e3
    t_rest = rest_ops / PEAK_FLOPS * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    ms = max(t_tc, t_rest, t_bytes)
    return {"bound_ms": ms,
            "bound_by": "bytes" if t_bytes == ms else "operations",
            "cuda_core_bound_ms": bound(n_bytes,
                                        2 * fma + rest_ops)["bound_ms"]}


def stream1_bounds(n, cfg, n_taus, raw_b, mvg) -> dict:
    """encode_bound of kernels B (reads T + 1 floats a voxel, writes 9)
    and C (writes the 5 of q)."""
    u, nb = cfg.no_units, cfg.no_intermediate_layers
    rest = n * (ops_encode(u, n_taus, nb)
                - 2 * (u * n_taus + nb * u * u + 5 * u))
    return {"B": encode_bound(n, u, n_taus, nb, n * 4 * (n_taus + 1 + 9),
                              rest + ops_quad(raw_b, mvg)),
            "C": encode_bound(n, u, n_taus, nb, n * 4 * (n_taus + 1 + 5),
                              rest)}


def log_bounds(times: dict, bounds: dict, card: str) -> None:
    for k, b in bounds.items():
        extra = "".join(
            f", {label} bound {b[key]:.4f} ms ({100 * b[key] / times[k]:.1f}%)"
            for key, label in (("cuda_core_bound_ms", "CUDA-core"),
                               ("mufu_bound_ms", "special-function"))
            if key in b)
        log(f"{k}: {times[k]:.4f} ms on the device, bound "
            f"{b['bound_ms']:.4f} ms by {b['bound_by']} "
            f"({100 * b['bound_ms'] / times[k]:.1f}%){extra} [{card}]")


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
               backward, flagged=0, count="function") -> dict:
    """Kernel F (MVG), by ``count``:

    * "function", the bound reported: what the function needs, whatever
      the design. q, p (n, k), y, sigma (n, t) and the mask read once (+
      the cotangents and the written gradients for the backward, + the
      normals in host-noise mode); the operations of the live voxels'
      s_nll decodes and, forward, their s_kl reduced-KL draws; backward,
      the s_kl draws summed into their five moments and the ten KL sums
      from them in closed form (the fewest operations known), with the
      KL draws of the ``flagged`` voxels (those whose draws clamp)
      replayed.
    * "replay": the backward replaying every draw (PR 2's count; the
      forward's is "function").
    * "state": this design's work, the KL state's: the forward also sums
      the moments and writes the state; the backward reads it and no KL
      normals, forms the unflagged voxels' KL sums in closed form and
      replays the flagged voxels' draws.

    Philox's integer work is not counted."""
    floats = 2 * k + 2 * t + 1 + 2 + (2 * k + 2 * t if backward else 0)
    noise = 0 if device_noise else 2 * (s_nll + s_kl) * n
    bm = OPS["box_muller"] if device_noise else 0
    base = (OPS["unpack_bwd" if backward else "unpack"] + OPS["tail"]
            + s_nll * (OPS["draw"] + bm + ops_decode(t, student, backward)))
    replay = flagged * s_kl * (OPS["kl_bwd"] + bm)
    if not backward:
        ops = live * (base + s_kl * (OPS["kl_fwd"] + bm + (
            OPS["kl_moments"] if count == "state" else 0)))
    elif count == "replay":
        ops = live * (base + s_kl * (OPS["kl_bwd"] + bm))
    elif count == "state":
        ops = live * (base + OPS["kl_closed"]) + replay
    else:
        ops = (live * (base + OPS["kl_closed"]
                       + s_kl * (bm + OPS["kl_moments"])) + replay)
    if count == "state":
        floats += KL_STATE_FLOATS
        if backward and not device_noise:
            noise = 2 * s_nll * n + 2 * s_kl * flagged
    return bound(4 * (n * floats + noise), ops)


def bound_decode(n, live, t, student, backward, dy=True) -> dict:
    """Kernel G: oef, dbv, the mask, y and sigma read once (+ the
    cotangent; rows or the four gradients written, dy only if asked),
    the operations of the live rows."""
    floats = (2 * t + 4) + (2 * t + 2 - (0 if dy else t) if backward else 0)
    return bound(4 * n * floats, live * ops_decode(t, student, backward))


def mufu_decode(t, student) -> int:
    """Kernel G, per row and pass: the special-function instructions of
    its t taus and of the row (MUFU's counts)."""
    return (MUFU["g_tau"] + MUFU["g_student"] * student) * t + MUFU["g_row"]


def g_operands(tuner, rows, z) -> tuple:
    """Kernel G's operands (oef, dbv, y, sigma, mask) for the draws z (S,
    N, 2) of the diagonal head rows["q"]: y, sigma and the mask repeated
    over the draws, as the fine-tune step passes them (train/steps.py)."""
    s = z.shape[0]
    d = tuner.dist.sample_many(z, rows["q"], False)

    def rep(x):
        return x.expand((s,) + x.shape).reshape((-1,) + x.shape[1:]) \
            .contiguous()

    return (d[..., 0].reshape(-1).contiguous(),
            d[..., 1].reshape(-1).contiguous(), rep(rows["y"]),
            rep(rows["sigma"]), rep(rows["mask"]))


def stepped(tuner, metrics) -> tuple:
    """(loss, parameters, gradients) of a tuner after one train step, in
    float64 on the host."""
    return (float(metrics["loss"]),
            {k: p.detach().cpu().double() for k, p in tuner.named_parameters()},
            {k: p.grad.cpu().double() for k, p in tuner.named_parameters()
             if p.grad is not None})


def check_step(label, got, ref, before, lr, kinks=False, tol=None) -> float:
    """Raise unless one step from the weights ``before`` agrees between two
    runs (``stepped`` triples): the loss at rtol 1e-5, the updates as
    below, and each gradient scale-normalised at GRAD_TOL (the card tests'
    gate for a step), or with ``kinks`` (relu) within 1e-2 of its scale,
    or, given ``tol`` = (loss rtol, share of the scale), a bf16 trunk's
    step: the loss at that rtol and each gradient within that share of its
    scale (the updates held tight only where the gradient is clear of
    three times that share).
    Returns the largest gradient difference over its scale. Each
    comparison runs twice: with softplus in place of relu (``smooth``)
    from the initial weights (init_params; the card tests' setting) at
    GRAD_TOL, and as the main path runs it, relu from the trained weights,
    with ``kinks``: a relu input within float32 rounding of 0 may take the
    other side of the kink on one run, which moves a conv gradient by
    1e-4 - 3e-4 of its scale, where a wrong gradient moves it by O(1)
    (softplus on weights trained with relu can overflow the sigma
    stream)."""
    (loss_c, after_c, grad_c), (loss_r, after_r, grad_r) = got, ref
    loss_rtol, limit = tol if tol else (1e-5, 1e-2 if kinks else None)
    if not abs(loss_c - loss_r) <= loss_rtol * abs(loss_r):
        raise AssertionError(f"{label}: loss {loss_c} vs {loss_r}")
    worst_grad = 0.0
    for k, g_r in grad_r.items():
        scale = float(g_r.abs().max()) + 1e-30
        worst_grad = max(worst_grad,
                         float((grad_c[k] - g_r).abs().max()) / scale)
        if limit is None:
            check_rows(f"{label}: gradient of {k} over its scale",
                       grad_c[k] / scale, g_r / scale, *GRAD_TOL)
        # Adam's first update is lr * g / (|g| + 1e-7): held tight where g
        # is clear of zero and of eps (a last-bit or kink difference in g
        # then barely moves it), and to the step's own bound elsewhere
        before_k = before[k].cpu().double()
        d_c, d_r = after_c[k] - before_k, after_r[k] - before_k
        e = (d_c - d_r).abs()
        clear = g_r.abs() > max((3 * tol[1] if tol else 1e-2) * scale, 1e-4)
        if not (bool((e[clear] <= 1e-6 + 1e-4 * d_r[clear].abs()).all())
                and float(e.max()) <= 2.0 * lr):
            raise AssertionError(
                f"{label}: update of {k} differs by {float(e.max()):.3e} "
                f"(gradient scale {scale:.3e})")
    if limit is not None and worst_grad > limit:
        raise AssertionError(f"{label}: gradients differ by {worst_grad:.3e}"
                             f" of their scale (gate {limit})")
    return worst_grad


def step_runs(cfg, initial, trained) -> tuple:
    """(tag, configuration, weights, kinks) of the two runs of a compared
    step (check_step)."""
    return (("softplus, initial weights", smooth(cfg), initial, False),
            ("relu, trained weights", cfg, trained, True))


def smooth(cfg):
    """cfg with softplus in place of its activation, for a step compared
    across devices or routes at GRAD_TOL (check_step)."""
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, activation="softplus"))


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
    from qbold_vi_tpu_torch.models.vi import FineTuner, init_params
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
    names = ("dq", "dp", "dy", "dsigma")

    def check_f(tag, rows, model, s_n):
        """F's rows and both backwards (replaying every draw; from the KL
        state, MVG) against the plain version and each other, the state
        against kl_state_plain, dead voxels' outputs 0 (phases 6, 19-21)."""
        mvg = model.use_mvg
        k = 5 if mvg else 4
        n = rows["mask"].shape[0]
        c = dn.decode_consts(model, scan, True)
        main = (rows["q"][:, :k].contiguous(), rows["p"][:, :k].contiguous(),
                rows["y"], rows["sigma"], rows["mask"])
        zn, zk, ct_n, ct_k = (normal(s_n, n, 2), normal(s_kl, n, 2),
                              normal(n), normal(n))
        kw = dict(mvg=mvg, s_nll=s_n, s_kl=s_kl, z_nll=zn, z_kl=zk)
        state = torch.empty(n, fe.KL_STATE, device=dev) if mvg else None
        got = fe.fused_elbo_forward(*main, c, state=state, **kw)
        grads = fe.fused_elbo_backward(*main, ct_n, ct_k, c, **kw)
        from_state = (fe.fused_elbo_backward(*main, ct_n, ct_k, c,
                                             state=state, **kw)
                      if mvg else grads)
        torch.cuda.synchronize()
        ref = fe.elbo_rows_plain(*main, zn, zk, c, mvg)
        gref = fe.elbo_grads_plain(*main, zn, zk, ct_n, ct_k, c, mvg)
        e_rows = max(check_rows(f"F fwd {tag} {nm}", x, r)
                     for nm, x, r in zip(("nll", "kl"), got, ref))
        e_grads = max(check_grad(f"F bwd {tag} {nm}{way}", x, r)
                      for way, gs in (("", grads),
                                      (" from the state", from_state))
                      for nm, x, r in zip(names, gs, gref))
        flagged = 0
        if mvg:
            for nm, x, y in zip(names, from_state, grads):
                check_grad(f"F bwd {tag} {nm} from the state vs replayed",
                           x, y)
            sref = fe.kl_state_plain(main[0], main[4], zk, c)
            flag = state[:, 5] != 0
            if not torch.equal(flag, sref[:, 5] != 0):
                raise AssertionError(f"F state {tag}: clamp flags differ")
            check_rows(f"F state {tag} moments", state[:, :5], sref[:, :5],
                       1e-5, 1e-3)
            flagged = int(flag.sum())
        dead = main[4] == 0
        for x, y in zip(tuple(got) + tuple(grads) + tuple(from_state),
                        tuple(ref) + tuple(gref) + tuple(gref)):
            if not (bool((x[dead] == 0).all()) and bool(
                    (y[dead][torch.isfinite(y[dead])] == 0).all())):
                raise AssertionError(f"F {tag}: a dead voxel's output is "
                                     "not 0")
        log(f"kernel F vs plain ok: {tag}, N={n} (rows {e_rows:.3e}, "
            f"gradients {e_grads:.3e} max abs; "
            + (f"backward with and without the KL state, {flagged} voxels' "
               "KL draws clamp; " if mvg else "")
            + f"{int(dead.sum())} dead)")
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

    # ---- 19. F where KL draws clamp ----------------------------------------
    bound_kl = dn.decode_consts(mcfg, scan, True).scalars["kl_bound"]
    q = rows["q"].clone()
    q[0::4, 0] = bound_kl - 0.5
    q[1::4, 2] = -(bound_kl + 1.0)
    q[2::4, 0] = -(bound_kl - 2.0)
    check_f("q means near and past +-kl_bound", dict(rows, q=q), mcfg,
            s_nll)

    # ---- 20. F on dead warps ---------------------------------------------
    idx = torch.arange(N_FT, device=dev)
    dead = (idx < N_FT // 2) & ((idx // 64) % 2 == 0)
    check_f("runs of 64 dead voxels", dict(
        rows, mask=torch.where(dead, 0.0, rows["mask"]),
        y=torch.where(dead[:, None], 0.0, rows["y"])), mcfg, s_nll)
    check_f("every voxel dead", dict(
        rows, mask=torch.zeros_like(rows["mask"]),
        y=torch.zeros_like(rows["y"])), mcfg, s_nll)

    c_opt = dn.decode_consts(mcfg, scan, True)

    def check_g(tag, args, c):
        """G's rows and its backward with and without dy against the
        plain version; dy is None when not asked."""
        n = args[0].shape[0]
        ct = normal(n)
        got = dn.decode_nll_forward(*args, c)
        full = dn.decode_nll_backward(*args, ct, c)
        nody = dn.decode_nll_backward(*args, ct, c, want_dy=False)
        torch.cuda.synchronize()
        if nody[3] is not None:
            raise AssertionError(f"G bwd {tag}: dy given, not asked for")
        e_rows = check_rows(f"G fwd {tag}", got,
                            dn.nll_row_plain(*args, c) * args[4])
        ctm = ct * args[4]
        ref = [r * (ctm if r.ndim == 1 else ctm[:, None])
               for r in dn.nll_row_grads_plain(*args, c)]
        e_grads = max(
            check_grad(f"G bwd {tag} {nm}{way}", x, r)
            for way, gs in (("", full), (" without dy", nody[:3]))
            for nm, x, r in zip(("doef", "ddbv", "dsigma", "dy"), gs, ref))
        log(f"kernel G vs plain ok: {tag}, N={n}, dy asked and not (rows "
            f"{e_rows:.3e}, gradients {e_grads:.3e} max abs)")
        return e_rows, e_grads

    draws = tuner.dist.sample_many(normal(1, N_FT, 2), rows["q"],
                                   mcfg.use_mvg)[0]
    g_args = (draws[:, 0].contiguous(), draws[:, 1].contiguous(), rows["y"],
              rows["sigma"], rows["mask"])
    g_err = [check_g("OPTIMAL's MVG draws", g_args, c_opt)]
    # the path G serves: a diagonal posterior with a population prior (F
    # leaves it out: its KL carries the prior's hyperprior cost), its rows
    # from that configuration's encoder
    pop_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        mcfg, use_mvg=False, use_population_prior=True))
    c_pop = dn.decode_consts(pop_cfg.model, scan, True)
    pop_tuner = FineTuner(pop_cfg.model, scan, device=dev)
    pop_tuner.load_state_dict(init_params(pop_cfg.model, scan,
                                          torch.Generator().manual_seed(0)))
    z_pop = normal(2, N_FT, 2)
    pop_rows = ft_rows(pop_tuner, rng, dev, t_n)
    pop_args = g_operands(pop_tuner, pop_rows, z_pop[:1])
    g_err.append(check_g("diagonal + population prior", pop_args, c_pop))
    g_err.append(check_g("diagonal + population prior, ragged", tuple(
        torch.cat([a, a[:N_FT_RAGGED - N_FT]]) for a in pop_args), c_pop))
    g_err.append(check_g(
        "Student-t df 2, multi-image, no_samples 2",
        g_operands(pop_tuner, pop_rows, z_pop), dn.decode_consts(
            dataclasses.replace(pop_cfg.model, student_t_df=2.0,
                                multi_image_normalisation=True), scan, True)))
    err["G_fwd"] = max(e for e, _ in g_err)
    err["G_bwd"] = max(e for _, e in g_err)

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
    states, gs = [], []
    for _ in range(2):      # 21. the state path under device noise
        states.append(torch.empty(N_FT, fe.KL_STATE, device=dev))
        fe.fused_elbo_forward(*main_d, c_opt, seed=5, state=states[-1], **kw)
        gs.append(fe.fused_elbo_backward(*main_d, ct_n, ct_k, c_opt, seed=5,
                                         state=states[-1], **kw))
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(
            r1 + g1 + gs[0] + (states[0],), r2 + g2 + gs[1] + (states[1],))):
        raise AssertionError("F device noise: one seed did not replay")
    for nm, x, y in zip(names, gs[0], g1):
        check_grad(f"F device noise {nm} from the state vs replayed", x, y)
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
    trainer = Trainer(fresh_save(cfg), state_dict=tuner.state_dict(),
                      device=dev, logger=logger)
    before = {k: v.clone() for k, v in trainer.tuner.state_dict().items()}
    for f in counters.values():
        f.launches = 0
    fe.fused_elbo_backward.from_state = 0
    trainer.finetune(data, epochs=2)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    from_state = fe.fused_elbo_backward.from_state
    n_steps = 2 * cfg.train.ft_steps_per_epoch
    log(f"fine-tune (2 epochs x {cfg.train.ft_steps_per_epoch} steps, batch "
        f"{cfg.train.ft_batch_size}, device noise) launches: {launches}, F "
        f"backward from the KL state {from_state}")
    if (launches["F_fwd"], launches["F_bwd"]) != (n_steps, n_steps) or \
            launches["G_fwd"] or launches["G_bwd"]:
        raise AssertionError(f"F did not run once a step: {launches}")
    if from_state != n_steps:
        raise AssertionError(f"F's backward took the KL state {from_state} "
                             f"times in {n_steps} steps")
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
    trained = {k: v.clone() for k, v in trainer.tuner.state_dict().items()}

    def card_vs_cpu(base, initial, trained, batch, noise, label=""):
        """One step of base on the card against the same step on the CPU
        plain path (check_step, both runs); returns the card steps' G
        launches (forward, backward)."""
        g0 = (dn.decode_nll_forward.launches, dn.decode_nll_backward.launches)
        for tag, c, weights, kinks in step_runs(base, initial, trained):
            result = {}
            for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
                t = FineTuner(c.model, scan, device=device)
                t.load_state_dict(weights)
                opt = optim.make_finetune_optimizer(t.parameters(), c.train)
                result[name] = stepped(t, steps.make_finetune_step(t, c, opt)(
                    {k: v.to(device) for k, v in batch.items()}, noise=noise))
            worst_grad = check_step(
                f"one fine-tune step{label} ({tag}) on the card vs the CPU",
                result["card"], result["cpu"], weights,
                float(base.train.ft_lr), kinks)
            log(f"one step{label} ({tag}) on the card agrees with the CPU "
                f"plain path: loss {result['card'][0]:.7g} vs "
                f"{result['cpu'][0]:.7g}, gradients within {worst_grad:.2e} "
                f"of their scale ({'1e-2' if kinks else 'GRAD_TOL'}), updates"
                " within tolerance")
        return (dn.decode_nll_forward.launches - g0[0],
                dn.decode_nll_backward.launches - g0[1])

    card_vs_cpu(cfg, tuner.state_dict(), trained, batch, noise)

    # ---- 8, the diagonal posterior with a population prior: the fine-tune
    # path of kernel G under "auto" (F does not cover it), from its own
    # initial weights, on the same volumes
    pop_logged = []

    def pop_logger(phase, epoch, m):
        pop_logged.append(dict(m))
        log(f"[{phase}, diagonal + population prior] epoch {epoch}: "
            + " ".join(f"{k}={v:.6g}" for k, v in m.items()) + f" [{card}]")

    pop_trainer = Trainer(fresh_save(pop_cfg),
                          state_dict=pop_tuner.state_dict(),
                          device=dev, logger=pop_logger)
    pop_before = {k: v.clone()
                  for k, v in pop_trainer.tuner.state_dict().items()}
    for f in counters.values():
        f.launches = 0
    pop_trainer.finetune(data, epochs=1)      # prepare_real, then 100 steps
    torch.cuda.synchronize()
    launches_pop = {k: f.launches for k, f in counters.items()}
    n_pop = pop_cfg.train.ft_steps_per_epoch
    log(f"fine-tune, diagonal + population prior (prepare_real, 1 epoch x "
        f"{n_pop} steps, fused_elbo and fused_decode_nll auto) launches: "
        f"{launches_pop}")
    if (launches_pop["G_fwd"], launches_pop["G_bwd"]) != (n_pop, n_pop) or \
            launches_pop["F_fwd"] or launches_pop["F_bwd"]:
        raise AssertionError(f"G did not run once a step: {launches_pop}")
    if not all(np.isfinite(v) for m in pop_logged for v in m.values()):
        raise AssertionError("non-finite fine-tune metrics (diagonal + "
                             "population prior)")
    moved = [k for k, v in pop_trainer.tuner.state_dict().items()
             if not torch.equal(pop_before[k], v)]
    if "pop_prior" not in moved or len(moved) < 2:
        raise AssertionError(f"fine-tuning moved only {moved}")
    log(f"{len(moved)} of {len(pop_before)} parameters moved, pop_prior "
        "among them")
    launches.update(G_fwd=launches_pop["G_fwd"], G_bwd=launches_pop["G_bwd"])
    pop_epoch_ms = pop_logged[-1]["epoch_time_s"] * 1e3
    pvol = torch.from_numpy(pop_trainer.sampler.data).to(dev)
    ppri = torch.from_numpy(pop_trainer.sampler.priors).to(dev)
    pbatch = steps.sample_crop_batch(torch.Generator().manual_seed(8), pvol,
                                     ppri, 4, cfg.train.crop_size)
    pnoise = {"z_nll": rng.normal(size=(s_nll,) + tuple(
        pbatch["images"].shape[:-1]) + (2,)).astype(np.float32)}
    g_step = card_vs_cpu(pop_cfg, pop_tuner.state_dict(), {
        k: v.clone() for k, v in pop_trainer.tuner.state_dict().items()},
        pbatch, pnoise, ", diagonal + population prior")
    if g_step != (2, 2):
        raise AssertionError(f"the card's steps launched G {g_step} times, "
                             "not once a step each way")

    # ---- 9. timings ---------------------------------------------------------
    log_clocks("before the fine-tune timings")
    main = (rows["q"], rows["p"], rows["y"], rows["sigma"], rows["mask"])
    ct_n, ct_k = normal(N_FT), normal(N_FT)
    ct_g = normal(N_FT)
    seed = 11
    z = gpu(fe.philox_normals(seed, N_FT, s_nll + s_kl))
    zn, zk = z[:s_nll], z[s_nll:]
    kwd = dict(mvg=True, s_nll=s_nll, s_kl=s_kl, seed=seed)
    kwh = dict(mvg=True, s_nll=s_nll, s_kl=s_kl, z_nll=zn, z_kl=zk)
    # ---- 22. F at the fold: the main path's forward writes the KL state
    # and its backward reads it
    st = {way: torch.empty(N_FT, fe.KL_STATE, device=dev)
          for way in ("device", "host")}
    fe.fused_elbo_forward(*main, c_opt, state=st["device"], **kwd)
    fe.fused_elbo_forward(*main, c_opt, state=st["host"], **kwh)
    flagged = int((st["device"][:, 5] != 0).sum())
    times = {
        "F_fwd": time_kernel(
            lambda: fe.fused_elbo_forward(*main, c_opt, state=st["device"],
                                          **kwd),
            "qv_elbo_fwd_kernel",
            lambda: fe.elbo_rows_plain(*main, zn, zk, c_opt, True)),
        "F_bwd": time_kernel(
            lambda: fe.fused_elbo_backward(*main, ct_n, ct_k, c_opt,
                                           state=st["device"], **kwd),
            "qv_elbo_bwd_kernel",
            lambda: fe.elbo_grads_plain(*main, zn, zk, ct_n, ct_k, c_opt,
                                        True)),
        # G on the rows of the path it serves; the main path's backward
        # leaves dy out (the images need no gradient)
        "G_fwd": time_kernel(
            lambda: dn.decode_nll_forward(*pop_args, c_pop),
            "qv_decode_nll_fwd_kernel",
            lambda: dn.nll_row_plain(*pop_args, c_pop) * pop_args[4]),
        "G_bwd": time_kernel(
            lambda: dn.decode_nll_backward(*pop_args, ct_g, c_pop,
                                           want_dy=False),
            "qv_decode_nll_bwd_kernel",
            lambda: dn.nll_row_grads_plain(*pop_args, c_pop)),
    }
    g_dy_ms = kernel_ms(lambda: dn.decode_nll_backward(*pop_args, ct_g, c_pop),
                        "qv_decode_nll_bwd_kernel")
    replay = {"device": kernel_ms(
        lambda: fe.fused_elbo_backward(*main, ct_n, ct_k, c_opt, **kwd),
        "qv_elbo_bwd_kernel")}
    host = (kernel_ms(lambda: fe.fused_elbo_forward(
                *main, c_opt, state=st["host"], **kwh), "qv_elbo_fwd_kernel"),
            kernel_ms(lambda: fe.fused_elbo_backward(
                *main, ct_n, ct_k, c_opt, state=st["host"], **kwh),
                "qv_elbo_bwd_kernel"))
    replay["host"] = kernel_ms(lambda: fe.fused_elbo_backward(
        *main, ct_n, ct_k, c_opt, **kwh), "qv_elbo_bwd_kernel")
    log_times(times, N_FT, card)
    log(f"F with host noise: forward {host[0]:.4f} ms, backward "
        f"{host[1]:.4f} ms from the KL state on the device at N={N_FT} "
        f"[{card}]")
    log(f"F backward replaying every draw (no KL state): device noise "
        f"{replay['device']:.4f} ms, host noise {replay['host']:.4f} ms; "
        f"{flagged} of {int((rows['mask'] > 0).sum())} live voxels' KL draws "
        f"clamp [{card}]")
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
    pop_step = steps.make_finetune_step(pop_trainer.tuner, pop_cfg,
                                        pop_trainer.optimizer)
    pbatch = steps.sample_crop_batch(
        torch.Generator().manual_seed(9), pvol, ppri,
        cfg.train.ft_batch_size, cfg.train.crop_size)
    pop_step_ms = wall_ms(lambda: pop_step(pbatch, seed=seed))
    log(f"fine-tune step, diagonal + population prior (G + the torch KL with "
        f"the hyperprior cost, backward, AdamW) wall {pop_step_ms:.3f} ms at "
        f"batch {cfg.train.ft_batch_size} x {shape[1:]} [{card}]")
    profile(lambda: pop_step(pbatch, seed=seed), 5,
            "fine-tune step, diagonal + population prior", card)
    log(f"fine-tune epoch, diagonal + population prior ({n_pop} steps) wall "
        f"{pop_epoch_ms:.1f} ms [{card}]")

    n_live = int(live.sum())
    pop_live = int((pop_args[4] > 0).sum())
    student = c_opt.student
    bounds = {
        "F_fwd": bound_elbo(N_FT, n_live, 5, t_n, s_nll, s_kl, student, True,
                            False, flagged),
        "F_bwd": bound_elbo(N_FT, n_live, 5, t_n, s_nll, s_kl, student, True,
                            True, flagged),
        "G_fwd": bound_decode(N_FT, pop_live, t_n, c_pop.student, False),
        "G_bwd": bound_decode(N_FT, pop_live, t_n, c_pop.student, True,
                              dy=False),
    }
    sources = {"F": ("fused_elbo", "qbold_vi_tpu_torch/csrc/fused_elbo.cu",
                     "qbold_vi_tpu/ops/pallas_elbo.py", (464, 492)),
               "G": ("decode_nll", "qbold_vi_tpu_torch/csrc/decode_nll.cu",
                     "qbold_vi_tpu/ops/pallas_decode.py", (399, 431))}
    # F beside its bound (the function's count), this design's count (the
    # KL state's) and PR 2's replay count (bound_elbo)
    extra = {"F_fwd": {"host_noise_ms": host[0]},
             "F_bwd": {"host_noise_ms": host[1],
                       "replay_ms": replay["device"],
                       "replay_host_noise_ms": replay["host"],
                       "clamped_voxels": flagged},
             "G_bwd": {"with_dy_ms": g_dy_ms, "with_dy_bound_ms": bound_decode(
                 N_FT, pop_live, t_n, c_pop.student, True)["bound_ms"]}}
    clock = mufu_clock_hz()
    for way in ("fwd", "bwd"):
        k = f"G_{way}"
        extra.setdefault(k, {})["mufu_bound_ms"] = mufu_bound(
            pop_live * mufu_decode(t_n, c_pop.student), clock)
        ops_ms = bound(0, pop_live * ops_decode(t_n, c_pop.student,
                                                way == "bwd"))["bound_ms"]
        log(f"{k}: {times[k][0]:.4f} ms on the device"
            + (f" without dy, {g_dy_ms:.4f} ms with it" if way == "bwd"
               else "") + f", bound {bounds[k]['bound_ms']:.5f} ms by "
            f"{bounds[k]['bound_by']} "
            f"({100 * bounds[k]['bound_ms'] / times[k][0]:.1f}%)"
            + (f", with dy {extra[k]['with_dy_bound_ms']:.5f} ms "
               f"({100 * extra[k]['with_dy_bound_ms'] / g_dy_ms:.1f}%)"
               if way == "bwd" else "")
            + f", operations {ops_ms:.5f} ms, special-function "
            f"{extra[k]['mufu_bound_ms']:.5f} ms "
            f"({100 * extra[k]['mufu_bound_ms'] / times[k][0]:.1f}%) at "
            f"N={N_FT}, {pop_live} live [{card}]")
    for way in ("fwd", "bwd"):
        k = f"F_{way}"
        for count in ("state", "replay") if way == "bwd" else ("state",):
            extra[k][f"{count}_design_bound_ms"] = bound_elbo(
                N_FT, n_live, 5, t_n, s_nll, s_kl, student, True,
                way == "bwd", flagged, count)["bound_ms"]
        log(f"{k}: {times[k][0]:.4f} ms against its bound "
            f"{bounds[k]['bound_ms']:.5f} ms ({bounds[k]['bound_by']}; "
            f"{100 * bounds[k]['bound_ms'] / times[k][0]:.1f}%); this "
            f"design's count {extra[k]['state_design_bound_ms']:.5f} ms"
            + (f", the replay count "
               f"{extra[k]['replay_design_bound_ms']:.5f} ms"
               if way == "bwd" else "") + f" [{card}]")
    kernels = []
    for key, (name, src, tpu, lines) in sources.items():
        for way, line in zip(("fwd", "bwd"), lines):
            k = f"{key}_{way}"
            kernels.append({
                "name": f"{name}_{'forward' if way == 'fwd' else 'backward'}",
                "route": "cuda", "source": src, "replaces": f"{tpu}:{line}",
                "launches": launches[k], "max_abs_err": err[k],
                "ms": times[k][0], "plain_ms": times[k][2], **bounds[k],
                "library_ms": None, **extra.get(k, {})})
    return {"kernels": kernels, "step_ms": step_ms, "epoch_ms": epoch_ms,
            "pop_step_ms": pop_step_ms, "pop_epoch_ms": pop_epoch_ms}


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
def sampled_phases(dev, card, cfg, tuner, ranges, enc_kw, raw_b) -> dict:
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
    z = gpu(sm.mc_philox_normals(seed, N_MC + 1, S_MC))
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
        log(f"kernels D and E vs plain fed mc_philox_normals ok at N={n} (MVG "
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
        "C": stream1_bounds(N_FULL, mcfg, scan.n_taus, raw_b,
                            mcfg.use_mvg)["C"],
        "D": bound(N_FULL * 4 * (5 + 6),
                   N_FULL * ops_mc_summaries(S_MC, True)),
        "E": bound(N_SUBJ * 4 * (5 + 5 + 1), N_SUBJ * ops_mc_kl(S_KL)),
    }
    bounds["E"]["mufu_bound_ms"] = mufu_bound(
        N_SUBJ * mufu_kl(S_KL), mufu_clock_hz())
    log_bounds({k: times[k][0] for k in bounds}, bounds, card)
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


@torch.no_grad()
def stream1_phases(dev, card, cfg, tuner, ranges, enc_kw) -> tuple:
    """Phases 23-25 and 47: kernels B and C against a float64 encode, on
    widths the kernel pads, past 128 units (phase 47's full-width path),
    kernel D at S = 2, 7 and 200 and kernel E at S = 2, 7 and 100. Returns
    the float64 errors and phase 47's results."""
    from qbold_vi_tpu_torch.models.encoder import _full_fp32
    from qbold_vi_tpu_torch.models.vi import FineTuner, init_params
    from qbold_vi_tpu_torch.ops import fused_infer as fi
    from qbold_vi_tpu_torch.ops import summarize as sm

    mcfg, scan = cfg.model, cfg.scan
    rng = np.random.default_rng(23)
    gpu = lambda a: torch.from_numpy(                             # noqa: E731
        np.ascontiguousarray(a, np.float32)).to(dev)

    # ---- 23. B and C against a float64 encode of the same rows -------------
    x = gpu(volumes(rng, (N_FULL,), scan.n_taus))
    kw = dict(enc_kw, mask_channel=True, input_layout="voxel")
    with _full_fp32():
        q64 = encode_q_f64(x, tuner.encoder, **kw)
        raw64 = squashed(q64.T, mcfg.use_mvg)
        outs = {"C": fi.encode_q1_packed(x, tuner.encoder, **kw),
                "C plain": fi.encode_q_plain(x, tuner.encoder, **kw),
                "B raw": fi.encode_quad_fused(x, tuner.encoder, **kw,
                                              **ranges)[2],
                "B raw plain": fi.encode_quad_fused_plain(
                    x, tuner.encoder, **kw, **ranges)[2]}
    err64 = {k: float((v.double() - (q64 if k[0] == "C" else raw64)).abs()
                      .max()) for k, v in outs.items()}
    log(f"B and C against a float64 encode at N={N_FULL} (largest |q| "
        f"{float(q64.abs().max()):.3f}): q by C {err64['C']:.3e}, by the "
        f"plain version (float32, TF32 off) {err64['C plain']:.3e}; B's raw "
        f"{err64['B raw']:.3e}, the plain version's {err64['B raw plain']:.3e}")
    check_rows("C vs float64", outs["C"].double(), q64, *CHECKS["raw"])
    check_rows("B raw vs float64", outs["B raw"].double(), raw64,
               *CHECKS["raw"])

    # ---- 24. B and C on padded widths and a ragged tile ---------------------
    xr = volumes(rng, (N_RAGGED,), scan.n_taus)
    for units in (13, 30):
        for act in ("gelu", "softplus"):
            c = dataclasses.replace(mcfg, no_units=units, activation=act)
            t = FineTuner(c, scan, device=dev)
            t.load_state_dict(init_params(c, scan,
                                          torch.Generator().manual_seed(units)))
            for layout in ("voxel", "channel"):
                xt = gpu(xr) if layout == "voxel" else gpu(xr.T)
                kw = dict(enc_kw, activation=act, mask_channel=True,
                          input_layout=layout)
                tag = f"U={units} {act} {layout}"
                check_close(f"C {tag}", fi.encode_q1_packed(xt, t.encoder,
                                                             **kw).T,
                            fi.encode_q_plain(xt, t.encoder, **kw).T, "raw")
                got = fi.encode_quad_fused(xt, t.encoder, **kw, **ranges)
                ref = fi.encode_quad_fused_plain(xt, t.encoder, **kw,
                                                 **ranges)
                check_close(f"B {tag}", got[0].T, ref[0].T, "mean")
                check_close(f"B {tag}", got[1].T, ref[1].T, "var", ref[0].T)
                check_close(f"B {tag}", got[2].T, ref[2].T, "raw")
    torch.cuda.synchronize()
    log(f"kernels B and C vs plain ok at U = 13, 30 (padded to 16, 32) under "
        f"gelu and softplus, both layouts, N={N_RAGGED}")
    wide_stream1_phase(dev, cfg, rng)
    wide = full_width_phase(dev, card, cfg, rng)

    # ---- 25. D at S = 2, 7 and 200, E at 2, 7 and 100 ----------------------
    seed = 29
    q_all = gpu(raw_head(rng, N_MC + 1))
    p_all = gpu(rng.normal(size=(N_MC + 1, 5)) * 0.7)
    for s_ in (2, 7, S_KL, S_MC):
        draws = sm.mc_draws(s_)
        z = gpu(sm.mc_philox_normals(seed, N_MC + 1, draws))
        for n in (N_MC, N_MC + 1):
            q = q_all[:n].contiguous()
            half = n // 2 + 5
            if s_ != S_KL:
                d_phase(sm, q, seed, z, s_, half, ranges)
            if s_ == S_MC:
                continue
            p = p_all[:n].contiguous()
            kl = sm.mc_kl_map(q, p, seed, no_samples=s_)
            check_rows(f"E S={s_} n={n}", kl,
                       sm.mc_kl_map_plain(q, p, gpu(sm.mc_philox_normals(
                           seed, n, s_))), 1e-4, 1e-4)
            zh = gpu(rng.normal(size=(s_, n, 2)))
            check_rows(f"E S={s_} n={n} host noise",
                       sm.mc_kl_map(q, p, z=zh, no_samples=s_),
                       sm.mc_kl_map_plain(q, p, zh), 1e-5, 1e-4)
            cut = torch.cat([sm.mc_kl_map(q[:half], p[:half], seed,
                                          no_samples=s_),
                             sm.mc_kl_map(q[half:], p[half:], seed,
                                          offset=half, no_samples=s_)])
            if not (torch.equal(kl, sm.mc_kl_map(q, p, seed, no_samples=s_))
                    and torch.equal(cut, kl)):
                raise AssertionError(f"E S={s_}: replay or offset cut "
                                     "differs")
    torch.cuda.synchronize()
    log(f"kernels D (S = 2, 7 iid, {S_MC}; both layouts) and E (S = 2, 7, "
        f"{S_KL}; {sm.KL_LANES} lanes a voxel) vs plain fed mc_philox_normals "
        f"and host normals ok at N={N_MC} and {N_MC + 1}: replay bit-equal, "
        "a cut at an offset draws what the whole does")
    return err64, wide


STREAM_COUNTERS = ("launches", "bf16_launches", "wgmma_launches",
                   "chunked_launches", "split_launches", "cluster_launches",
                   "stream_bf16_launches")


def bc_counts() -> dict:
    """Kernel B's and C's launch counters, by design and trunk, and A's
    and D's."""
    from qbold_vi_tpu_torch.ops import fused_infer as fi
    from qbold_vi_tpu_torch.ops import quadrature as tq
    from qbold_vi_tpu_torch.ops import summarize as sm

    out = {f"B.{c}": getattr(fi.encode_quad_fused, c) for c in STREAM_COUNTERS}
    out.update({f"C.{c}": getattr(fi.encode_q1_packed, c)
                for c in STREAM_COUNTERS})
    out["A"] = tq.quad_posterior_summaries.launches
    out["D"] = sm.mc_posterior_summaries_packed.launches
    return out


def zero_bc_counts() -> None:
    from qbold_vi_tpu_torch.ops import fused_infer as fi
    from qbold_vi_tpu_torch.ops import quadrature as tq
    from qbold_vi_tpu_torch.ops import summarize as sm

    for w in (fi.encode_quad_fused, fi.encode_q1_packed):
        for c in STREAM_COUNTERS:
            setattr(w, c, 0)
    tq.quad_posterior_summaries.launches = 0
    sm.mc_posterior_summaries_packed.launches = 0


def wide_stream1_phase(dev, cfg, rng) -> None:
    """Phase 24's wide trunk: a stream-1 request at 256 units under
    fused_infer "auto" runs kernel B's wgmma design (not the encoder
    and kernel A) and matches the same request on the CPU at
    tests/test_torch_infer.py's tolerances; a forced "on" runs the same
    kernel, bit for bit."""
    from qbold_vi_tpu_torch import infer
    from qbold_vi_tpu_torch.models.vi import FineTuner, init_params

    wide = dataclasses.replace(cfg.model, no_units=256,
                               compute_dtype="float32")
    sd = init_params(wide, cfg.scan, torch.Generator().manual_seed(256))
    tuners = {}
    for name, d, mode in (("card", dev, "auto"), ("cpu", "cpu", "auto"),
                          ("on", dev, "on")):
        t = FineTuner(dataclasses.replace(wide, fused_infer=mode), cfg.scan,
                      device=d)
        t.load_state_dict(sd)
        tuners[name] = t
    data = volumes(rng, (3, 12, 12, 3), cfg.scan.n_taus)
    zero_bc_counts()
    got = infer.posterior_maps(tuners["card"], data, use_first_op=True)
    moved = bc_counts()
    others = sum(v for k, v in moved.items()
                 if k.startswith("B.") and k != "B.wgmma_launches")
    if moved["B.wgmma_launches"] == 0 or moved["A"] or others:
        raise AssertionError(f"stream 1 at 256 units: launches {moved}, "
                             "want B's wgmma design only")
    ref = infer.posterior_maps(tuners["cpu"], data, use_first_op=True)
    err = 0.0
    for key in ("oef", "dbv", "r2p", "raw_log_stds"):
        if not np.isfinite(got[key]).all():
            raise AssertionError(f"stream 1 at 256 units: {key} not finite")
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-3, atol=3e-5,
                                   err_msg=f"stream 1 at 256 units: {key}")
        err = max(err, float(np.abs(got[key] - ref[key]).max()))
    forced = infer.posterior_maps(tuners["on"], data, use_first_op=True)
    for key in got:
        if not np.array_equal(forced[key], got[key]):
            raise AssertionError(f"stream 1 at 256 units under \"on\": "
                                 f"{key} differs from \"auto\"'s")
    log(f"stream 1 at 256 units (3 x 12 x 12 x 3) under \"auto\": kernel B "
        f"(wgmma) launched {moved['B.wgmma_launches']} times, A none; "
        f"maps finite and within rtol 1e-3 / atol 3e-5 of the CPU's (largest "
        f"difference {err:.3e}); a forced \"on\" gives the same maps")


WIDE_TRUNK = (256, 2)                # phase 47's full-width path
PAST_TRUNK = (320, 2)                # float32 past 256: the chunked design
PAST_WIDE_TRUNK = (384, 2)           # float32: the chunked design's widest
SPLIT_TRUNK = (448, 1)               # float32 past 384: the split design
CLUSTER_TRUNK = (833, 1)             # float32 past 768 units: the cluster
DRIFT_TRUNK = (832, 1)               # the 3xTF32 drift of 832 full units
CLUSTER_WIDE_TRUNK = (1280, 1)       # the widest of one product a block
CHUNK_TRUNK = (1281, 1)              # past 1280: a block's columns chunked
CHUNK_WIDE_TRUNK = (1472, 1)         # the cluster design's widest
DENSE_TRUNK = (768, 1)               # float32 on DENSE_TAU_STEP's 51 taus,
DENSE_TAU_STEP = 0.0016              # whose staged rows leave the split
                                     # block no room of their own: its
                                     # shared rows
DENSE_WIDE_TRUNK = (1472, 1)         # the cluster's shared rows on
DENSE_WIDE_TAU_STEP = 0.000635       # 128 taus (raised until they came)
WINDOW_TRUNK = (320, 2)              # float32 on WINDOW_TAU_STEP's 330
WINDOW_TAU_STEP = 0.000246           # taus, whose staged row is wider than
                                     # an activation row: the chunked
                                     # design's windowed rows
WINDOW_NARROW_TRUNK = (60, 2)        # OPTIMAL's width on 330 taus: the
                                     # wgmma design's windowed rows
WINDOW_WIDE_TRUNK = (1472, 1)        # the cluster's windowed rows on 330
                                     # taus (raised until they came)
FAULT_TRUNK = (100, 2)               # float32: the blob does not fit
DEEP_TRUNK = (60, 7)                 # float32: OPTIMAL's width, 7 blocks
N_WIDE_CMP = 50_003                  # kernels vs plain at wide widths
# phase 47's kernels by design: the float32 wgmma kernels up to 256 units
# (padded), the chunked wgmma ones at 320 and 384, the split wgmma ones at
# 448-768, the cluster wgmma ones at 832-1472 (at any tau count), the
# streamed ones past 128 units in bf16
WIDE_SYMBOLS = {
    ("B", "wgmma"): "qv_encode_quad_wg_kernel",
    ("C", "wgmma"): "qv_encode_q_wg_kernel",
    ("B", "chunked"): "qv_encode_quad_wgc_kernel",
    ("C", "chunked"): "qv_encode_q_wgc_kernel",
    ("B", "split"): "qv_encode_quad_wgx_kernel",
    ("C", "split"): "qv_encode_q_wgx_kernel",
    ("B", "cluster"): "qv_encode_quad_wgk_kernel",
    ("C", "cluster"): "qv_encode_q_wgk_kernel",
    ("B", "stream-bf16"): "qv_encode_quad_stream_bf16_kernel",
    ("C", "stream-bf16"): "qv_encode_q_stream_bf16_kernel"}
WIDE_KINDS = {"wgmma": ("encode_stream_wg.cu", "wgmma_launches", "-wgmma"),
              "chunked": ("encode_stream_wgc.cu", "chunked_launches",
                          "-chunked"),
              "split": ("encode_stream_wgx.cu", "split_launches", "-split"),
              "cluster": ("encode_stream_wgk.cu", "cluster_launches",
                          "-cluster"),
              "stream-bf16": ("encode_stream_bf16.cu", "stream_bf16_launches",
                              "-bf16-stream")}


def wide_kind_expected(units, trunk, n_taus) -> str:
    """The design phase 47 expects at this width: bf16 streams past 128
    units; float32 takes wgmma up to 256 (padded), the chunked wgmma at 320
    and 384, the split wgmma at 448-768, the cluster wgmma at 832-1472, on
    any ``n_taus`` (the staged rows of their own, in the activation rows,
    or there a window of k-steps at a time where a row is wider)."""
    from qbold_vi_tpu_torch.ops import fused_infer as fi

    if trunk == "bfloat16":
        return "stream-bf16"
    up = fi._padded_width(units)
    return ("wgmma" if up <= 256 else "chunked" if up <= 384
            else "split" if up <= 768 else "cluster")


def wide_kind(dev, units, nb, trunk, n_taus) -> str:
    """The design launch_plan gives kernel B at this trunk on this card,
    as a key of WIDE_KINDS (a resident plan fails the phase)."""
    from qbold_vi_tpu_torch.ops import fused_infer as fi

    design = fi._plan(fi._padded_width(units), nb, n_taus, n_taus + 1, trunk,
                      True, dev).design
    return {"streamed": "stream-bf16"}.get(design, design)


def wide_bound(key, units, nb, trunk, scan, raw_b, mvg) -> dict:
    """encode_bound (bf16: encode_bound_bf16) of kernel B (reads T + 1
    floats a voxel, writes 9; the quadrature of ``raw_b``) or C (writes 5)
    on the 1.03 M-voxel request at this trunk."""
    rest = N_FULL * (ops_encode(units, scan.n_taus, nb)
                     - 2 * (units * scan.n_taus + nb * units * units
                            + 5 * units))
    fn = encode_bound if trunk == "float32" else encode_bound_bf16
    writes, extra = (9, ops_quad(raw_b, mvg)) if key == "B" else (5, 0.0)
    return fn(N_FULL, units, scan.n_taus, nb,
              N_FULL * 4 * (scan.n_taus + 1 + writes), rest + extra)


def wide_tuner(dev, cfg, units, nb, trunk, scan=None):
    from qbold_vi_tpu_torch.models.vi import FineTuner, init_params

    scan = scan or cfg.scan
    mcfg = dataclasses.replace(cfg.model, no_units=units,
                               no_intermediate_layers=nb,
                               compute_dtype=trunk)
    t = FineTuner(mcfg, scan, device=dev)
    t.load_state_dict(init_params(mcfg, scan,
                                  torch.Generator().manual_seed(units)))
    return t


def full_width_phase(dev, card, cfg, rng) -> dict:
    """Phase 47: OPTIMAL's 1,032,192-voxel request at wide and deep trunks
    under fused_infer "auto" (init_params seed = the units), each kernel
    launched through posterior_maps with the counts set to 0 before and
    read after, and held against its plain version. At 256 units x 2
    blocks in float32 (the wgmma kernels), in bf16 (the streamed bf16
    kernels), at 320 x 2 and 384 x 2 in float32 (the chunked wgmma
    kernels), at 448 x 1 (the split wgmma kernels), at 833 x 1 (the
    cluster wgmma kernels, 896 padded), at 1281 x 1 (the cluster kernels
    with a block's columns in two output chunks, 1344 padded), at 768 x 1
    on a scan of 51 taus in float32 (the split kernels with the staged rows
    in the activation rows, where no buffer of their own fits beside the
    block), at 320 x 2 on 330 taus (the chunked kernels with the rows
    staged a window of k-steps at a time, where a staged row is wider than
    an activation row) and at 60 x 2 on 330 taus (the wgmma kernels,
    windowed likewise): posterior_maps by quadrature
    (kernel B) and by method="mc" (C, then D), the maps finite and of the
    request's shape; B and C against their plain versions at N_WIDE_CMP
    voxels (float32 at CHECKS; bf16 C within Q16_ULPS ulps, B against the
    plain quadrature of C's q at CHECKS); device ms of B and C beside their
    bounds and, at 256 x 2, 320 x 2, 448 x 1, 833 x 1, 1281 x 1, 768 x 1
    on 51 taus and 320 x 2 on 330 taus, the "off" route's (the encoder,
    then kernel A or D) and the fused route's ms a call by CUDA events on
    the same device request. At 832 x 1 (init_params seed 832, the 3xTF32
    drift fault), 1280 x 1 and 1472 x 1, at 1472 x 1 on a scan of 128 taus
    (the cluster kernels with shared rows) and on 330 taus (windowed rows;
    launch_plan raised at both before they came): B and C on the cluster
    kernels against their plain versions at N_WIDE_CMP voxels at CHECKS. At 100 x 2 (B and C) and 60 x 7 (B)
    in float32, where the resident blob does not fit (the wgmma kernels):
    the request through posterior_maps, the kernel against its plain
    version on the whole request, its device ms beside its bound. First,
    the wgmma, chunked, split and cluster wgmma kernels must hold HGMMA
    instructions in the built library's SASS."""
    from qbold_vi_tpu_torch import infer
    from qbold_vi_tpu_torch.ops import _cuda
    from qbold_vi_tpu_torch.ops import fused_infer as fi
    from qbold_vi_tpu_torch.ops.quadrature import quad_tile_summaries

    code = sass(_cuda.library()._name)
    hgmma = {WIDE_SYMBOLS[(k, kind)]: code.get(
        WIDE_SYMBOLS[(k, kind)], (0, {}))[1].get("HGMMA", 0)
        for k in "BC" for kind in ("wgmma", "chunked", "split", "cluster")}
    if not all(hgmma.values()):
        raise AssertionError(f"HGMMA instructions of the float32 wgmma, "
                             f"chunked, split and cluster B and C: {hgmma} "
                             "(each must hold some; or cuobjdump is "
                             "missing)")
    log(f"kernels B and C's float32 wgmma, chunked, split and cluster "
        f"designs take their products on wgmma: static HGMMA instructions "
        f"{hgmma}")
    scan = cfg.scan
    ranges = dict(oef_range=cfg.model.oef_range, min_oef=cfg.model.min_oef,
                  dbv_range=cfg.model.dbv_range, min_dbv=cfg.model.min_dbv,
                  dw_coeff=float(scan.dw_coeff * scan.hct))
    dense_scan = dataclasses.replace(scan, tau_step=DENSE_TAU_STEP)
    window_scan = dataclasses.replace(scan, tau_step=WINDOW_TAU_STEP)
    # each scan's request and comparison voxels, drawn at its first use
    data = {}

    def scan_data(sc):
        if sc.n_taus not in data:
            req = volumes(rng, REQUESTS[0], sc.n_taus)
            data[sc.n_taus] = (req, torch.from_numpy(req).to(dev),
                               torch.from_numpy(volumes(
                                   rng, (N_WIDE_CMP,), sc.n_taus)).to(dev))
        return data[sc.n_taus]

    scan_data(scan)
    # results by (kernel, design, trunk "UxNB"); launches by (kernel, design)
    # and by trunk
    out = {"launches": collections.Counter(), "err": {}, "ms": {},
           "plain_ms": {}, "bound": {}, "routes_ms": {}, "requests": {},
           "shapes": collections.defaultdict(list)}

    def main_path(t, units, nb, trunk, kind, method, key, req=None,
                  shape=None):
        """posterior_maps of the request `req` (the 11-tau one by default)
        by `method`, kernel `key` of the design `kind` counted (by trunk
        under `shape`, "UxNB" by default); returns the maps."""
        req = scan_data(scan)[0] if req is None else req
        counter = f"{key}.{WIDE_KINDS[kind][1]}"
        zero_bc_counts()
        maps = infer.posterior_maps(t, req, use_first_op=True,
                                    method=method, seed=47)
        torch.cuda.synchronize()
        counts = bc_counts()
        for k, v in maps.items():
            if not np.isfinite(v).all() or v.shape[:-1] != req.shape[:-1]:
                raise AssertionError(f"{units} x {nb} {trunk} {method}: "
                                     f"map {k} not finite or misshapen")
        want_d = counts["D"] > 0 if method == "mc" else counts["D"] == 0
        others = sum(v for k, v in counts.items()
                     if k[0] in "BC" and k != counter)
        if counts[counter] == 0 or not want_d or counts["A"] or others:
            raise AssertionError(f"{units} x {nb} {trunk} {method}: "
                                 f"launches {counts}, want {counter}")
        out["launches"][(key, kind)] += counts[counter]
        out["launches"][(key, kind, shape or f"{units}x{nb}")] += counts[
            counter]
        log(f"posterior_maps {method} at {units} x {nb} {trunk} on "
            f"{REQUESTS[0]} under \"auto\": {key} ({kind}) launched "
            f"{counts[counter]} times, D {counts['D']}, A {counts['A']}; "
            f"mean OEF {maps['oef'].mean():.4f}")
        return maps

    for (units, nb), trunk, routed, sc in (
            (WIDE_TRUNK, "float32", True, scan),
            (WIDE_TRUNK, "bfloat16", True, scan),
            (PAST_TRUNK, "float32", True, scan),
            (PAST_WIDE_TRUNK, "float32", False, scan),
            (SPLIT_TRUNK, "float32", True, scan),
            (CLUSTER_TRUNK, "float32", True, scan),
            (CHUNK_TRUNK, "float32", True, scan),
            (DENSE_TRUNK, "float32", True, dense_scan),
            (WINDOW_TRUNK, "float32", True, window_scan),
            (WINDOW_NARROW_TRUNK, "float32", False, window_scan)):
        req, block, x_cmp = scan_data(sc)
        x_full = block.reshape(-1, block.shape[-1])
        t = wide_tuner(dev, cfg, units, nb, trunk, sc)
        kind = wide_kind(dev, units, nb, trunk, sc.n_taus)
        want = wide_kind_expected(units, trunk, sc.n_taus)
        if kind != want:
            raise AssertionError(f"{units} x {nb} {trunk} at {sc.n_taus} "
                                 f"taus: plan {kind}, want {want}")
        shape = f"{units}x{nb}" + ("" if sc is scan else f"-t{sc.n_taus}")
        out["shapes"][kind].append(shape)
        enc = dict(se_idx=sc.se_idx,
                   multi_image=t.cfg.multi_image_normalisation,
                   activation=t.cfg.activation, n_blocks=nb, trunk=trunk,
                   mask_channel=True, input_layout="voxel")
        kw = dict(enc, mvg=t.cfg.use_mvg, **ranges)
        # ---- the main path, through the entry point -----------------------
        for method, key in (("quadrature", "B"), ("mc", "C")):
            main_path(t, units, nb, trunk, kind, method, key, req, shape)
        # ---- B and C against their plain versions ------------------------
        q = fi.encode_q1_packed(x_cmp, t.encoder, **enc)
        q_ref = fi.encode_q_plain(x_cmp, t.encoder, **enc)
        got = fi.encode_quad_fused(x_cmp, t.encoder, **kw)
        ref = fi.encode_quad_fused_plain(x_cmp, t.encoder, **kw)
        torch.cuda.synchronize()
        tag = f"{shape} {kind}"
        if trunk == "float32":
            check_close(f"C {tag}", q.T, q_ref.T, "raw")
            e_b = max(check_close(f"B {tag}", got[0].T, ref[0].T, "mean"),
                      check_close(f"B {tag}", got[1].T, ref[1].T, "var",
                                  ref[0].T),
                      check_close(f"B {tag}", got[2].T, ref[2].T, "raw"))
            how = "at CHECKS"
        else:
            ulps = [ulp_err(f"C {tag} row {j}", q[j], q_ref[j],
                            Q16_ULPS)[0] for j in range(5)]
            tail = [torch.stack(v) for v in quad_tile_summaries(
                q[0], q[1], q[2], q[3], q[4], mvg=t.cfg.use_mvg, **ranges)]
            e_b = max(check_close(f"B {tag} vs C's tail", got[0].T,
                                  tail[0].T, "mean"),
                      check_close(f"B {tag} vs C's tail", got[1].T,
                                  tail[1].T, "var", tail[0].T),
                      check_close(f"B {tag} vs C's tail", got[2].T,
                                  tail[2].T, "raw"))
            how = (f"C within {max(ulps):.2f} bf16 ulps, B against the "
                   "quadrature of C's q at CHECKS")
        out["err"][("C", kind, shape)] = float((q - q_ref).abs().max())
        out["err"][("B", kind, shape)] = e_b
        log(f"B and C at {units} x {nb} {trunk} ({kind}) vs plain at "
            f"N={N_WIDE_CMP}: {how}; largest |C - plain| "
            f"{out['err'][('C', kind, shape)]:.3e}")
        # ---- times: the kernels, their plain versions, the routes ----------
        for key, fn, plain in (
                ("B", lambda: fi.encode_quad_fused(x_full, t.encoder, **kw),
                 lambda: fi.encode_quad_fused_plain(x_full, t.encoder, **kw)),
                ("C", lambda: fi.encode_q1_packed(x_full, t.encoder, **enc),
                 lambda: fi.encode_q_plain(x_full, t.encoder, **enc))):
            out["ms"][(key, kind, shape)] = kernel_ms(
                fn, WIDE_SYMBOLS[(key, kind)])
            out["plain_ms"][(key, kind, shape)] = cuda_ms(plain, reps=2,
                                                          blocks=3)
        raw_b = fi.encode_quad_fused(x_full, t.encoder, **kw)[2]
        for key in "BC":
            out["bound"][(key, kind, shape)] = wide_bound(
                key, units, nb, trunk, sc, raw_b, t.cfg.use_mvg)
        if routed:
            draws = infer.mc_draws(S_MC, True)
            noise = infer._flat_noise(infer.draw_noise(
                "summaries", 47, 0, tuple(block.shape[:-1]), draws, dev),
                N_FULL)
            mc = dict(noise, no_samples=S_MC, antithetic=True)
            routes = {
                "B route": lambda: infer._chunk_fused(t, block, None),
                "off, quadrature": lambda: infer._chunk_encoder(
                    t, block, True, None),
                "C + D route": lambda: infer._chunk_fused(t, block, mc),
                "off, mc": lambda: infer._chunk_encoder(t, block, True, mc)}
            for name, fn in routes.items():
                out["routes_ms"][(name, kind, shape)] = cuda_ms(fn, reps=3,
                                                                blocks=5)
        for key, route, off in (("B", "B route", "off, quadrature"),
                                ("C", "C + D route", "off, mc")):
            ms, bd = out["ms"][(key, kind, shape)], out["bound"][
                (key, kind, shape)]
            line = (f"{key} {trunk} ({kind}) at {units} x {nb}: kernel "
                    f"{ms:.4f} ms on the device, plain "
                    f"{out['plain_ms'][(key, kind, shape)]:.4f} ms; bound "
                    f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                    f"({100 * bd['bound_ms'] / ms:.1f}%)")
            if routed:
                r_ms = out["routes_ms"][(route, kind, shape)]
                o_ms = out["routes_ms"][(off, kind, shape)]
                line += (f"; the fused route {r_ms:.4f} ms a call against "
                         f"the \"off\" route (encoder, then "
                         f"{'A' if key == 'B' else 'D'}) {o_ms:.4f} ms "
                         f"({'faster' if r_ms < o_ms else 'NOT faster'})")
            log(f"{line} on {REQUESTS[0]} [{card}]")
    # ---- 832 x 1, 1280 x 1, 1472 x 1 (and on 128 and 330 taus): the cluster
    # kernels against plain ---------------------------------------------------
    dense_wide = dataclasses.replace(scan, tau_step=DENSE_WIDE_TAU_STEP)
    for (units, nb), sc in ((DRIFT_TRUNK, scan), (CLUSTER_WIDE_TRUNK, scan),
                            (CHUNK_WIDE_TRUNK, scan),
                            (DENSE_WIDE_TRUNK, dense_wide),
                            (WINDOW_WIDE_TRUNK, window_scan)):
        x_cmp = (scan_data(scan)[2] if sc is scan else torch.from_numpy(
            volumes(rng, (N_WIDE_CMP,), sc.n_taus)).to(dev))
        t = wide_tuner(dev, cfg, units, nb, "float32", sc)
        kind = wide_kind(dev, units, nb, "float32", sc.n_taus)
        if kind != "cluster":
            raise AssertionError(f"{units} x {nb} float32 on {sc.n_taus} "
                                 f"taus: plan {kind}")
        rows = fi._plan(fi._padded_width(units), nb, sc.n_taus,
                        sc.n_taus + 1, "float32", True, dev).rows
        enc = dict(se_idx=sc.se_idx,
                   multi_image=t.cfg.multi_image_normalisation,
                   activation=t.cfg.activation, n_blocks=nb,
                   trunk="float32", mask_channel=True, input_layout="voxel")
        kw = dict(enc, mvg=t.cfg.use_mvg, **ranges)
        shape = f"{units}x{nb}" + ("" if sc is scan else f"-t{sc.n_taus}")
        tag = f"{shape} {kind}"
        q = fi.encode_q1_packed(x_cmp, t.encoder, **enc)
        got = fi.encode_quad_fused(x_cmp, t.encoder, **kw)
        ref = fi.encode_quad_fused_plain(x_cmp, t.encoder, **kw)
        e_c = check_close(f"C {tag}", q.T, fi.encode_q_plain(
            x_cmp, t.encoder, **enc).T, "raw")
        e_b = [check_close(f"B {tag}", got[0].T, ref[0].T, "mean"),
               check_close(f"B {tag}", got[1].T, ref[1].T, "var", ref[0].T),
               check_close(f"B {tag}", got[2].T, ref[2].T, "raw")]
        out["err"][("C", kind, shape)] = e_c
        out["err"][("B", kind, shape)] = max(e_b)
        log(f"B and C at {units} x {nb} float32 on {sc.n_taus} taus ({kind},"
            f" {rows} rows, init_params seed {units}) vs plain at "
            f"N={N_WIDE_CMP} within CHECKS: largest |C - plain| {e_c:.3e}, "
            "B's means / vars / raw " + " / ".join(f"{e:.3e}" for e in e_b))
    _, block, _ = scan_data(scan)
    x_full = block.reshape(-1, block.shape[-1])
    # ---- 100 x 2 and 60 x 7 in float32: the resident blob does not fit ------
    for (units, nb), keys in ((FAULT_TRUNK, "BC"), (DEEP_TRUNK, "B")):
        t = wide_tuner(dev, cfg, units, nb, "float32")
        kind = wide_kind(dev, units, nb, "float32", scan.n_taus)
        if kind != "wgmma":
            raise AssertionError(f"{units} x {nb} float32: plan {kind}")
        enc = dict(se_idx=scan.se_idx,
                   multi_image=t.cfg.multi_image_normalisation,
                   activation=t.cfg.activation, n_blocks=nb,
                   trunk="float32", mask_channel=True, input_layout="voxel")
        kw = dict(enc, mvg=t.cfg.use_mvg, **ranges)
        raw_b = None
        for key in keys:
            main_path(t, units, nb, "float32", kind,
                      "quadrature" if key == "B" else "mc", key)
            if key == "B":
                fn = lambda: fi.encode_quad_fused(x_full, t.encoder,  # noqa
                                                  **kw)
                plain = lambda: fi.encode_quad_fused_plain(  # noqa: E731
                    x_full, t.encoder, **kw)
                got, ref = fn(), plain()
                raw_b = got[2]
                e = max(check_close(f"B {units}x{nb}", got[0].T, ref[0].T,
                                    "mean"),
                        check_close(f"B {units}x{nb}", got[1].T, ref[1].T,
                                    "var", ref[0].T),
                        check_close(f"B {units}x{nb}", got[2].T, ref[2].T,
                                    "raw"))
            else:
                fn = lambda: fi.encode_q1_packed(x_full, t.encoder,  # noqa
                                                 **enc)
                plain = lambda: fi.encode_q_plain(  # noqa: E731
                    x_full, t.encoder, **enc)
                e = check_close(f"C {units}x{nb}", fn().T, plain().T, "raw")
            ms = kernel_ms(fn, WIDE_SYMBOLS[(key, kind)])
            bd = wide_bound(key, units, nb, "float32", scan, raw_b,
                            t.cfg.use_mvg)
            res = {"err": e, "ms": ms, "plain_ms": cuda_ms(plain, reps=2,
                                                           blocks=3),
                   **{k: bd[k] for k in ("bound_ms", "bound_by")},
                   "launches": out["launches"][(key, kind, f"{units}x{nb}")]}
            out["requests"][f"{key}-{units}x{nb}"] = res
            log(f"{key} at {units} x {nb} float32 ({kind}) on {REQUESTS[0]}"
                f": vs plain on the whole request within CHECKS (largest "
                f"{e:.3e}); kernel {ms:.4f} ms, plain {res['plain_ms']:.4f} "
                f"ms; bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
                f"({100 * bd['bound_ms'] / ms:.1f}%) [{card}]")
    # the kernels line: each kernel by design at the first trunk phase 47
    # ran it at, and the float32 designs again at each further trunk (the
    # windowed rows' at "-t330")
    entries = [(key, kind, out["shapes"][kind][0], "")
               for kind in WIDE_KINDS for key in ("B", "C")]
    entries += [(key, kind, shape, f"-{shape}")
                for kind in ("wgmma", "chunked", "split", "cluster")
                for shape in out["shapes"][kind][1:] for key in "BC"]
    out["kernels"] = [{
        "name": f"{key}{WIDE_KINDS[kind][2]}{suffix}", "route": "cuda",
        "source": f"qbold_vi_tpu_torch/csrc/{WIDE_KINDS[kind][0]}",
        "replaces": "qbold_vi_tpu/ops/pallas_infer.py:"
                    + ("353" if key == "B" else "246"),
        "launches": out["launches"][(key, kind) if not suffix
                                    else (key, kind, shape)],
        "max_abs_err": out["err"][(key, kind, shape)],
        "ms": out["ms"][(key, kind, shape)],
        "plain_ms": out["plain_ms"][(key, kind, shape)],
        **{k: out["bound"][(key, kind, shape)][k] for k in ("bound_ms",
                                                             "bound_by")},
        "library_ms": None}
        for key, kind, shape, suffix in entries]
    return out


def d_phase(sm, q, seed, z, s_, half, ranges) -> None:
    """Phase 25's kernel D at S = s_: both layouts against the plain
    version fed mc_philox_normals z, a replay, and a cut at voxel
    ``half`` drawing what the whole request does."""
    n = q.shape[0]
    kw = dict(ranges, no_samples=s_)
    got = sm.mc_posterior_summaries(q, seed, **kw)
    got_t = sm.mc_posterior_summaries_packed(q.T.contiguous(), seed, **kw)
    if not all(torch.equal(a, b.T) for a, b in zip(got, got_t)):
        raise AssertionError(f"D S={s_}: the packed entry differs")
    ref = sm.mc_posterior_summaries_plain(q, z[:, :n], **kw)
    check_close(f"D S={s_} n={n}", got[0], ref[0], "mean")
    check_close(f"D S={s_} n={n}", got[1], ref[1], "var", ref[0])
    parts = [sm.mc_posterior_summaries(q[:half], seed, **kw),
             sm.mc_posterior_summaries(q[half:], seed, offset=half, **kw)]
    again = sm.mc_posterior_summaries(q, seed, **kw)
    if not all(torch.equal(a, b) and torch.equal(
            torch.cat([parts[0][i], parts[1][i]]), a)
            for i, (a, b) in enumerate(zip(got, again))):
        raise AssertionError(f"D S={s_}: replay or offset cut differs")


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


def cudnn_conv_backward(x, w_oihw, ct, mask=(True, True, True)):
    """The one aten.convolution_backward call with output_mask ``mask``
    (dx, dw, db; all three by default): (dx NHWC, dw OIHW, db), None where
    not asked for."""
    return torch.ops.aten.convolution_backward(
        ct.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w_oihw, [w_oihw.shape[0]],
        [1, 1], [1, 1], [1, 1], False, [0, 0], 1, list(mask))


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
    The trace drops most records of H's ~2 us weight split or image (6 of
    21 on the H100), so one traced launch suffices for it."""
    return {s: kernel_ms(fn, s, calls,
                         1 if "wsplit" in s or "wimg" in s else None)
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
    from qbold_vi_tpu_torch.models.vi import FineTuner, init_params
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
    trainer = Trainer(fresh_save(cfg), device=dev, logger=logger)
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
    init = init_params(mcfg, scan, torch.Generator().manual_seed(
        cfg.train.seed))
    for tag, c, weights, kinks in step_runs(cfg, init, pretrained):
        result = {}
        for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
            t = FineTuner(c.model, scan, device=device)
            t.load_state_dict(weights)
            opt = optim.make_pretrain_optimizer(t.named_parameters(), c.train)
            result[name] = stepped(t, steps.make_pretrain_step(t, c, opt)(
                {k: v.to(device) for k, v in small.items()}, seed=3))
        worst = check_step(f"one pretrain step ({tag}) on the card vs the CPU",
                           result["card"], result["cpu"], weights,
                           float(cfg.train.pt_lr), kinks)
        log(f"one pretrain step ({tag}) on the card agrees with the CPU: loss "
            f"{result['card'][0]:.7g} vs {result['cpu'][0]:.7g}, gradients "
            f"within {worst:.2e} of their scale "
            f"({'1e-2' if kinks else 'GRAD_TOL'}), updates within tolerance")

    # ---- 16. the two-phase path: prepare_real + finetune under "on" -------
    data = volumes(np.random.default_rng(0), TRAIN_VOLUMES, scan.n_taus)
    cv.conv3x3.fwd_launches = cv.conv3x3.bwd_launches = 0
    fe.fused_elbo_forward.launches = fe.fused_elbo_backward.launches = 0
    fe.fused_elbo_backward.from_state = 0
    trainer.finetune(data, epochs=2)
    torch.cuda.synchronize()
    n_steps = 2 * cfg.train.ft_steps_per_epoch
    n_conv = 2 * mcfg.no_intermediate_layers
    cropped = data_pipe.blank_crop(data)
    prior_fwd = n_conv * -(-cropped.shape[0] // 4)      # predict_priors chunks
    launches = {"H_fwd": cv.conv3x3.fwd_launches,
                "H_bwd": cv.conv3x3.bwd_launches,
                "F_fwd": fe.fused_elbo_forward.launches,
                "F_bwd": fe.fused_elbo_backward.launches,
                "F_bwd_from_state": fe.fused_elbo_backward.from_state}
    log(f"two-phase fine-tune (2 epochs x {cfg.train.ft_steps_per_epoch} "
        f"steps, fused_conv on) launches: {launches}; expected H "
        f"{n_conv * n_steps} + {prior_fwd} (prepare_real) forward, "
        f"{n_conv * n_steps} backward")
    if (launches["H_fwd"], launches["H_bwd"]) != (
            n_conv * n_steps + prior_fwd, n_conv * n_steps) or \
            (launches["F_fwd"], launches["F_bwd"],
             launches["F_bwd_from_state"]) != (n_steps,) * 3:
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
    tuners = {}
    for name, c in (("on", cfg), ("off", off)):
        t = FineTuner(c.model, scan, device=dev)
        t.load_state_dict(state)
        tuners[name] = (t, optim.make_finetune_optimizer(t.parameters(),
                                                         c.train), c)
    for tag, _, weights, kinks in step_runs(cfg, init, state):
        result = {}
        for name, c in (("on", cfg), ("off", off)):
            c = smooth(c) if not kinks else c
            t = FineTuner(c.model, scan, device=dev)
            t.load_state_dict(weights)
            opt = optim.make_finetune_optimizer(t.parameters(), c.train)
            result[name] = stepped(t, steps.make_finetune_step(t, c, opt)(
                batch, seed=11))
        worst = check_step(f"one fine-tune step ({tag}) under fused_conv on "
                           "vs off", result["on"], result["off"], weights,
                           float(cfg.train.ft_lr), kinks)
        log(f"one fine-tune step ({tag}) through H agrees with cuDNN: loss "
            f"{result['on'][0]:.7g} vs {result['off'][0]:.7g}, gradients "
            f"within {worst:.2e} of their scale "
            f"({'1e-2' if kinks else 'GRAD_TOL'}), updates within tolerance")

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


# ---- kernel S, the streaming pretrain and the WLS baseline ----------------

S_SYMBOLS = ("qv_synth_batch_kernel", "qv_synth_noise_kernel")


def mixture_mean(lo, hi, mean, std, prop, truncated) -> tuple:
    """(mean, sd) of one population mixture (synth.sample_batch_params):
    ``prop`` uniform on [lo, hi], the rest N(mean, std) clipped to [lo, hi]
    (OEF) or truncated to it (DBV), by quadrature on a fine grid."""
    x = np.linspace(mean - 12.0 * std, mean + 12.0 * std, 400_001)
    w = np.exp(-0.5 * ((x - mean) / std) ** 2)
    if truncated:
        w = w * ((x >= lo) & (x <= hi))
    else:
        x = np.clip(x, lo, hi)
    w = w / w.sum()
    m1 = prop * (lo + hi) / 2 + (1 - prop) * float(np.sum(w * x))
    m2 = prop * (lo * lo + lo * hi + hi * hi) / 3 + (1 - prop) * float(
        np.sum(w * x * x))
    return m1, float(np.sqrt(m2 - m1 * m1))


def check_labels(tag, y, cfg) -> str:
    """Raise unless the batch's labels lie in the mixture's ranges, R2' is
    (dw_coeff hct OEF) DBV in float32, and the OEF and DBV means lie within
    6 standard errors of the mixture's."""
    s, scan = cfg.synth, cfg.scan
    y = y.reshape(-1, 3).cpu().numpy()
    oef, dbv = y[:, 0], y[:, 1]
    if not (s.oef_start <= oef.min() and oef.max() <= s.oef_end
            and s.dbv_start <= dbv.min() and dbv.max() <= s.dbv_end):
        raise AssertionError(f"S {tag}: labels outside the mixture's ranges")
    k = np.float32(scan.dw_coeff * scan.hct)
    if not np.array_equal(y[:, 2], (k * oef) * dbv):
        raise AssertionError(f"S {tag}: r2p is not (k oef) dbv")
    out = []
    for name, v, args in (
            ("OEF", oef, (s.oef_start, s.oef_end, s.oef_mean, s.oef_std,
                          s.uniform_prop, False)),
            ("DBV", dbv, (s.dbv_start, s.dbv_end, s.dbv_mean, s.dbv_std,
                          s.uniform_prop, True))):
        m, sd = mixture_mean(*args)
        z = (float(v.mean()) - m) / (sd / np.sqrt(v.size))
        if abs(z) > 6.0:
            raise AssertionError(f"S {tag}: {name} mean {v.mean():.6f} is "
                                 f"{z:.1f} standard errors off {m:.6f}")
        out.append(f"{name} mean {v.mean():.5f} (mixture {m:.5f}, "
                   f"{z:+.2f} SE)")
    return ", ".join(out)


def synth_bound(n: int, t: int, misalign: bool,
                count: str = "function") -> dict:
    """Kernel S on n voxels of t taus, by ``count``:

    * "function", the bound reported: what the function needs, whatever
      the design -- y and x written once;
    * "design": this design's bytes -- y and x written, then x read and
      written again by the noise pass.

    Both against the float32 operations of OPS (the signal, the noise, the
    draws and their Box-Muller pairs); Philox's integer work is not
    counted."""
    floats = 3 + (3 * t if count == "design" else t)
    return bound(n * floats * 4, synth_ops(n, t, misalign))


def synth_ops(n: int, t: int, misalign: bool) -> float:
    """Kernel S's float32 operations (OPS) on n voxels of t taus."""
    pairs = 1 + int(misalign) + 2 * -(-t // 4)
    return float(n * (t * (OPS["clen_i"] + OPS["signal"]
                           + OPS["synth_noise"])
                      + OPS["synth_voxel"] + OPS["box_muller"] * pairs))


def wls_signals(rng, shape, scan, dev) -> np.ndarray:
    """Noisy ASE magnitudes (x 800, noise at mean / 80) of uniform (OEF,
    DBV) on the card, as tools/validate_finetune_torch.py makes them."""
    from qbold_vi_tpu_torch.ops import physics

    f = np.float32
    oef = torch.from_numpy(rng.uniform(0.05, 0.8, shape).astype(f)).to(dev)
    dbv = torch.from_numpy(rng.uniform(0.003, 0.195, shape).astype(f)).to(
        dev)
    with torch.no_grad():
        sig = physics.ase_signal(oef, dbv, scan).cpu().numpy() * 800.0
    return (sig + rng.normal(size=sig.shape) * sig.mean() / 80.0).astype(f)


def check_wls(name, got, ref, signals, scan) -> float:
    """WLS maps against a reference fit: rtol 1e-5 plus the float32
    rounding two fits carry (baseline.fit_rounding, the gate of
    tests/torch_parity_utils.py::assert_wls_close). Returns the largest
    absolute difference."""
    from qbold_vi_tpu_torch.baseline import fit_rounding

    atol = fit_rounding(signals, ref, scan)
    worst = 0.0
    for i, key in enumerate(("oef", "dbv", "r2p")):
        r = ref[..., i].astype(np.float64)
        e = np.abs(got[..., i].astype(np.float64) - r)
        if not np.isfinite(got[..., i]).all() or (
                e > 1e-5 * np.abs(r) + atol[..., i]).any():
            raise AssertionError(f"{name}: {key} differs by {e.max():.3e}")
        worst = max(worst, float(e.max()))
    return worst


def stream_phases(dev, card, base) -> dict:
    """Phases 26-28: kernel S against its plain version fed its replayed
    draws; Trainer.pretrain in streaming mode (S launched a step) and one
    streaming step on the card against the CPU; baseline.wls_maps on the
    card against the CPU, and its throughput. Returns S's JSON entry and
    the walls."""
    from qbold_vi_tpu_torch import baseline
    from qbold_vi_tpu_torch.models.vi import FineTuner, init_params
    from qbold_vi_tpu_torch.ops import synth_batch as sb
    from qbold_vi_tpu_torch.train import optim, steps
    from qbold_vi_tpu_torch.train.trainer import (Trainer, WeightStatus,
                                                  stream_steps_per_epoch)

    scan, t_n = base.scan, base.scan.n_taus
    b = base.train.pt_batch_size
    n = b * 500

    def synth_cfg(quad_rule="auto", noise=True, **synth):
        return dataclasses.replace(
            base, synth=dataclasses.replace(base.synth, **synth),
            scan=dataclasses.replace(scan, simulate_noise=noise),
            model=dataclasses.replace(base.model, quad_rule=quad_rule))

    # ---- 26. S against its plain version ----------------------------------
    mixed = dict(uniform_prop=0.3, misalign_prob=0.5)
    cases = (("OPTIMAL, full batch", base, b),
             ("mixture + misalignment", synth_cfg(**mixed), 16),
             ("mixture + misalignment, gj16, no noise",
              synth_cfg("gj16", False, **mixed), 16))
    seed = 2 ** 40 + 17
    s_err = 0.0
    for tag, c, bb in cases:
        got = sb.synth_batch(c, bb, seed, device=dev)
        again = sb.synth_batch(c, bb, seed, device=dev)
        draws = sb.synth_philox_draws(seed, bb * 500, t_n)
        ref = steps.stream_synthetic_batch(c, bb, draws, device=dev)
        torch.cuda.synchronize()
        e = max(check_rows(f"S {tag}: x", got["x"], ref["x"]),
                check_rows(f"S {tag}: y", got["y"], ref["y"]))
        if c is base:
            s_err = e
        if not all(torch.equal(got[k], again[k]) for k in ("x", "y")):
            raise AssertionError(f"S {tag}: a seed does not replay")
        labels = check_labels(tag, got["y"], c)
        log(f"S vs plain ({tag}, {bb * 500:,} voxels): x and y within "
            f"{e:.3e} (rtol {ROW_TOL[0]} atol {ROW_TOL[1]}), replays bit for "
            f"bit; {labels}")

    # ---- 27. the streaming pretrain ---------------------------------------
    cfg = dataclasses.replace(base, train=dataclasses.replace(
        base.train, pt_on_device_synth=True, no_pt_epochs=2))
    spe = stream_steps_per_epoch(cfg)
    logged = []

    def logger(phase, epoch, m):
        logged.append(dict(m))
        log(f"[{phase}, streaming] epoch {epoch}: " + " ".join(
            f"{k}={v:.6g}" for k, v in m.items()) + f" [{card}]")

    trainer = Trainer(fresh_save(cfg), device=dev, logger=logger)
    sb.synth_batch.launches = sb.synth_batch.noise_launches = 0
    t0 = time.perf_counter()
    trainer.pretrain()
    torch.cuda.synchronize()
    pt_wall = time.perf_counter() - t0
    s_launches = sb.synth_batch.launches
    noise_launches = sb.synth_batch.noise_launches
    log(f"streaming pretrain: {len(logged)} epochs x {spe} steps at batch "
        f"{b} (a fresh batch of {n:,} voxels a step); fold build "
        f"{logged[0]['data_time_s']:.3f} s, epochs "
        + ", ".join(f"{m['epoch_time_s']:.3f} s" for m in logged)
        + f", whole call {pt_wall:.2f} s; S launched {s_launches} + "
        f"{noise_launches} (noise pass) [{card}]")
    if (s_launches, noise_launches) != (2 * spe, 2 * spe):
        raise AssertionError("the streaming pretrain did not launch S once "
                             f"a step: {s_launches}, {noise_launches}")
    if len(logged) != 2 or not all(np.isfinite(v) for m in logged
                                   for v in m.values()):
        raise AssertionError(f"streaming pretrain metrics: {logged}")
    if trainer.status is not WeightStatus.PRE_TRAINED:
        raise AssertionError("pretrain() left the trainer unpretrained")
    fold = trainer.pretrain_val_metrics(fold=True)
    if not np.isfinite(fold["val_loss"]):
        raise AssertionError(f"fold metrics: {fold}")
    pretrained = {k: v.clone() for k, v in trainer.tuner.state_dict().items()}

    t = FineTuner(cfg.model, scan, device=dev)
    t.load_state_dict(pretrained)
    opt = optim.make_pretrain_optimizer(t.named_parameters(), cfg.train)
    stream_step = steps.make_pretrain_stream_step(t, cfg, opt)
    step_ms = wall_ms(lambda: stream_step(seed=5))
    log(f"streaming pretrain step (S + stream-1 loss + backward + AdamW) "
        f"wall {step_ms:.3f} ms at batch {b} [{card}]")
    step_prof = profile(lambda: stream_step(seed=5), 5,
                        "streaming pretrain step", card)

    # one streaming step on the card (S) against the CPU (the plain
    # version of S's replayed draws) from one seed
    small = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, pt_batch_size=32))
    init = init_params(cfg.model, scan, torch.Generator().manual_seed(
        cfg.train.seed))
    for tag, c, weights, kinks in step_runs(small, init, pretrained):
        result = {}
        for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
            tn = FineTuner(c.model, scan, device=device)
            tn.load_state_dict(weights)
            o = optim.make_pretrain_optimizer(tn.named_parameters(), c.train)
            before = sb.synth_batch.launches
            m, _ = steps.make_pretrain_stream_step(tn, c, o)(seed=3)
            torch.cuda.synchronize()
            if sb.synth_batch.launches - before != (name == "card"):
                raise AssertionError(f"streaming step on the {name}: S "
                                     "launched "
                                     f"{sb.synth_batch.launches - before}")
            result[name] = stepped(tn, m)
        worst = check_step(f"one streaming step ({tag}) on the card vs the "
                           "CPU", result["card"], result["cpu"], weights,
                           float(cfg.train.pt_lr), kinks)
        log(f"one streaming step ({tag}) on the card (S) agrees with the CPU "
            f"(S's replayed draws): loss {result['card'][0]:.7g} vs "
            f"{result['cpu'][0]:.7g}, gradients within {worst:.2e} of their "
            f"scale ({'1e-2' if kinks else 'GRAD_TOL'}), updates within "
            "tolerance")

    # S's device time, its plain version's, the plain version's launches
    log_clocks("before S's timings")
    parts = kernel_ms_parts(lambda: sb.synth_batch(base, b, 11, device=dev),
                            S_SYMBOLS)
    s_ms = sum(parts.values())
    dd = {k: torch.from_numpy(v).to(dev)
          for k, v in sb.synth_philox_draws(11, n, t_n).items()}
    plain = lambda: steps.stream_synthetic_batch(base, b, dd)  # noqa: E731
    plain_ms = cuda_ms(plain, reps=2)
    plain_prof = profile(plain, 2, "plain version of S (draws on the card)",
                         card)
    mis = base.synth.misalign_prob > 0.0
    s_bound = synth_bound(n, t_n, mis)
    s_design = synth_bound(n, t_n, mis, "design")["bound_ms"]
    s_ops = bound(0, synth_ops(n, t_n, mis))["bound_ms"]
    log(f"S at {n:,} voxels: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in parts.items())
        + f", {s_ms:.4f} ms in all on the device, "
        f"{(s_launches + noise_launches) / (2 * spe):.0f} launches a step "
        f"(pass 1 and the noise pass); plain {plain_ms:.3f} ms in "
        f"{plain_prof['launches']:.0f} launches a batch; bound "
        f"{s_bound['bound_ms']:.5f} ms ({s_bound['bound_by']}; "
        f"{100 * s_bound['bound_ms'] / s_ms:.1f}% of S), operations "
        f"{s_ops:.5f} ms; this design's count {s_design:.5f} ms "
        f"({100 * s_design / s_ms:.1f}%, "
        f"{n * (3 + 3 * t_n) * 4 / 1e6:.1f} MB) [{card}]")
    log_clocks("after S's timings")

    # ---- 28. the WLS baseline ---------------------------------------------
    rng = np.random.default_rng(28)
    x = wls_signals(rng, REQUESTS[1], scan, dev)
    got = baseline.wls_maps(x, scan, device=dev)
    ref = baseline.wls_maps(x, scan, device="cpu")
    wls_err = check_wls("wls_maps card vs CPU", got, ref, x, scan)
    big = wls_signals(rng, REQUESTS[0], scan, dev)
    n_big = int(np.prod(REQUESTS[0]))
    wls_wall = wall_ms(lambda: baseline.wls_maps(big, scan, device=dev))
    big_d = torch.from_numpy(big).to(dev)
    with torch.no_grad():
        wls_dev = cuda_ms(lambda: baseline.fit_wls(big_d, scan))
    log(f"wls_maps on the card agrees with the CPU on {REQUESTS[1]} (within "
        f"{wls_err:.3e}); on {REQUESTS[0]}: wall {wls_wall:.3f} ms "
        f"({n_big / wls_wall / 1e3:.1f} M voxels/s, host copies included), "
        f"fit_wls on the card {wls_dev:.4f} ms ({n_big / wls_dev / 1e3:.1f} "
        f"M voxels/s) [{card}]")

    kernel = {
        "name": "synth_batch", "route": "cuda",
        "source": "qbold_vi_tpu_torch/csrc/synth_batch.cu",
        "replaces": "qbold_vi_tpu/train/steps.py:389",
        "launches": s_launches, "max_abs_err": s_err, "ms": s_ms,
        "plain_ms": plain_ms, **s_bound, "library_ms": None,
        "design_bound_ms": s_design}
    return {"kernels": [kernel],
            "stream_pretrain_epoch_s": [m["epoch_time_s"] for m in logged],
            "stream_pretrain_step_ms": step_ms,
            "stream_pretrain_step_busy": step_prof["busy_ms"]
            / step_prof["wall_ms"],
            "stream_pretrain_step_launches": step_prof["launches"],
            "synth_plain_launches": plain_prof["launches"],
            "wls_wall_ms": wls_wall, "wls_fit_ms": wls_dev}


# ---- the bf16 trunk: kernels B, C and H at compute_dtype="bfloat16" --------

# kernel vs plain at bf16, in bf16 ulps of the output's largest magnitude:
# H's outputs within 2 (one rounding of float32 sums taken in another
# order), C's q rows within 4 (a one-ulp move of an activation travels
# through the later layers); the maps of a bf16 request against the float32
# maps of the same weights at the JAX package's bf16 gates: stream 1 at the
# fused encode's, rtol 0.05 / atol 0.03 (tests/test_pallas_infer.py:217),
# stream 2 at the encoder's, rtol / atol 0.05 (tests/test_model.py:132-133),
# the variance maps in their square roots, the posterior standard
# deviations; a bf16 step's gradients across
# devices or conv routes within 1e-2 of their scale, its loss at rtol 1e-4
H16_ULPS, Q16_ULPS = 2, 4
BF16_GATE = {True: (0.05, 0.03), False: (0.05, 0.05)}   # by use_first_op
BF16_STEP_TOL = (1e-4, 1e-2)
# the fine-tune fold, an odd plane, a serving chunk (timed: the fold and
# the serving chunk)
H16_SHAPES = ((304, 25, 25, 60, 60), (9, 3, 11, 5, 7), (16, 96, 96, 60, 60))
H16_TIMED = (H16_SHAPES[0], H16_SHAPES[2])
H16_SYMBOLS = dict(
    fwd=("qv_conv3x3_wimg_bf16_kernel", "qv_conv3x3_fwd_wg_bf16_kernel"),
    bwd=("qv_conv3x3_wimg_bf16_kernel", "qv_conv3x3_dx_wg_bf16_kernel",
         "qv_conv3x3_dw_wg_bf16_kernel", "qv_conv3x3_reduce_kernel"))
# the kernels that must take their products on wgmma (HGMMA in the SASS)
H16_WGMMA = ("qv_conv3x3_fwd_wg_bf16_kernel", "qv_conv3x3_dx_wg_bf16_kernel",
             "qv_conv3x3_dw_wg_bf16_kernel")
BC16_SYMBOLS = dict(B="qv_encode_quad_bf16_kernel",
                    C="qv_encode_q_bf16_kernel")


def bf16_ulp(ref: torch.Tensor) -> float:
    """One bf16 ulp at the largest magnitude of ref (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(float(ref.abs().max()))) - 7)


def ulp_err(name, got, ref, ulps, moved=0.0) -> tuple:
    """Raise unless |got - ref| <= ``ulps`` bf16 ulps of ref's largest
    magnitude; returns (the largest difference in those ulps, the share of
    elements that differ by more than ``moved`` of that magnitude: for a
    bf16 output, the share one rounding moved)."""
    got, ref = got.double(), ref.double()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    ulp = bf16_ulp(ref)
    d = (got - ref).abs()
    err = float(d.max()) / ulp
    if err > ulps:
        raise AssertionError(f"{name}: differs from the plain version by "
                             f"{err:.2f} bf16 ulps of its scale (gate {ulps})")
    return err, float((d > moved * float(ref.abs().max())).double().mean())


def conv_bound_bf16(shape, backward: bool) -> dict:
    """Kernel H at bf16: each input read once and each output written once,
    two bytes an element (forward: x, w, b in, y out; backward: x, ct, w
    in, dx, dw, db out); 2 * 9 * Ci * Co operations a pixel a pass at the
    dense bf16 tensor-core peak, plus the bias adds (forward) or db's sums
    (backward) at the float32 peak."""
    n, h, w, ci, co = shape
    p = n * h * w
    elems = (2 * p * ci + p * co + 2 * 9 * ci * co + co if backward
             else p * ci + p * co + 9 * ci * co + co)
    passes = 2 if backward else 1
    t_bytes = 2 * elems / PEAK_BYTES * 1e3
    t_ops = (passes * 2 * 9 * ci * co * p / PEAK_BF16
             + p * co / PEAK_FLOPS) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def conv_pass_bound_bf16(shape, part: str) -> dict:
    """One pass of kernel H at bf16 alone, as conv_bound_bf16 counts: the
    forward (x, w, b in, y out; the bias adds), dx (ct, w in, dx out) or
    dw/db (x, ct in, dw, db out; db's sums); 2 * 9 * Ci * Co operations a
    pixel at the dense bf16 peak."""
    n, h, w, ci, co = shape
    p = n * h * w
    elems = {"fwd": p * ci + p * co + 9 * ci * co + co,
             "dx": p * co + 9 * ci * co + p * ci,
             "dw": p * ci + p * co + 9 * ci * co + co}[part]
    t_bytes = 2 * elems / PEAK_BYTES * 1e3
    t_ops = (2 * 9 * ci * co * p / PEAK_BF16
             + (0 if part == "dx" else p * co) / PEAK_FLOPS) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def encode_bound_bf16(n, units, n_taus, n_blocks, n_bytes, rest_ops) -> dict:
    """Kernels B and C with the bf16 trunk: the trunk's FMAs (U T + nb U^2 a
    voxel) at the dense bf16 tensor-core peak, the float32 head's (5 U) as
    3xTF32 at the TF32 peak, the rest (normalisation, biases, activations,
    B's quadrature) at the float32 peak, and the bytes; the largest."""
    trunk = n * (units * n_taus + n_blocks * units * units)
    head = n * 5 * units
    t_tc = (2 * trunk / PEAK_BF16 + 3 * 2 * head / PEAK_TF32) * 1e3
    t_rest = rest_ops / PEAK_FLOPS * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    ms = max(t_tc, t_rest, t_bytes)
    return {"bound_ms": ms,
            "bound_by": "bytes" if t_bytes == ms else "operations",
            "trunk_products_ms": 2 * trunk / PEAK_BF16 * 1e3}


def bf16_kernel_phases(dev, card, cfg16, tuner16) -> dict:
    """Phase 29: kernel H at bf16 (forward, dx, dw/db) against its plain
    version at the fine-tune fold, on an odd plane and at a serving chunk,
    its passes' wgmma in the SASS and their times; kernels B and C with
    the bf16 trunk against their plain versions at 1,032,192 voxels, MVG
    and diagonal heads; their device times beside the plain versions',
    cuDNN's bf16 conv and their bounds. Returns errors, times, bounds."""
    from qbold_vi_tpu_torch.models.vi import FineTuner, init_params
    from qbold_vi_tpu_torch.models.encoder import _full_fp32
    from qbold_vi_tpu_torch.ops import conv3x3 as cv
    from qbold_vi_tpu_torch.ops import fused_infer as fi
    from qbold_vi_tpu_torch.ops.quadrature import (quad_posterior_summaries,
                                                   quad_tile_summaries)

    rng = np.random.default_rng(29)
    out = {}
    bf16 = torch.bfloat16
    with torch.no_grad(), _full_fp32():
        for shape in H16_SHAPES:
            n, h, w, ci, co = shape
            x = torch.from_numpy(rng.normal(size=(n, h, w, ci)).astype(
                np.float32)).to(dev, bf16)
            wt = torch.from_numpy((rng.normal(size=(3, 3, ci, co)) * 0.1
                                   ).astype(np.float32)).to(dev, bf16)
            b = torch.from_numpy((rng.normal(size=co) * 0.1).astype(
                np.float32)).to(dev, bf16)
            ct = torch.from_numpy(rng.normal(size=(n, h, w, co)).astype(
                np.float32)).to(dev, bf16)
            got = (cv.conv3x3_forward(x, wt, b),) + cv.conv3x3_backward(
                x, wt, ct)
            again = cv.conv3x3_backward(x, wt, ct)
            torch.cuda.synchronize()
            if not (torch.equal(got[2], again[1])
                    and torch.equal(got[3], again[2])):
                raise AssertionError(f"H bf16 {shape}: dw/db differ between "
                                     "two calls of the backward")
            plain = (cv.conv3x3_plain(x, wt, b),) + cv.conv3x3_grads_plain(
                x, wt, ct)
            errs = {key: ulp_err(f"H bf16 {shape} {key}", g, r, H16_ULPS)
                    for key, g, r in zip(("y", "dx", "dw", "db"), got, plain)}
            log(f"kernel H bf16 vs plain ok at {shape}: " + ", ".join(
                f"{k} {e:.2f} ulps ({100 * s:.3f}% of elements moved by a "
                "rounding)" for k, (e, s) in errs.items()))
            if shape == H16_SHAPES[0]:
                out["H_err"] = {
                    "fwd": errs["y"][0] * bf16_ulp(plain[0]),
                    "bwd": max(errs[k][0] * bf16_ulp(r) for k, r in
                               zip(("dx", "dw", "db"), plain[1:]))}
            if shape not in H16_TIMED:
                continue
            w_oihw = wt.permute(3, 2, 0, 1).contiguous()
            parts = {
                "fwd": kernel_ms_parts(lambda: cv.conv3x3_forward(x, wt, b),
                                       H16_SYMBOLS["fwd"]),
                "bwd": kernel_ms_parts(lambda: cv.conv3x3_backward(x, wt, ct),
                                       H16_SYMBOLS["bwd"])}
            lib_calls = {"fwd": lambda: cudnn_conv(x, w_oihw, b),
                         "bwd": lambda: cudnn_conv_backward(x, w_oihw, ct),
                         "dx": lambda: cudnn_conv_backward(
                             x, w_oihw, ct, (True, False, False)),
                         "dw": lambda: cudnn_conv_backward(
                             x, w_oihw, ct, (False, True, True))}
            lib_dev = {k: device_ms(f) for k, f in lib_calls.items()}
            # the library's time as float32 H's: a call by CUDA events
            times = {
                "fwd": (sum(parts["fwd"].values()),
                        cuda_ms(lambda: cv.conv3x3_plain(x, wt, b), reps=2),
                        cuda_ms(lib_calls["fwd"])),
                "bwd": (sum(parts["bwd"].values()),
                        cuda_ms(lambda: cv.conv3x3_grads_plain(x, wt, ct),
                                reps=2),
                        cuda_ms(lib_calls["bwd"]))}
            if shape == H16_SHAPES[0]:
                out["H_times"] = times
            for way, (ms, plain_ms, lib_ms) in times.items():
                bd = conv_bound_bf16(shape, way == "bwd")
                log(f"H bf16 {way} at {shape}: kernel {ms:.4f} ms on the "
                    f"device; plain {plain_ms:.4f} ms a call; cuDNN bf16 "
                    f"{lib_ms:.4f} ms a call, {lib_dev[way]:.4f} ms on the "
                    f"device; bound {bd['bound_ms']:.4f} ms "
                    f"({bd['bound_by']}, {100 * bd['bound_ms'] / ms:.1f}%) "
                    f"[{card}]")
            # pass by pass: the weight image, the convs (forward, dx) and
            # dw/db (its reduction with it), each beside its own bound and
            # the library's call for the same pass
            pass_ms = {"fwd": parts["fwd"][H16_SYMBOLS["fwd"][1]],
                       "dx": parts["bwd"][H16_SYMBOLS["bwd"][1]],
                       "dw": parts["bwd"][H16_SYMBOLS["bwd"][2]]
                       + parts["bwd"][H16_SYMBOLS["bwd"][3]]}
            pb = {k: conv_pass_bound_bf16(shape, k) for k in pass_ms}
            log(f"H bf16 passes at {shape} (device ms): weight image "
                f"{parts['fwd'][H16_SYMBOLS['fwd'][0]]:.4f}; " + "; ".join(
                    f"{k} {v:.4f} (bound {pb[k]['bound_ms']:.4f} by "
                    f"{pb[k]['bound_by']}, cuDNN bf16 {lib_dev[k]:.4f})"
                    for k, v in pass_ms.items())
                + f" (dw {parts['bwd'][H16_SYMBOLS['bwd'][2]]:.4f} + reduce "
                f"{parts['bwd'][H16_SYMBOLS['bwd'][3]]:.4f}) [{card}]")
        check_wgmma_sass()

        # ---- B and C with the bf16 trunk, MVG and diagonal heads ----------
        mcfg, scan = cfg16.model, cfg16.scan
        diag = dataclasses.replace(mcfg, use_mvg=False)
        diag_tuner = FineTuner(diag, scan, device=dev)
        diag_tuner.load_state_dict(init_params(
            diag, scan, torch.Generator().manual_seed(1)))
        ranges = dict(oef_range=mcfg.oef_range, min_oef=mcfg.min_oef,
                      dbv_range=mcfg.dbv_range, min_dbv=mcfg.min_dbv,
                      dw_coeff=float(scan.dw_coeff * scan.hct))
        x = torch.from_numpy(volumes(rng, (N_FULL,), scan.n_taus)).to(dev)
        enc = dict(se_idx=scan.se_idx,
                   multi_image=mcfg.multi_image_normalisation,
                   activation=mcfg.activation,
                   n_blocks=mcfg.no_intermediate_layers, trunk="bfloat16",
                   mask_channel=True, input_layout="voxel")
        for tag, t, mvg in (("MVG", tuner16, True), ("diag", diag_tuner,
                                                     False)):
            q = fi.encode_q1_packed(x, t.encoder, **enc)
            got = fi.encode_quad_fused(x, t.encoder, mvg=mvg, **enc,
                                       **ranges)
            q_ref = fi.encode_q_plain(x, t.encoder, **enc)
            ref = fi.encode_quad_fused_plain(x, t.encoder, mvg=mvg, **enc,
                                             **ranges)
            torch.cuda.synchronize()
            rows = 5 if mvg else 4
            q_errs = [ulp_err(f"C bf16 {tag} q row {j}", q[j], q_ref[j],
                              Q16_ULPS, moved=1e-6) for j in range(rows)]
            if not mvg and bool((q[4] != 0).any()):
                raise AssertionError("C bf16 diag: row 4 of q is not 0")
            tail = [torch.stack(v) for v in quad_tile_summaries(
                q[0], q[1], q[2], q[3], q[4], mvg=mvg, **ranges)]
            e_tail = max(check_close(f"B bf16 {tag} vs C's q", got[0].T,
                                     tail[0].T, "mean"),
                         check_close(f"B bf16 {tag} vs C's q", got[1].T,
                                     tail[1].T, "var", tail[0].T),
                         check_close(f"B bf16 {tag} vs C's q", got[2].T,
                                     tail[2].T, "raw"))
            b_errs = {}
            for name, g, r in (("means", got[0], ref[0]),
                               ("raw", got[2], ref[2])):
                check_rows(f"B bf16 {tag} {name} vs plain", g, r,
                           *BF16_GATE[True])
                b_errs[name] = (float((g - r).abs().max()) / bf16_ulp(r),
                                float(((g - r).abs() > 1e-5 * r.abs().max())
                                      .double().mean()))
            log(f"kernels B and C bf16 vs plain ok at N={N_FULL} ({tag}): C's "
                "q rows " + ", ".join(f"{e:.2f} ulps ({100 * s:.3f}% moved)"
                                      for e, s in q_errs)
                + f"; B against the quadrature of C's q {e_tail:.3e}, against "
                "its plain version " + ", ".join(
                    f"{k} {e:.2f} ulps ({100 * s:.3f}% moved)"
                    for k, (e, s) in b_errs.items()))
            if mvg:
                out["head_err"] = head_f64_err(q, x, t.encoder, enc)
                log("C bf16 head against a float64 head on the plain "
                    "version's bf16 features: kernel " + ", ".join(
                        f"{k} {v:.3e}" for k, v in out["head_err"][0].items())
                    + "; the plain float32 head " + ", ".join(
                        f"{k} {v:.3e}" for k, v in out["head_err"][1].items()))
                out["q_rows"] = q.T.contiguous()
                out["C_err"] = max(float((q[j] - q_ref[j]).abs().max())
                                   for j in range(rows))
                out["B_err"] = max(float((g - r).abs().max())
                                   for g, r in zip(got, ref))
                out["raw_b"] = got[2]
        kw = dict(enc, **ranges)
        out["BC_times"] = {
            "B": time_kernel(lambda: fi.encode_quad_fused(
                x, tuner16.encoder, mvg=True, **kw), BC16_SYMBOLS["B"],
                lambda: fi.encode_quad_fused_plain(x, tuner16.encoder,
                                                   mvg=True, **kw)),
            "C": time_kernel(lambda: fi.encode_q1_packed(
                x, tuner16.encoder, **enc), BC16_SYMBOLS["C"],
                lambda: fi.encode_q_plain(x, tuner16.encoder, **enc))}
        # A on C's q: B beside C + A on the same request
        a_rows = out.pop("q_rows")
        out["A_on_C_ms"] = kernel_ms(lambda: quad_posterior_summaries(
            a_rows, mvg=True, **ranges), "qv_quad_kernel")
    u, nb, t_n = mcfg.no_units, mcfg.no_intermediate_layers, scan.n_taus
    rest = N_FULL * (ops_encode(u, t_n, nb) - 2 * (u * t_n + nb * u * u
                                                   + 5 * u))
    out["BC_bounds"] = {
        "B": encode_bound_bf16(N_FULL, u, t_n, nb, N_FULL * 4 * (t_n + 1 + 9),
                               rest + ops_quad(out["raw_b"], True)),
        "C": encode_bound_bf16(N_FULL, u, t_n, nb, N_FULL * 4 * (t_n + 1 + 5),
                               rest)}
    out["BC_bounds"]["B"]["mufu_bound_ms"] = mufu_bound(
        mufu_quad(out["raw_b"], True), mufu_clock_hz())
    for k, (ms, call, plain) in out["BC_times"].items():
        bd = out["BC_bounds"][k]
        log(f"{k} bf16: kernel {ms:.4f} ms on the device ({call:.4f} ms a call"
            f" by CUDA events), plain {plain:.4f} ms; bound "
            f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} "
            f"({100 * bd['bound_ms'] / ms:.1f}%), the trunk's products "
            f"{bd['trunk_products_ms']:.4f} ms" + (
                f", special-function {bd['mufu_bound_ms']:.4f} ms"
                if "mufu_bound_ms" in bd else "") + f" at N={N_FULL} [{card}]")
    del out["raw_b"]
    b_ms, c_ms, a_ms = (out["BC_times"]["B"][0], out["BC_times"]["C"][0],
                        out["A_on_C_ms"])
    log(f"B bf16 {b_ms:.4f} ms against C bf16 + A on C's q {c_ms:.4f} + "
        f"{a_ms:.4f} = {c_ms + a_ms:.4f} ms on the same request "
        f"({'not more' if b_ms <= c_ms + a_ms else 'MORE'}) [{card}]")
    return out


def head_f64_err(q, x, encoder, enc) -> tuple:
    """The bf16 head's error: |q - the head in float64 on the plain
    version's bf16 features| (median, 99.9th percentile, largest; where a
    feature's rounding moved between kernel and plain version, its voxel
    differs by more), and the same for the plain version's float32 head."""
    from qbold_vi_tpu_torch.models.encoder import activation_fn, normalise_data
    from qbold_vi_tpu_torch.ops.fused_infer import (_mm_bf16, _rows,
                                                    _stream1_weights)

    bf16 = torch.bfloat16
    xr, cm = _rows(x, enc["input_layout"])
    xr = (xr if cm else xr.T).float()
    if enc["mask_channel"]:
        xr = xr[:-1] * xr[-1:]
    wfc, bfc, wb, bb, wf, bf = _stream1_weights(encoder, enc["n_blocks"])
    act = activation_fn(enc["activation"], bf16)
    h = normalise_data(xr.T, enc["se_idx"], enc["multi_image"]).T
    h = act(_mm_bf16(wfc.to(bf16), h.to(bf16)) + bfc.to(bf16))
    for i in range(enc["n_blocks"]):
        h = act(_mm_bf16(wb[i].to(bf16), h) + bb[i].to(bf16))
    q64 = wf.double() @ h.double() + bf.double()
    plain = wf.float() @ h.float() + bf.float()

    def stats(got):
        d = (got.double() - q64).abs().flatten()
        k = max(int(0.999 * d.numel()) - 1, 0)
        return {"median": float(d.median()),
                "p99.9": float(d.kthvalue(k + 1).values),
                "max": float(d.max())}

    return stats(q), stats(plain)


def bf16_phases(dev, card, base, tuner) -> dict:
    """Phases 29-33: OPTIMAL at compute_dtype="bfloat16", full width, from
    the weights of ``tuner`` (phase 29, bf16_kernel_phases); serving
    (phase 30: stream 1 by quadrature through B and by mc through C + D,
    stream 2 under "auto" (cuDNN) and "on" (H), each against the float32
    maps of the same weights); fine-tuning (phase 31: Trainer.finetune
    1 x 100 steps through H, 10 through cuDNN, one step on the card against
    the CPU and one through H against cuDNN); pretraining (phase 32: one
    streaming epoch); timings (phase 33). Returns the four kernels' JSON
    entries and the walls."""
    from qbold_vi_tpu_torch import infer
    from qbold_vi_tpu_torch.models.vi import FineTuner, init_params
    from qbold_vi_tpu_torch.ops import conv3x3 as cv
    from qbold_vi_tpu_torch.ops import fused_elbo as fe
    from qbold_vi_tpu_torch.ops import fused_infer as fi
    from qbold_vi_tpu_torch.ops import summarize as sm
    from qbold_vi_tpu_torch.ops import synth_batch as sb
    from qbold_vi_tpu_torch.train import data as data_pipe
    from qbold_vi_tpu_torch.train import optim, steps
    from qbold_vi_tpu_torch.train.trainer import (Trainer,
                                                  stream_steps_per_epoch)

    cfg16 = dataclasses.replace(base, model=dataclasses.replace(
        base.model, compute_dtype="bfloat16"))
    on16 = dataclasses.replace(cfg16, model=dataclasses.replace(
        cfg16.model, fused_conv="on"))
    scan, mcfg = base.scan, cfg16.model
    n_conv = 2 * mcfg.no_intermediate_layers
    weights = {k: v.clone() for k, v in tuner.state_dict().items()}

    def tuner_of(cfg):
        t = FineTuner(cfg.model, scan, device=dev)
        t.load_state_dict(weights)
        return t

    t16, t16_on = tuner_of(cfg16), tuner_of(on16)
    if t16.encoder.dtype != torch.bfloat16:
        raise AssertionError("compute_dtype='bfloat16' did not give a bf16 "
                             "trunk")
    kern = bf16_kernel_phases(dev, card, cfg16, t16)

    # ---- 30. serving at bf16 -----------------------------------------------
    data = volumes(np.random.default_rng(30), REQUESTS[0], scan.n_taus)
    chunks = -(-REQUESTS[0][0] // 2)
    routes = (("stream 1, quadrature", t16, True, "quadrature"),
              ("stream 1, mc", t16, True, "mc"),
              ("stream 2, auto (cuDNN)", t16, False, "quadrature"),
              ("stream 2, on (H)", t16_on, False, "quadrature"))
    counters = {"B": (fi.encode_quad_fused, "bf16_launches"),
                "C": (fi.encode_q1_packed, "bf16_launches"),
                "D": (sm.mc_posterior_summaries_packed, "launches"),
                "H_fwd": (cv.conv3x3, "fwd_bf16_launches"),
                "H_bwd": (cv.conv3x3, "bwd_bf16_launches")}
    expect = {"stream 1, quadrature": dict(B=chunks),
              "stream 1, mc": dict(C=chunks, D=chunks),
              "stream 2, auto (cuDNN)": {},
              "stream 2, on (H)": dict(H_fwd=n_conv * chunks)}
    serve_launches, walls = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (tag, t, first, method) in enumerate(routes):
            for fn, attr in counters.values():
                setattr(fn, attr, 0)
            prefix = f"{tmp}/bf16_{i}"
            maps = infer.save_predictions(t, cfg16, data, prefix,
                                          use_first_op=first, method=method)
            torch.cuda.synchronize()
            got = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
            want = {k: expect[tag].get(k, 0) for k in counters}
            if got != want:
                raise AssertionError(f"bf16 serving {tag}: launches {got}, "
                                     f"expected {want}")
            serve_launches[tag] = got
            check_maps(maps, data.shape[:-1], prefix)
            ref = infer.posterior_maps(tuner, data, use_first_op=first,
                                       method=method)
            gaps = {}
            for key in ("oef", "dbv", "r2p", "stds", "raw_log_stds"):
                # the variance maps in their square roots: the posterior
                # standard deviations, in the heads' units
                g, r = (torch.from_numpy(m[key]).double() for m in (maps, ref))
                if key == "stds":
                    g, r = g.sqrt(), r.sqrt()
                gaps[key] = check_rows(f"bf16 serving {tag} {key} vs float32",
                                       g, r, *BF16_GATE[first])
            rtol, atol = BF16_GATE[first]
            log(f"bf16 serving {tag}: maps finite, in range, read back; "
                f"launches {got}; against the float32 maps of the same "
                f"weights (rtol {rtol} / atol {atol}): " + ", ".join(
                    f"{k} {v:.3e}" for k, v in gaps.items()))
    for tag, t, first, method in routes:
        walls[tag] = wall_ms(lambda: infer.posterior_maps(
            t, data, use_first_op=first, method=method))
        log(f"posterior_maps wall at bf16, {tag}: {walls[tag]:.3f} ms on "
            f"{REQUESTS[0]} [{card}]")
    profile(lambda: infer.posterior_maps(t16_on, data, use_first_op=False),
            2, "posterior_maps at bf16, stream 2, fused_conv on", card)

    # ---- 31. fine-tuning at bf16 -------------------------------------------
    logged = []

    def logger(phase, epoch, m):
        logged.append(dict(m))
        log(f"[{phase}, bf16] epoch {epoch}: " + " ".join(
            f"{k}={v:.6g}" for k, v in m.items()) + f" [{card}]")

    vols = volumes(np.random.default_rng(0), TRAIN_VOLUMES, scan.n_taus)
    on_run = dataclasses.replace(on16, train=dataclasses.replace(
        on16.train, no_ft_epochs=1))
    trainer = Trainer(fresh_save(on_run), state_dict=weights, device=dev,
                      logger=logger)
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    cv.conv3x3.fwd_launches = cv.conv3x3.bwd_launches = 0
    fe.fused_elbo_forward.launches = fe.fused_elbo_backward.launches = 0
    trainer.finetune(vols, epochs=1)
    torch.cuda.synchronize()
    n_steps = on_run.train.ft_steps_per_epoch
    prior_fwd = n_conv * -(-data_pipe.blank_crop(vols).shape[0] // 4)
    ft_launches = {"H_fwd": cv.conv3x3.fwd_bf16_launches,
                   "H_bwd": cv.conv3x3.bwd_bf16_launches,
                   "H_fwd_float32": cv.conv3x3.fwd_launches,
                   "F_fwd": fe.fused_elbo_forward.launches,
                   "F_bwd": fe.fused_elbo_backward.launches}
    log(f"bf16 fine-tune (1 epoch x {n_steps} steps, fused_conv on) "
        f"launches: {ft_launches}; expected H bf16 {n_conv * n_steps} + "
        f"{prior_fwd} (prepare_real) forward, {n_conv * n_steps} backward")
    if ft_launches != {"H_fwd": n_conv * n_steps + prior_fwd,
                       "H_bwd": n_conv * n_steps, "H_fwd_float32": 0,
                       "F_fwd": n_steps, "F_bwd": n_steps}:
        raise AssertionError(f"H bf16 or F did not run as counted: "
                             f"{ft_launches}")
    if not all(np.isfinite(v) for m in logged for v in m.values()):
        raise AssertionError(f"bf16 fine-tune metrics: {logged}")
    if any(p.dtype != torch.float32 for p in trainer.tuner.parameters()):
        raise AssertionError("a bf16 fine-tune left a parameter not float32")
    epoch_on_ms = logged[-1]["epoch_time_s"] * 1e3
    auto_run = dataclasses.replace(cfg16, train=dataclasses.replace(
        cfg16.train, no_ft_epochs=1, ft_steps_per_epoch=10))
    trainer = Trainer(fresh_save(auto_run),
                      state_dict=trainer.tuner.state_dict(),
                      device=dev, logger=logger)
    cv.conv3x3.fwd_bf16_launches = cv.conv3x3.bwd_bf16_launches = 0
    fe.fused_elbo_forward.launches = fe.fused_elbo_backward.launches = 0
    trainer.finetune(vols, epochs=1)
    torch.cuda.synchronize()
    if (cv.conv3x3.fwd_bf16_launches, cv.conv3x3.bwd_bf16_launches,
            fe.fused_elbo_forward.launches,
            fe.fused_elbo_backward.launches) != (0, 0, 10, 10):
        raise AssertionError("the bf16 cuDNN epoch launched H or missed F")
    if not all(np.isfinite(v) for m in logged for v in m.values()):
        raise AssertionError(f"bf16 fine-tune metrics: {logged}")
    log("bf16 fine-tune (1 epoch x 10 steps, fused_conv auto: cuDNN bf16): "
        "F launched 10 times each way, H none; metrics finite")

    # one bf16 step on the card against the CPU, and through H against cuDNN
    vol = torch.from_numpy(trainer.sampler.data).to(dev)
    pri = torch.from_numpy(trainer.sampler.priors).to(dev)
    batch = steps.sample_crop_batch(torch.Generator().manual_seed(7), vol,
                                    pri, 4, cfg16.train.crop_size)
    rng = np.random.default_rng(31)
    shape = tuple(batch["images"].shape[:-1])
    noise = {"z_nll": rng.normal(size=(1,) + shape + (2,)).astype(np.float32),
             "z_kl": rng.normal(size=(70,) + shape + (2,)).astype(np.float32)}
    init = init_params(mcfg, scan, torch.Generator().manual_seed(3))
    cpu = torch.device("cpu")
    for label, runs in (
            ("on the card vs the CPU", ((smooth(cfg16), dev),
                                         (smooth(cfg16), cpu))),
            ("through H vs cuDNN", ((smooth(on16), dev),
                                     (smooth(cfg16), dev)))):
        result = []
        for c, device in runs:
            t = FineTuner(c.model, scan, device=device)
            t.load_state_dict(init)
            opt = optim.make_finetune_optimizer(t.parameters(), c.train)
            result.append(stepped(t, steps.make_finetune_step(t, c, opt)(
                {k: v.to(device) for k, v in batch.items()}, noise=noise)))
        worst = check_step(f"one bf16 fine-tune step (softplus) {label}",
                           *result, init, float(cfg16.train.ft_lr),
                           tol=BF16_STEP_TOL)
        log(f"one bf16 fine-tune step (softplus, initial weights) {label}: "
            f"loss {result[0][0]:.7g} vs {result[1][0]:.7g}, gradients "
            f"within {worst:.2e} of their scale (gate 1e-2), updates within "
            "tolerance")

    # ---- 32. pretraining at bf16: one streaming epoch ---------------------
    pt_cfg = dataclasses.replace(cfg16, train=dataclasses.replace(
        cfg16.train, pt_on_device_synth=True, no_pt_epochs=1))
    pt_logged = []
    pt_trainer = Trainer(fresh_save(pt_cfg), device=dev,
                         logger=lambda phase, e, m:
                         pt_logged.append(dict(m)))
    sb.synth_batch.launches = sb.synth_batch.noise_launches = 0
    t0 = time.perf_counter()
    pt_trainer.pretrain()
    torch.cuda.synchronize()
    pt_wall = time.perf_counter() - t0
    spe = stream_steps_per_epoch(pt_cfg)
    if (sb.synth_batch.launches, sb.synth_batch.noise_launches) != (spe, spe):
        raise AssertionError("the bf16 streaming epoch did not draw its "
                             "batches through S")
    if not pt_logged or not all(np.isfinite(v) for m in pt_logged
                                for v in m.values()):
        raise AssertionError(f"bf16 pretrain metrics: {pt_logged}")
    log(f"bf16 streaming pretrain: 1 epoch x {spe} steps, S launched {spe} + "
        f"{spe}; " + " ".join(f"{k}={v:.6g}" for k, v in pt_logged[-1].items())
        + f"; whole call {pt_wall:.2f} s [{card}]")

    # ---- 33. timings -------------------------------------------------------
    log_clocks("before the bf16 timings")
    step_ms, step_prof = {}, {}
    for name, c in (("on (H)", on16), ("auto (cuDNN)", cfg16)):
        t = tuner_of(c)
        opt = optim.make_finetune_optimizer(t.parameters(), c.train)
        fn = steps.make_finetune_step(t, c, opt)
        full = steps.sample_crop_batch(torch.Generator().manual_seed(8), vol,
                                       pri, c.train.ft_batch_size,
                                       c.train.crop_size)
        step_ms[name] = wall_ms(lambda: fn(full, seed=13))
        step_prof[name] = profile(lambda: fn(full, seed=13), 5,
                                  f"bf16 fine-tune step, fused_conv {name}",
                                  card)
        log(f"bf16 fine-tune step wall, fused_conv {name}: "
            f"{step_ms[name]:.3f} ms at batch {c.train.ft_batch_size} "
            f"[{card}]")
    log(f"bf16 fine-tune epoch wall, fused_conv on: {epoch_on_ms:.1f} ms "
        f"({n_steps} steps) [{card}]")
    log_clocks("after the bf16 timings")

    fold = H16_SHAPES[0]
    kernels = [
        {"name": "B-bf16", "route": "cuda",
         "source": "qbold_vi_tpu_torch/csrc/encode_quad_bf16.cu",
         "replaces": "qbold_vi_tpu/ops/pallas_infer.py:353",
         "launches": serve_launches["stream 1, quadrature"]["B"],
         "max_abs_err": kern["B_err"], "ms": kern["BC_times"]["B"][0],
         "plain_ms": kern["BC_times"]["B"][2],
         **{k: kern["BC_bounds"]["B"][k] for k in ("bound_ms", "bound_by")},
         "library_ms": None},
        {"name": "C-bf16", "route": "cuda",
         "source": "qbold_vi_tpu_torch/csrc/encode_quad_bf16.cu",
         "replaces": "qbold_vi_tpu/ops/pallas_infer.py:246",
         "launches": serve_launches["stream 1, mc"]["C"],
         "max_abs_err": kern["C_err"], "ms": kern["BC_times"]["C"][0],
         "plain_ms": kern["BC_times"]["C"][2],
         **{k: kern["BC_bounds"]["C"][k] for k in ("bound_ms", "bound_by")},
         "library_ms": None}]
    for way, line in (("fwd", 188), ("bwd", 239)):
        ms, plain_ms, lib_ms = kern["H_times"][way]
        kernels.append({
            "name": f"H-bf16-{way}", "route": "cuda",
            "source": "qbold_vi_tpu_torch/csrc/conv3x3.cu",
            "replaces": f"qbold_vi_tpu/ops/pallas_conv.py:{line}",
            "launches": ft_launches[f"H_{way}"]
            + serve_launches["stream 2, on (H)"][f"H_{way}"],
            "max_abs_err": kern["H_err"][way], "ms": ms,
            "plain_ms": plain_ms, **conv_bound_bf16(fold, way == "bwd"),
            "library_ms": lib_ms})
    return {"kernels": kernels, "serving_wall_ms": walls,
            "finetune_step_ms": step_ms,
            "finetune_step_busy_share": {
                k: p["busy_ms"] / p["wall_ms"] for k, p in step_prof.items()},
            "finetune_step_launches": {k: p["launches"]
                                       for k, p in step_prof.items()},
            "finetune_epoch_on_ms": epoch_on_ms,
            "pretrain_epoch_s": pt_logged[-1].get("epoch_time_s")}


# ---- the CLI, checkpoints and resume (phases 34-36) -------------------------

CLI_SUBJECTS = 6                     # ASE_scan: make_subjects' 64 x 64 x 8
SERVE_REQUEST = (14, 96, 96, 8)      # infer / serve: one 1.03 M-voxel stack
_SAVE_ROOT: list = []                # the run's checkpoint directories


def fresh_save(cfg):
    """``cfg`` with a save_directory of its own (removed at exit): a
    Trainer writes its checkpoints there and resumes what it finds, so no
    two Trainers of this run share one."""
    import atexit

    if not _SAVE_ROOT:
        _SAVE_ROOT.append(tempfile.mkdtemp(prefix="qbold_smoke_"))
        atexit.register(shutil.rmtree, _SAVE_ROOT[0], True)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, save_directory=tempfile.mkdtemp(dir=_SAVE_ROOT[0])))


def load_tool(name: str):
    """A module of tools/ (not a package) by its path beside this file."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_real_directory(d: str, scan) -> np.ndarray:
    """load_real_directory's layout in ``d``: ASE_scan.npy (CLI_SUBJECTS
    synthetic brains of tools/validate_finetune_torch.py::make_subjects,
    a brain-mask channel) and hyperv_ase.npy / baseline_ase.npy (one
    brain each from another seed, with a grey-matter mask -- the inner
    ellipse -- and the brain mask). Returns ASE_scan."""
    vt = load_tool("validate_finetune_torch")
    data, _, _, _ = vt.make_subjects(scan, n=CLI_SUBJECTS)
    np.save(os.path.join(d, "ASE_scan.npy"), data)
    study, _, _, brain = vt.make_subjects(scan, n=2, seed=1)
    xx, yy = np.meshgrid(np.linspace(-1, 1, study.shape[1]),
                         np.linspace(-1, 1, study.shape[2]), indexing="ij")
    gm = (brain * ((xx ** 2 + yy ** 2) < 0.5)[None, :, :, None]
          ).astype(np.float32)
    for i, name in enumerate(("hyperv_ase", "baseline_ase")):
        np.save(os.path.join(d, name + ".npy"), np.concatenate(
            [study[i:i + 1, ..., :-1], gm[i:i + 1, ..., None],
             study[i:i + 1, ..., -1:]], -1))
    return data


def run_cli(argv: list, stdin: str = "") -> tuple:
    """(exit code, stdout lines) of cli.main(argv) with ``stdin`` as its
    standard input; its output is kept from this script's own."""
    import contextlib
    import io

    from qbold_vi_tpu_torch import cli

    out, old_stdin = io.StringIO(), sys.stdin
    sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
    finally:
        sys.stdin = old_stdin
    return rc, out.getvalue().splitlines()


def cli_counters() -> dict:
    from qbold_vi_tpu_torch.ops import fused_elbo as fe
    from qbold_vi_tpu_torch.ops import fused_infer as fi
    from qbold_vi_tpu_torch.ops import quadrature as quad
    from qbold_vi_tpu_torch.ops import summarize as sm
    from qbold_vi_tpu_torch.ops import synth_batch as sb

    return {"S": sb.synth_batch, "B": fi.encode_quad_fused,
            "C": fi.encode_q1_packed, "D": sm.mc_posterior_summaries,
            "D_packed": sm.mc_posterior_summaries_packed,
            "E": sm.mc_kl_map, "A": quad.quad_posterior_summaries,
            "F_fwd": fe.fused_elbo_forward, "F_bwd": fe.fused_elbo_backward}


def reset_counts() -> None:
    for fn in cli_counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in cli_counters().items()}


def clone_state(state):
    """A TrainState's tensors copied to the CPU."""
    from qbold_vi_tpu_torch.train import checkpoint as ck
    from qbold_vi_tpu_torch.train.optim import SWAState

    c = lambda d: {k: v.detach().cpu().clone()  # noqa: E731
                   for k, v in d.items()}
    o = state.opt_state
    swa = None if state.swa is None else SWAState(
        state.swa.step, state.swa.n_avg, c(state.swa.average))
    return ck.TrainState(c(state.params),
                         ck.OptState(o.count, c(o.mu), c(o.nu), o.tail),
                         swa, state.step)


def assert_state_equal(tag: str, got, want) -> None:
    """Bit for bit: params, mu, nu, count, SWA and step."""
    pairs = [("params", got.params, want.params),
             ("mu", got.opt_state.mu, want.opt_state.mu),
             ("nu", got.opt_state.nu, want.opt_state.nu)]
    if (got.swa is None) != (want.swa is None):
        raise AssertionError(f"{tag}: SWA state restored as {got.swa!r}")
    if want.swa is not None:
        pairs.append(("swa", got.swa.average, want.swa.average))
        if got.swa[:2] != want.swa[:2]:
            raise AssertionError(f"{tag}: SWA step / n_avg {got.swa[:2]} "
                                 f"!= {want.swa[:2]}")
    if (got.opt_state.count, got.step) != (want.opt_state.count, want.step):
        raise AssertionError(f"{tag}: count / step")
    for what, a, b in pairs:
        if set(a) != set(b) or not all(torch.equal(a[k].cpu(), b[k].cpu())
                                       for k in b):
            raise AssertionError(f"{tag}: {what} differs from what was saved")


def cli_phases(dev, card, base) -> dict:
    """Phases 34-36: ``python -m qbold_vi_tpu_torch train`` at OPTIMAL's
    width on a real-data directory (S, B, F, A and E launched); a
    .partial of each phase resumed bit for bit, and two runs resumed from
    one .partial ending equal; ``infer`` and ``serve`` from the trained
    checkpoint in fresh Trainers. Returns the walls and sizes."""
    from qbold_vi_tpu_torch import infer
    from qbold_vi_tpu_torch.io import nifti
    from qbold_vi_tpu_torch.train import checkpoint as ck
    from qbold_vi_tpu_torch.train import data as data_pipe
    from qbold_vi_tpu_torch.train import trainer as tr

    # ---- 34. train -----------------------------------------------------
    cfg = fresh_save(base)
    save = cfg.train.save_directory
    data_dir = tempfile.mkdtemp(dir=_SAVE_ROOT[0])
    ase = write_real_directory(data_dir, base.scan)
    trained = []

    class Recording(tr.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            trained.append(self)

    argv = ["train", "--preset", "optimal", "--set", f"save_directory={save}",
            "--set", f"d={data_dir}", "--set", "no_pt_epochs=2",
            "--set", "pt_on_device_synth=true", "--set", "no_ft_epochs=2",
            "--set", "checkpoint_every_epochs=1"]
    tr.Trainer, real_trainer = Recording, tr.Trainer
    reset_counts()
    try:
        t0 = time.perf_counter()
        rc, lines = run_cli(argv)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        tr.Trainer = real_trainer
    counts = read_counts()
    for ln in lines:
        log("  train: " + ln)
    files = sorted(os.listdir(save))
    log(f"cli train on {CLI_SUBJECTS} x 64 x 64 x 8 brains + 2 study "
        f"subjects: rc {rc}, {train_s:.2f} s (2 streaming pretrain epochs, "
        f"2 x {base.train.ft_steps_per_epoch} fine-tune steps, 4 exports); "
        f"launches {counts}; wrote {files} [{card}]")
    want = {"pt_model.msgpack", "final_model.msgpack"} | {
        f"{p}_{m}.nii.gz" for p in ("pt_baseline", "pt_hyperv", "baseline",
                                    "hyperv")
        for m in ("oef", "dbv", "r2p", "logstds", "raw_logstds")} | {
        f"{p}_{m}.nii.gz" for p in ("baseline", "hyperv")
        for m in ("likelihood", "kl", "residual")}
    if rc != 0 or not want <= set(files) or any(
            f.endswith(".partial") for f in files):
        raise AssertionError(f"cli train: rc {rc}, files {files}")
    for k in ("S", "B", "F_fwd", "F_bwd", "A", "E"):
        if counts[k] == 0:
            raise AssertionError(f"cli train never launched {k}: {counts}")
    oef = nifti.load_nifti(os.path.join(save, "baseline_oef.nii.gz"))
    if not (np.isfinite(oef).all() and 0.04 <= oef.min()
            and oef.max() <= 0.84):
        raise AssertionError("cli train: baseline OEF map out of range")
    (trainer,) = trained
    if trainer.status is not tr.WeightStatus.FULL_TRAINED:
        raise AssertionError("cli train left the Trainer unfinished")
    ckpt_bytes = os.path.getsize(trainer.final_path)
    write_ms = wall_ms(lambda: trainer._save(
        trainer.final_path + ".copy", "finetune", trainer.optimizer))
    read_ms = wall_ms(lambda: trainer._load_state(trainer.final_path,
                                                  "finetune"))
    with open(trainer.final_path, "rb") as f, \
            open(trainer.final_path + ".copy", "rb") as g:
        if f.read() != g.read():
            raise AssertionError("a rewrite of the live state differs from "
                                 "final_model.msgpack")
    os.remove(trainer.final_path + ".copy")
    log(f"checkpoint at OPTIMAL's width: final_model.msgpack "
        f"{ckpt_bytes:,} bytes, pt_model.msgpack "
        f"{os.path.getsize(trainer.pt_path):,} bytes; write (capture + "
        f"encode + write) {write_ms:.3f} ms, read (decode + bridge) "
        f"{read_ms:.3f} ms, median of 7 [{card}]")

    # ---- 35. resume on the card ------------------------------------------
    saved = {}
    real_save = tr._save_state

    def recording(path, state, cfg=None, steps_per_epoch=0):
        saved[os.path.basename(path)] = clone_state(state)
        return real_save(path, state, cfg=cfg,
                         steps_per_epoch=steps_per_epoch)

    class Crash(RuntimeError):
        pass

    def crash_at(phase, epoch):
        def logger(p, e, m):
            if (p, e) == (phase, epoch):
                raise Crash(f"{p} epoch {e}")
        return logger

    # SWA folds at the end of each streaming epoch: one goes into the
    # pretrain's .partial, one comes after its resume
    spe = tr.stream_steps_per_epoch(base)
    every = dataclasses.replace(base, train=dataclasses.replace(
        base.train, checkpoint_every_epochs=1, no_pt_epochs=2,
        pt_on_device_synth=True, no_ft_epochs=2, swa_start=spe,
        swa_period=spe))
    weights = {k: v.clone() for k, v in trainer.pretrained_params().items()}
    tr._save_state = recording
    try:
        # the pretrain's .partial (Adam's state and SWA's)
        pt_cfg = fresh_save(every)
        try:
            tr.Trainer(pt_cfg, device=dev,
                       logger=crash_at("pretrain", 1)).pretrain()
            raise AssertionError("the pretrain did not crash")
        except Crash:
            pass
        pt_partial = saved["pt_model.msgpack.partial"]
        t = tr.Trainer(pt_cfg, device=dev, logger=lambda *a: None)
        state, start = t._phase_start(t.pt_path, "pretrain", spe)
        assert_state_equal("pretrain .partial", state, pt_partial)
        if start != 1 or state.opt_state.count != spe or state.swa is None \
                or state.swa.n_avg != 1:
            raise AssertionError(f"pretrain .partial: start {start}, count "
                                 f"{state.opt_state.count}, SWA "
                                 f"{state.swa and state.swa[:2]}")
        # resumed on the card, the pretrain folds its weights into the
        # restored average at the end of epoch 1
        t0 = time.perf_counter()
        t.pretrain()
        torch.cuda.synchronize()
        pt_resume_s = time.perf_counter() - t0
        if (t.swa.step, t.swa.n_avg) != (2 * spe, 2):
            raise AssertionError(f"resumed pretrain: SWA step / n_avg "
                                 f"{t.swa[:2]}")
        for name, p in t.tuner.named_parameters():
            avg = t.swa.average[name]
            want = (pt_partial.swa.average[name].to(dev) * 1.0
                    + p.detach()) / p.new_tensor(2.0)
            if avg.device.type != "cuda" or not torch.equal(avg, want):
                raise AssertionError(f"resumed pretrain: SWA average of "
                                     f"{name} is not the fold of the saved "
                                     "one and the weights")
        written = t._load_state(t.pt_path, "pretrain").swa
        if written.n_avg != 2 or not all(
                torch.equal(v, t.swa.average[k].cpu())
                for k, v in written.average.items()):
            raise AssertionError("pt_model.msgpack's SWA state differs "
                                 "from the resumed Trainer's")
        # the fine-tune's
        ft_cfg = fresh_save(every)
        try:
            tr.Trainer(ft_cfg, state_dict=weights, device=dev,
                       logger=crash_at("finetune", 1)).finetune(ase)
            raise AssertionError("the fine-tune did not crash")
        except Crash:
            pass
        ft_partial = saved["final_model.msgpack.partial"]
    finally:
        tr._save_state = real_save
    partial = os.path.join(ft_cfg.train.save_directory,
                           "final_model.msgpack.partial")
    t = tr.Trainer(ft_cfg, state_dict=weights, resume_partial=True,
                   device=dev, logger=lambda *a: None)
    t.finetune(ase, epochs=0)                  # restores, runs no epoch
    names = [n for n, _ in t.tuner.named_parameters()]
    restored = ck.TrainState(
        t.tuner.state_dict(),
        ck.OptState(t.optimizer.count,
                    dict(zip(names, t.optimizer.mu)),
                    dict(zip(names, t.optimizer.nu)),
                    ft_partial.opt_state.tail), None, t.optimizer.count)
    assert_state_equal("fine-tune .partial", restored, ft_partial)
    if t.epochs_done != 1 or t.optimizer.count != \
            base.train.ft_steps_per_epoch:
        raise AssertionError(f"fine-tune .partial: epoch {t.epochs_done}, "
                             f"count {t.optimizer.count}")
    log(f"resume: the pretrain .partial (count {spe}, SWA n_avg "
        f"{pt_partial.swa.n_avg}) and the fine-tune .partial (count "
        f"{t.optimizer.count}) restore params, mu, nu, count, SWA and step "
        f"bit for bit, at epoch 1; the resumed pretrain's epoch "
        f"({pt_resume_s:.2f} s) folds its weights into the restored SWA "
        f"average on the card [{card}]")
    # two fresh Trainers resumed from the one .partial
    finals, walls = [], []
    for i in range(2):
        c = fresh_save(every)
        shutil.copy(partial, os.path.join(c.train.save_directory,
                                          "final_model.msgpack.partial"))
        logged = []
        r = tr.Trainer(c, state_dict=weights, resume_partial=True,
                       device=dev, logger=lambda p, e, m: logged.append(e))
        t0 = time.perf_counter()
        r.finetune(ase)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if logged != [1] or not os.path.isfile(r.final_path) or \
                os.path.exists(r.final_path + ".partial"):
            raise AssertionError(f"resumed run {i}: epochs {logged}")
        finals.append({k: v.clone() for k, v in r.tuner.state_dict().items()})
    diff = max(float((finals[0][k] - finals[1][k]).abs().max())
               for k in finals[0])
    log(f"two Trainers resumed from one .partial (epoch 1 of 2, "
        f"{walls[0]:.2f} s and {walls[1]:.2f} s): weights differ by at most "
        f"{diff:.3e} [{card}]")
    if diff != 0.0:
        raise AssertionError("two runs resumed from one .partial differ by "
                             f"{diff:.3e}")

    # ---- 36. infer and serve -------------------------------------------
    rng = np.random.default_rng(36)
    req = volumes(rng, SERVE_REQUEST, base.scan.n_taus)
    req_path = os.path.join(data_dir, "request.npy")
    np.save(req_path, req)
    out_cli = os.path.join(save, "infer")
    common = ["--preset", "optimal", "--set", f"save_directory={save}"]
    reset_counts()
    t0 = time.perf_counter()
    rc, lines = run_cli(["infer", req_path, "-o", out_cli, *common])
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t0
    infer_counts = read_counts()
    if rc != 0:
        raise AssertionError(f"cli infer: rc {rc}, {lines}")
    priors = data_pipe.predict_priors(trainer.pretrained_encode_fn(), req, 5)
    out_ref = os.path.join(save, "inproc")
    t0 = time.perf_counter()
    infer.save_predictions(trainer.tuner, trainer.cfg, req, out_ref, seed=7,
                           use_first_op=False, fine_tuned=True,
                           priors=priors)
    torch.cuda.synchronize()
    inproc_s = time.perf_counter() - t0
    for m in ("oef", "dbv", "r2p", "logstds", "raw_logstds", "likelihood",
              "kl", "residual"):
        got = nifti.load_nifti(f"{out_cli}_{m}.nii.gz")
        ref = nifti.load_nifti(f"{out_ref}_{m}.nii.gz")
        if not np.array_equal(got, ref):
            raise AssertionError(f"cli infer's {m} map differs from the "
                                 "training process's save_predictions")
    log(f"cli infer on {SERVE_REQUEST} from final_model.msgpack in a fresh "
        f"Trainer: {infer_s:.2f} s (restore included), launches "
        f"{infer_counts}; its 8 maps are bit-equal to save_predictions of "
        f"the Trainer that trained ({inproc_s:.2f} s) [{card}]")

    reqs = [{"data": req_path, "output": os.path.join(save, "serve_q")},
            {"data": req_path, "output": os.path.join(save, "serve_mc"),
             "method": "mc"},
            {"data": os.path.join(data_dir, "missing.npy"),
             "output": os.path.join(save, "serve_bad")}]
    reset_counts()
    rc, lines = run_cli(["serve", "--warm", "1", "96", "96", "8", *common],
                        "\n".join(json.dumps(r) for r in reqs) + "\n")
    serve_counts = read_counts()
    acks = [json.loads(ln) for ln in lines]
    if rc != 0 or len(acks) != 4 or not (
            acks[0].get("ready") and acks[0].get("fine_tuned")
            and acks[1]["ok"] and acks[2]["ok"] and not acks[3]["ok"]
            and "FileNotFoundError" in acks[3]["error"]):
        raise AssertionError(f"cli serve: rc {rc}, acks {acks}")
    for k in ("A", "E", "D"):
        if serve_counts[k] == 0:
            raise AssertionError(f"serve never launched {k}: {serve_counts}")
    pm = {method: wall_ms(lambda: infer.posterior_maps(
        trainer.tuner, req, seed=7, use_first_op=False, method=method),
        blocks=3) for method in ("quadrature", "mc")}
    log(f"cli serve --warm 1 96 96 8: acks {acks} (launches {serve_counts}); "
        f"wall_s {acks[1]['wall_s']} s (quadrature) and {acks[2]['wall_s']} "
        f"s (mc) for the whole fine-tuned export of {SERVE_REQUEST}, "
        f"against in-process posterior_maps {pm['quadrature']:.1f} ms and "
        f"{pm['mc']:.1f} ms of the same request [{card}]")
    # the export's parts, each once: the pt priors' encoder pass, the maps,
    # the likelihood / KL / residual maps, the eight NIfTI writes
    split = {}
    t0 = time.perf_counter()
    priors = data_pipe.predict_priors(trainer.pretrained_encode_fn(), req, 5)
    split["priors_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    maps = infer.posterior_maps(trainer.tuner, req, seed=7,
                                use_first_op=False)
    split["posterior_maps_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    maps.update(infer.elbo_maps(trainer.tuner, trainer.cfg, req, priors, 7))
    torch.cuda.synchronize()
    split["elbo_maps_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for key, suffix in (("oef", "_oef"), ("dbv", "_dbv"), ("r2p", "_r2p"),
                        ("stds", "_logstds"), ("raw_log_stds", "_raw_logstds"),
                        ("likelihood", "_likelihood"), ("kl", "_kl"),
                        ("residual", "_residual")):
        nifti.save_im_data(maps[key], os.path.join(save, "split") + suffix)
    split["nifti_s"] = time.perf_counter() - t0
    log("the fine-tuned export of " + str(SERVE_REQUEST) + " in parts: "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f" [{card}]")
    return {"train_s": train_s, "train_launches": counts,
            "checkpoint_bytes": ckpt_bytes, "checkpoint_write_ms": write_ms,
            "checkpoint_read_ms": read_ms, "resume_epoch_s": walls,
            "pt_resume_epoch_s": pt_resume_s,
            "infer_s": infer_s, "inproc_export_s": inproc_s,
            "serve_wall_s": {"quadrature": acks[1]["wall_s"],
                             "mc": acks[2]["wall_s"]},
            "posterior_maps_ms": pm, "export_split_s": split}


DROPOUT_RATE = 0.1
DROPOUT_STEPS = 10                   # a fine-tune epoch of each conv route
EXPORT_GEOMETRIES = ((14, 96, 96, 8), (3, 64, 64, 8))
TRANSFER_GRID = (-0.028, 0.004, 0.068)   # tau start, step, end: 24 taus


def map_rows(maps: dict) -> tuple:
    """(means (N, 3), variances (N, 3), raw (N, 2|3)) float64 tensors of a
    posterior map dict (numpy or tensors)."""
    def flat(key):
        v = maps[key]
        v = v.detach().cpu().numpy() if torch.is_tensor(v) else v
        return torch.from_numpy(np.asarray(v, np.float64).reshape(
            -1, v.shape[-1]))

    return (torch.cat([flat(k) for k in ("oef", "dbv", "r2p")], -1),
            flat("stds"), flat("raw_log_stds"))


def dropout_export_cli_phases(dev, card, base, tuner) -> dict:
    """Phases 37-39: dropout training (F, and H under "on"), the serving
    artifacts (the default .pt2 and the fused one through kernel B's op),
    and the CLI's synth, transfer -> infer and import-weights. Returns the
    walls, sizes and launches."""
    out = dropout_phase(dev, card, base, tuner)
    out["export"] = default_artifact_phase(dev, card, base, tuner)
    out["export"].update(fused_artifact_phase(dev, card, base, tuner))
    out["cli"] = cli13_phase(dev, card, base, tuner)
    return out


def dropout_phase(dev, card, base, tuner) -> dict:
    """Phase 37 (see the module docstring)."""
    from qbold_vi_tpu_torch import FineTuner, init_params
    from qbold_vi_tpu_torch.ops import conv3x3 as cv
    from qbold_vi_tpu_torch.ops import fused_elbo as fe
    from qbold_vi_tpu_torch.ops import synth_batch as sb
    from qbold_vi_tpu_torch.train import data as data_pipe
    from qbold_vi_tpu_torch.train import optim, steps
    from qbold_vi_tpu_torch.train.trainer import Trainer

    scan, mcfg = base.scan, base.model
    n_conv = 2 * mcfg.no_intermediate_layers
    weights = {k: v.detach().clone() for k, v in tuner.state_dict().items()}
    out = {}

    drop = dataclasses.replace(
        base, model=dataclasses.replace(mcfg, dropout_rate=DROPOUT_RATE),
        train=dataclasses.replace(base.train, no_ft_epochs=1,
                                  ft_steps_per_epoch=DROPOUT_STEPS))
    vols = volumes(np.random.default_rng(0), TRAIN_VOLUMES, scan.n_taus)
    prior_fwd = n_conv * -(-data_pipe.blank_crop(vols).shape[0] // 4)
    launches, epoch_s = {}, {}
    for conv in ("auto", "on"):
        c = dataclasses.replace(drop, model=dataclasses.replace(
            drop.model, fused_conv=conv))
        logged = []
        trainer = Trainer(fresh_save(c), state_dict=weights, device=dev,
                          logger=lambda ph, ep, m: logged.append(dict(m)))
        cv.conv3x3.fwd_launches = cv.conv3x3.bwd_launches = 0
        fe.fused_elbo_forward.launches = fe.fused_elbo_backward.launches = 0
        fe.fused_elbo_backward.from_state = 0
        trainer.finetune(vols, epochs=1)
        torch.cuda.synchronize()
        launches[conv] = {"H_fwd": cv.conv3x3.fwd_launches,
                          "H_bwd": cv.conv3x3.bwd_launches,
                          "F_fwd": fe.fused_elbo_forward.launches,
                          "F_bwd": fe.fused_elbo_backward.launches,
                          "F_bwd_from_state":
                              fe.fused_elbo_backward.from_state}
        if not all(np.isfinite(v) for m in logged for v in m.values()):
            raise AssertionError(f"dropout fine-tune metrics: {logged}")
        epoch_s[conv] = logged[-1]["epoch_time_s"]
    n = DROPOUT_STEPS
    want = {"auto": {"H_fwd": 0, "H_bwd": 0, "F_fwd": n, "F_bwd": n,
                     "F_bwd_from_state": n},
            "on": {"H_fwd": n_conv * n + prior_fwd, "H_bwd": n_conv * n,
                   "F_fwd": n, "F_bwd": n, "F_bwd_from_state": n}}
    log(f"dropout {DROPOUT_RATE} fine-tune, 1 x {n} steps a conv route "
        f"(masks from the step seeds' generators on the card): launches "
        f"{launches}; epochs {epoch_s} s [{card}]")
    if launches != want:
        raise AssertionError(f"the dropout steps missed F or H: {launches}, "
                             f"expected {want}")
    out["dropout_launches"] = launches

    # one step through H and F against cuDNN and the plain ELBO, given the
    # same masks (drawn on the card) and host normals; softplus, initial
    # weights (check_step)
    vol = torch.from_numpy(trainer.sampler.data).to(dev)
    pri = torch.from_numpy(trainer.sampler.priors).to(dev)
    batch = steps.sample_crop_batch(torch.Generator().manual_seed(9), vol,
                                    pri, base.train.ft_batch_size,
                                    base.train.crop_size)
    shape = tuple(batch["images"].shape[:-1])
    rng = np.random.default_rng(37)
    noise = {"z_nll": rng.normal(size=(1,) + shape + (2,)).astype(np.float32),
             "z_kl": rng.normal(size=(70,) + shape + (2,)).astype(np.float32)}
    gen = torch.Generator(device=dev).manual_seed(13)
    fold = (shape[0] * shape[3], shape[1], shape[2], mcfg.no_units)
    masks = [torch.rand(fold, generator=gen, device=dev) < 1 - DROPOUT_RATE
             for _ in range(n_conv)]
    init = init_params(mcfg, scan, torch.Generator().manual_seed(3))
    routes = {"on": dict(fused_conv="on", fused_elbo="on"),
              "off": dict(fused_conv="off", fused_elbo="off",
                          fused_decode_nll="off")}
    result, counted = [], {}
    for route, kw in routes.items():
        c = smooth(drop)
        c = dataclasses.replace(
            c, model=dataclasses.replace(c.model, fused_conv=kw["fused_conv"]),
            train=dataclasses.replace(c.train, **{k: v for k, v in kw.items()
                                                  if k != "fused_conv"}))
        t = FineTuner(c.model, scan, device=dev)
        t.load_state_dict(init)
        opt = optim.make_finetune_optimizer(t.parameters(), c.train)
        cv.conv3x3.bwd_launches = fe.fused_elbo_backward.from_state = 0
        result.append(stepped(t, steps.make_finetune_step(t, c, opt)(
            batch, noise=noise, dropout_masks=masks)))
        torch.cuda.synchronize()
        counted[route] = (cv.conv3x3.bwd_launches,
                          fe.fused_elbo_backward.from_state)
    if counted != {"on": (n_conv, 1), "off": (0, 0)}:
        raise AssertionError(f"the compared dropout steps: {counted}")
    worst = check_step("one dropout step (softplus) through H and F vs cuDNN "
                       "and the plain ELBO", *result, init,
                       float(base.train.ft_lr))
    log(f"one dropout step (softplus, initial weights, the same masks drawn "
        f"on the card) through H and F vs cuDNN and the plain ELBO: loss "
        f"{result[0][0]:.7g} vs {result[1][0]:.7g}, gradients within "
        f"{worst:.2e} of their scale (GRAD_TOL), updates within tolerance")
    out["dropout_step_vs_plain_grad_err"] = worst

    # train=False ignores the rate; the step walls with and without dropout
    t_drop = FineTuner(drop.model, scan, device=dev)
    t_drop.load_state_dict(weights)
    with torch.no_grad():
        for a, b in zip(t_drop.encode(batch["images"]),
                        tuner.encode(batch["images"])):
            if not torch.equal(a, b):
                raise AssertionError("a train=False pass saw the dropout rate")
    seeds = iter(range(1000, 2000))
    walls = {}
    for conv in ("auto", "on"):
        for rate in (DROPOUT_RATE, 0.0):
            c = dataclasses.replace(drop, model=dataclasses.replace(
                drop.model, fused_conv=conv, dropout_rate=rate))
            t = FineTuner(c.model, scan, device=dev)
            t.load_state_dict(weights)
            step = steps.make_finetune_step(
                t, c, optim.make_finetune_optimizer(t.parameters(), c.train))
            walls[f"{conv}_rate{rate}"] = wall_ms(
                lambda: step(batch, seed=next(seeds)))
    log("fine-tune step walls (OPTIMAL, batch 38, F; median of 7): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in walls.items())
        + f" [{card}]")
    out["dropout_step_ms"] = walls
    out["dropout_epoch_s"] = epoch_s

    # one streaming pretrain step at the rate: S launched, the loss that of
    # rate 0 (dropout never reaches stream 1)
    losses_ = []
    for rate in (DROPOUT_RATE, 0.0):
        c = dataclasses.replace(drop, model=dataclasses.replace(
            drop.model, dropout_rate=rate), train=dataclasses.replace(
            drop.train, pt_on_device_synth=True))
        t = FineTuner(c.model, scan, device=dev)
        t.load_state_dict(weights)
        sb.synth_batch.launches = 0
        m, _ = steps.make_pretrain_stream_step(
            t, c, optim.make_pretrain_optimizer(t.named_parameters(),
                                                c.train))(seed=11)
        torch.cuda.synchronize()
        if sb.synth_batch.launches != 1 or not np.isfinite(float(m["loss"])):
            raise AssertionError(f"streaming step at rate {rate}: S "
                                 f"{sb.synth_batch.launches}, {m}")
        losses_.append(float(m["loss"]))
    if abs(losses_[0] - losses_[1]) > 1e-6 * abs(losses_[1]):
        raise AssertionError(f"the streaming pretrain loss moved with the "
                             f"dropout rate: {losses_}")
    log(f"one streaming pretrain step at dropout {DROPOUT_RATE}: S launched, "
        f"loss {losses_[0]:.7g} (rate 0: {losses_[1]:.7g})")

    return out


def default_artifact_phase(dev, card, base, tuner) -> dict:
    """Phase 38, the default artifact."""
    from qbold_vi_tpu_torch import infer
    from qbold_vi_tpu_torch.io import export_model as em

    scan = base.scan
    tmp = tempfile.mkdtemp(dir=_SAVE_ROOT[0])
    rng = np.random.default_rng(38)
    t0 = time.perf_counter()
    ep = em.export_inference(tuner, use_first_op=False)
    export_s = time.perf_counter() - t0
    path = os.path.join(tmp, "maps.pt2")
    t0 = time.perf_counter()
    nbytes = em.save_exported(ep, path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    art = em.load_exported(path)
    load_s = time.perf_counter() - t0
    big = None
    for shape in EXPORT_GEOMETRIES:
        data = volumes(rng, shape, scan.n_taus)
        x = torch.from_numpy(data).to(dev)
        got = map_rows(art(x))
        ref = map_rows(infer.posterior_maps(tuner, data, use_first_op=False))
        e = max(check_close(f"default artifact {shape}", got[0], ref[0],
                            "mean"),
                check_close(f"default artifact {shape}", got[1], ref[1],
                            "var", ref[0]),
                check_close(f"default artifact {shape}", got[2], ref[2],
                            "raw"))
        log(f"default artifact (stream 2) at {shape} against posterior_maps: "
            f"within CHECKS, largest difference {e:.3e}")
        big = big if big is not None else (data, x)
    art_ms = wall_ms(lambda: art(big[1]), blocks=3)
    pm_ms = wall_ms(lambda: infer.posterior_maps(tuner, big[0],
                                                 use_first_op=False),
                    blocks=3)
    log(f"default artifact: export {export_s:.2f} s, save {save_s:.2f} s "
        f"({nbytes} bytes), load {load_s:.2f} s; a call on "
        f"{EXPORT_GEOMETRIES[0]} (on the card) {art_ms:.2f} ms against "
        f"posterior_maps (numpy in and out, chunks of 2) {pm_ms:.2f} ms "
        f"[{card}]")
    shutil.rmtree(tmp, True)
    return {"default_export_s": export_s, "default_save_s": save_s,
            "default_load_s": load_s, "default_bytes": nbytes,
            "default_call_ms": art_ms, "posterior_maps_ms": pm_ms}


def fused_artifact_phase(dev, card, base, tuner) -> dict:
    """Phase 38, the fused artifact: kernel B through its registered op."""
    from qbold_vi_tpu_torch import infer
    from qbold_vi_tpu_torch.io import export_model as em
    from qbold_vi_tpu_torch.ops import fused_infer as fi

    scan, mcfg = base.scan, base.model
    tmp = tempfile.mkdtemp(dir=_SAVE_ROOT[0])
    rng = np.random.default_rng(381)
    enc = dict(se_idx=scan.se_idx, multi_image=mcfg.multi_image_normalisation,
               activation=mcfg.activation,
               n_blocks=mcfg.no_intermediate_layers, trunk="float32",
               mvg=mcfg.use_mvg, oef_range=mcfg.oef_range,
               min_oef=mcfg.min_oef, dbv_range=mcfg.dbv_range,
               min_dbv=mcfg.min_dbv,
               dw_coeff=float(scan.dw_coeff * scan.hct), mask_channel=True,
               input_layout="channel")
    x_cm = torch.from_numpy(infer.to_channel_major(
        volumes(rng, REQUESTS[0], scan.n_taus))).to(dev)
    t0 = time.perf_counter()
    ep_f = em.export_inference(tuner, fused=True, platforms=("cuda",),
                               example_shape=REQUESTS[0])
    fused_export_s = time.perf_counter() - t0
    fpath = os.path.join(tmp, "fused.pt2")
    fbytes = em.save_exported(ep_f, fpath)
    t0 = time.perf_counter()
    art_f = em.load_exported(fpath)
    fused_load_s = time.perf_counter() - t0
    reset_counts()
    got = art_f(x_cm)
    torch.cuda.synchronize()
    b_launches = read_counts()["B"]
    ref = fi.encode_quad_fused(x_cm, tuner.encoder, **enc)
    for key, r in zip(("means", "stds", "raw_log_stds"), ref):
        if not torch.equal(got[key], r if mcfg.use_mvg or key != "raw_log_stds"
                           else r[:2]):
            raise AssertionError(f"fused artifact's {key} differs from the "
                                 "in-process kernel-B route")
    if b_launches != 1:
        raise AssertionError(f"the fused artifact launched B {b_launches} "
                             "times")
    fused_ms = wall_ms(lambda: art_f(x_cm))
    inproc_ms = wall_ms(lambda: fi.encode_quad_fused(x_cm, tuner.encoder,
                                                     **enc))
    log(f"fused artifact at {x_cm.shape[1]} voxels: bit-equal to the "
        f"in-process kernel-B route, B launched once a call through "
        f"torch.ops.qbold_vi_tpu_torch.encode_quad_fused; export "
        f"{fused_export_s:.2f} s, {fbytes} bytes, load {fused_load_s:.2f} s; "
        f"a call {fused_ms:.3f} ms against the wrapper's {inproc_ms:.3f} ms "
        f"[{card}]")
    shutil.rmtree(tmp, True)
    return {"fused_export_s": fused_export_s, "fused_load_s": fused_load_s,
            "fused_bytes": fbytes, "fused_call_ms": fused_ms,
            "fused_inproc_ms": inproc_ms,
            "fused_B_launches_a_call": b_launches}


def cli13_phase(dev, card, base, tuner) -> dict:
    """Phase 39 (see the module docstring)."""
    from qbold_vi_tpu_torch import cli, infer
    from qbold_vi_tpu_torch.io import nifti
    from qbold_vi_tpu_torch.train.trainer import Trainer

    scan = base.scan
    weights = {k: v.detach().clone() for k, v in tuner.state_dict().items()}
    tmp = tempfile.mkdtemp(dir=_SAVE_ROOT[0])
    rng = np.random.default_rng(39)

    spath = os.path.join(tmp, "synthetic.npz")
    t0 = time.perf_counter()
    rc, lines = run_cli(["synth", "-o", spath, "--preset", "optimal"])
    synth_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli synth: rc {rc}, {lines}")
    with np.load(spath) as f:
        x, y = f["x"], f["y"]
    n_vox = base.synth.sample_size ** 2
    if x.shape != (n_vox, scan.n_taus) or y.shape != (n_vox, 3) or not (
            np.isfinite(x).all() and np.isfinite(y).all()):
        raise AssertionError(f"cli synth wrote x{x.shape} y{y.shape}")
    s = base.synth
    if not (s.oef_start <= y[:, 0].min() and y[:, 0].max() <= s.oef_end
            and s.dbv_start <= y[:, 1].min() and y[:, 1].max() <= s.dbv_end):
        raise AssertionError("cli synth's labels left the population range")
    os.remove(spath)
    log(f"cli synth --preset optimal: {lines[-1]}; {synth_s:.2f} s (draws, "
        f"cross product and decode on the card, then the .npz) [{card}]")

    src = fresh_save(base)
    cli._save_fresh(Trainer(src, state_dict=weights, device=dev), weights,
                    "pretrain")
    dst = tempfile.mkdtemp(dir=_SAVE_ROOT[0])
    start, step, end = (str(v) for v in TRANSFER_GRID)
    rc, lines = run_cli(["transfer", "--tau-start", start, "--tau-step", step,
                         "--tau-end", end, "-o", dst, "--preset", "optimal",
                         "--set",
                         f"save_directory={src.train.save_directory}"])
    if rc != 0 or "24-tau protocol" not in lines[-1]:
        raise AssertionError(f"cli transfer: rc {rc}, {lines}")
    grid = ["--set", f"tau_start={start}", "--set", f"tau_step={step}",
            "--set", f"tau_end={end}"]
    moved = Trainer(dataclasses.replace(base, scan=dataclasses.replace(
        scan, tau_start=TRANSFER_GRID[0], tau_step=TRANSFER_GRID[1],
        tau_end=TRANSFER_GRID[2]), train=dataclasses.replace(
        base.train, save_directory=dst)), device=dev)
    for k, v in moved.tuner.state_dict().items():
        layer = k.split(".")[1] if k.startswith("encoder.") else None
        if layer not in ("first_conv", "sigma_head") and not torch.equal(
                v, weights[k]):
            raise AssertionError(f"transfer changed the trunk's {k}")
    req = volumes(rng, REQUESTS[-1], 24)
    rpath = os.path.join(tmp, "request24.npy")
    np.save(rpath, req)
    prefix = os.path.join(tmp, "maps24")
    reset_counts()
    t0 = time.perf_counter()
    rc, lines = run_cli(["infer", rpath, "-o", prefix, "--preset", "optimal",
                         "--set", f"save_directory={dst}", *grid])
    torch.cuda.synchronize()
    infer24_s = time.perf_counter() - t0
    counts = read_counts()
    if rc != 0 or counts["B"] == 0:
        raise AssertionError(f"cli infer on the transferred model: rc {rc}, "
                             f"launches {counts}")
    oef = nifti.load_nifti(prefix + "_oef.nii.gz")
    if not (np.isfinite(oef).all() and 0.04 <= oef.min()
            and oef.max() <= 0.84):
        raise AssertionError("the transferred model's OEF map")
    log(f"cli transfer to the 24-tau grid {TRANSFER_GRID} (trunk kept bit "
        f"for bit), then cli infer on {REQUESTS[-1]} x 24 taus: "
        f"{infer24_s:.2f} s, launches {counts} [{card}]")

    tdir = tempfile.mkdtemp(dir=_SAVE_ROOT[0])
    data = volumes(rng, EXPORT_GEOMETRIES[0], scan.n_taus)
    reset_counts()
    maps = infer.save_predictions(tuner, base, data, os.path.join(
        tmp, "mni"), use_first_op=False, transform_directory=tdir)
    a_launches = read_counts()["A"]
    check_maps(maps, data.shape[:-1], os.path.join(tmp, "mni"))
    if a_launches == 0:
        raise AssertionError("stream-2 save_predictions under "
                             "transform_directory never launched A")
    log(f"save_predictions(transform_directory=) of stream 2 on "
        f"{EXPORT_GEOMETRIES[0]}: A launched {a_launches} times; FSL "
        "absent here, so the maps stay in native space (the MNI commands "
        "are gated on the CPU: tests/test_torch_fsl_preprocess.py)")

    try:
        import h5py  # noqa: F401
        log("import-weights: h5py is installed here, but its gates run on "
            "the CPU (tests/test_torch_import_transfer.py, "
            "tests/test_torch_cli.py), against the JAX importer")
    except ImportError:
        rc, lines = run_cli(["import-weights", os.path.join(tmp, "w.h5"),
                             "--preset", "optimal", "--set",
                             f"save_directory={dst}"])
        if rc != 1:
            raise AssertionError(f"import-weights without h5py: rc {rc}")
        log("import-weights: this machine has no h5py, and the command "
            "exits 1 saying so (checked); its parity gates run on the CPU "
            "(tests/test_torch_import_transfer.py, tests/test_torch_cli.py)")
    shutil.rmtree(tmp, True)
    return {"synth_s": synth_s, "infer_transferred_s": infer24_s,
            "infer_transferred_launches": counts,
            "mni_save_predictions_A_launches": a_launches}


# ---- the data-parallel layer (phases 40-42) ---------------------------------

SHARDED_KERNELS = {"F_fwd": "fused_elbo_forward", "F_bwd": "fused_elbo_backward",
                   "S": "synth_batch", "B": "encode_quad_fused",
                   "A": "quad_posterior_summaries", "E": "mc_kl_map"}
MESH_STEPS = 100          # the sharded epochs of phase 40 and 41's timing
CERTIFY_RANKS = 2                    # phase 41: two ranks share the card
MESH_POP_TRIALS = 3                  # its population stage (read in 46)


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def finite(tag: str, values) -> None:
    if not np.all(np.isfinite(np.asarray(values, np.float64))):
        raise AssertionError(f"{tag}: not finite: {values}")


def sharded_phases(dev, card, base, tuner) -> dict:
    """Phases 40-42: the sharded paths on one rank (NCCL, in process), on
    two ranks sharing the card (gloo on CUDA tensors; multihost.certify)
    and through two ``train --mesh`` processes. Returns the walls, the
    all-reduce times and each rank's launches of F, S, B, A and E."""
    out = {"launches": {}}
    out["phase40"] = one_rank_phase(dev, card, base, tuner, out["launches"])
    out["phase41"] = two_rank_phase(card, out["launches"])
    out["phase42"] = mesh_cli_phase(card, base, out["launches"])
    return out


def one_rank_phase(dev, card, base, tuner, launches) -> dict:
    """Phase 40: a world of one rank over NCCL in this process."""
    import torch.distributed as dist

    from qbold_vi_tpu_torch import FineTuner, infer
    from qbold_vi_tpu_torch.ops import launch_counts
    from qbold_vi_tpu_torch.parallel import mesh as pmesh
    from qbold_vi_tpu_torch.train import optim, steps
    from qbold_vi_tpu_torch.train.data import predict_priors

    backend = pmesh.initialize_distributed(f"localhost:{free_port()}", 1, 0,
                                           device="cuda")
    log(f"phase 40: one rank, backend {backend} [{card}]")
    if backend != "nccl":
        raise AssertionError(f"one rank a card chose {backend}, not nccl")
    try:
        mesh = pmesh.make_mesh()
        rng = np.random.default_rng(40)
        vol = volumes(rng, TRAIN_VOLUMES, base.scan.n_taus)
        pri = (rng.normal(size=TRAIN_VOLUMES + (5,)) * 0.3).astype(np.float32)
        vol_d, pri_d = (torch.from_numpy(a).to(dev) for a in (vol, pri))
        sd = {k: v.clone() for k, v in tuner.state_dict().items()}
        b = base.train.ft_batch_size
        batch = steps.sample_crop_batch(torch.Generator().manual_seed(40),
                                        vol_d, pri_d, b, base.train.crop_size)

        def fresh():
            t = FineTuner(base.model, base.scan, device=dev)
            t.load_state_dict(sd)
            return t, optim.make_finetune_optimizer(t.parameters(),
                                                    base.train)

        # 40a. the sharded step is the unsharded one, bit for bit
        runs, step_fns = [], {}
        for name, m in (("unsharded", None), ("sharded", mesh)):
            t, opt = fresh()
            step = steps.make_finetune_step(t, base, opt, m)
            bt = batch if m is None else dict(
                batch, live=torch.ones(b, device=dev))
            runs.append((step(bt, seed=41), t.state_dict()))
            step_fns[name] = (lambda st=step, bb=bt: st(bb, seed=42))
        torch.cuda.synchronize()
        for k, v in runs[0][0].items():
            if not torch.equal(runs[1][0][k], v):
                raise AssertionError(f"phase 40: sharded {k} differs")
        for k, v in runs[0][1].items():
            if not torch.equal(runs[1][1][k], v):
                raise AssertionError(f"phase 40: sharded weights {k} differ")
        log("phase 40: the one-rank sharded step is the unsharded step bit "
            f"for bit (loss {float(runs[0][0]['loss']):.6f})")
        walls = {k: wall_ms(fn) for k, fn in step_fns.items()}
        profs = {k: profile(fn, 5, f"the {k} fine-tune step (phase 40)", card)
                 for k, fn in step_fns.items()}
        mesh.timed, mesh.seconds = True, collections.Counter()
        calls0 = mesh.counts["all_reduce"]
        for _ in range(10):
            step_fns["sharded"]()
        mesh.timed = False
        ar_ms = 1e3 * mesh.seconds["all_reduce"] / 10
        ar_calls = (mesh.counts["all_reduce"] - calls0) / 10
        log(f"phase 40: step wall {walls['sharded']:.3f} ms sharded against "
            f"{walls['unsharded']:.3f} ms unsharded; launches a step "
            f"{profs['sharded']['launches']:.0f} against "
            f"{profs['unsharded']['launches']:.0f}; all-reduce "
            f"{ar_ms:.4f} ms a step in {ar_calls:.0f} calls (NCCL, one "
            f"rank) [{card}]")

        # 40b-d. the sharded paths, their launches counted
        t, opt = fresh()
        before = launch_counts()
        t0 = time.perf_counter()
        m = steps.make_finetune_epoch_sharded(t, base, opt, MESH_STEPS,
                                              mesh)(43, vol_d, pri_d)
        loss = m["loss"].cpu().numpy()
        epoch_s = time.perf_counter() - t0
        finite("phase 40 sharded epoch", loss)
        popt = optim.make_pretrain_optimizer(t.named_parameters(), base.train)
        spe = 22
        t0 = time.perf_counter()
        plosses, _ = steps.make_pretrain_stream_epoch(t, base, popt, spe,
                                                      mesh=mesh)(44)
        stream_s = time.perf_counter() - t0
        finite("phase 40 streaming epoch", plosses)
        req = volumes(rng, REQUESTS[0], base.scan.n_taus)
        got = {f: infer.posterior_maps_sharded(tuner, req, mesh,
                                               use_first_op=f)
               for f in (True, False)}
        sub = vol[:6]

        @torch.no_grad()
        def encode(images):
            x = torch.from_numpy(np.ascontiguousarray(images)).to(dev)
            return tuple(o.cpu().numpy() for o in tuner.encode(x))

        priors = predict_priors(encode, sub, 5)
        emaps = infer.elbo_maps_sharded(tuner, base, sub, priors, mesh,
                                        seed=7)
        torch.cuda.synchronize()
        after = launch_counts()
        counts = {k: after[k] - before[k] for k in SHARDED_KERNELS}
        for f in (True, False):
            ref = infer.posterior_maps(tuner, req, use_first_op=f)
            for k, v in ref.items():
                if not np.array_equal(got[f][k], v):
                    raise AssertionError(f"phase 40: sharded stream "
                                         f"{1 if f else 2} {k} differs")
        eref = infer.elbo_maps(tuner, base, sub, priors, seed=7)
        for k, v in eref.items():
            if not np.array_equal(emaps[k], v):
                raise AssertionError(f"phase 40: sharded elbo {k} differs")
        log(f"phase 40: {MESH_STEPS}-step sharded epoch {epoch_s:.2f} s "
            f"(last loss {loss[-1]:.4f}), streaming sharded epoch of {spe} "
            f"steps {stream_s:.2f} s; posterior_maps_sharded on "
            f"{REQUESTS[0]} and elbo_maps_sharded on 6 subjects bit-equal "
            f"to the unsharded maps; launches {counts} [{card}]")
        want = {"F_fwd": MESH_STEPS, "F_bwd": MESH_STEPS, "S": spe}
        for k, n in want.items():
            if counts[k] != n:
                raise AssertionError(f"phase 40: {k} launched {counts[k]} "
                                     f"times, not {n}")
        for k in ("B", "A", "E"):
            if counts[k] == 0:
                raise AssertionError(f"phase 40: {k} was never launched")
        for k in SHARDED_KERNELS:
            launches.setdefault(k, {})["phase 40 (rank 0 of 1)"] = counts[k]
    finally:
        dist.destroy_process_group()
    return {"backend": backend, "step_ms": walls,
            "step_launches": {k: p["launches"] for k, p in profs.items()},
            "allreduce_ms_per_step": ar_ms, "epoch_s": epoch_s,
            "stream_epoch_s": stream_s}


def two_rank_phase(card, launches) -> dict:
    """Phase 41: two ranks sharing the card, certified against this
    process (multihost.certify at OPTIMAL's width)."""
    from qbold_vi_tpu_torch.parallel import multihost

    t0 = time.perf_counter()
    out = multihost.certify(CERTIFY_RANKS, device="cuda", width="optimal",
                            time_steps=MESH_STEPS, timeout_s=400,
                            population_trials=MESH_POP_TRIALS)
    secs = time.perf_counter() - t0
    log(f"phase 41: {CERTIFY_RANKS} ranks, backend {out['backend']}; "
        f"metrics bit-equal across ranks and within rtol {out['parity_rtol']} of "
        f"one process (fine-tune losses {out['ft_loss']} against "
        f"{out['single_process_ft_loss']}); the sharded maps of "
        f"{out['maps_subjects']} subjects "
        f"within it too; subject-sharded Trainer.finetune on 3 subjects: "
        f"loss {out['trainer_ft_loss']:.4f}; {secs:.1f} s [{card}]")
    log(f"phase 41: the device-noise sharded step "
        f"{out['ft_device_step_ms']} ms by rank against one process's "
        f"{out['single_process_step_ms']} ms for the whole batch (each a "
        f"{out['time_steps']}-step epoch's wall a step); its all-reduces "
        f"{out['allreduce_ms_per_step']} ms a step "
        f"({out['allreduce_calls_per_step']:.0f} calls, timed alone) by rank "
        f"[{card}]")
    for k in SHARDED_KERNELS:
        got = [c[k] for c in out["launches"]]
        if min(got) == 0:
            raise AssertionError(f"phase 41: {k} not launched on a rank: "
                                 f"{got}")
        launches.setdefault(k, {})["phase 41 (ranks 0-1)"] = got
    return {k: out[k] for k in (
        "backend", "ft_loss", "single_process_ft_loss",
        "allreduce_ms_per_step", "ft_device_step_ms",
        "single_process_step_ms", "collectives", "population",
        "population_rel_err", "population_s_launches")} | {
        "seconds": secs}


def mesh_cli_phase(card, base, launches) -> dict:
    """Phase 42: two ``python -m qbold_vi_tpu_torch train --mesh`` ranks
    on the card on phase 34's synthetic brains; rank 0 writes, both end
    equal, and the checkpoint resumes in an unsharded Trainer."""
    from qbold_vi_tpu_torch import infer
    from qbold_vi_tpu_torch.train import trainer as tr

    cfg = fresh_save(base)
    save = cfg.train.save_directory
    data_dir = tempfile.mkdtemp(dir=_SAVE_ROOT[0])
    write_real_directory(data_dir, base.scan)
    port = free_port()
    here = os.path.dirname(os.path.abspath(__file__))
    argv = ["--preset", "optimal", "--set", f"save_directory={save}",
            "--set", f"d={data_dir}", "--set", "no_pt_epochs=1",
            "--set", "pt_on_device_synth=true", "--set", "no_ft_epochs=1"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "qbold_vi_tpu_torch", "train", "--mesh",
         "--coordinator", f"localhost:{port}", "--num-processes", "2",
         "--process-id", str(i), *argv], cwd=here, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(2)]
    outs = []
    try:
        for i, p in enumerate(procs):
            o, e = p.communicate(timeout=400)
            if p.returncode != 0:
                raise AssertionError(f"phase 42: rank {i} exited "
                                     f"{p.returncode}:\n{e[-3000:]}")
            outs.append(o.splitlines())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0
    ranks = []
    for i, lines in enumerate(outs):
        tag = f"rank {i} of 2: "
        mine = [ln[len(tag):] for ln in lines if ln.startswith(tag)]
        if len(mine) != 1:
            raise AssertionError(f"phase 42: rank {i} printed {lines[-5:]}")
        ranks.append(json.loads(mine[0]))
    timeless = [{ph: {k: v for k, v in r[ph].items()
                      if not k.endswith("_time_s")}
                 for ph in ("pretrain", "finetune")} for r in ranks]
    if timeless[0] != timeless[1]:
        raise AssertionError(f"phase 42: the ranks' losses differ: "
                             f"{timeless}")
    if not any(ln.startswith("[finetune]") for ln in outs[0]) or any(
            ln.startswith(("[pretrain]", "[finetune]")) for ln in outs[1]):
        raise AssertionError("phase 42: rank 0 alone must log")
    files = set(os.listdir(save))
    for f in ("pt_model.msgpack", "final_model.msgpack", "baseline_kl.nii.gz",
              "hyperv_oef.nii.gz", "pt_baseline_oef.nii.gz"):
        if f not in files:
            raise AssertionError(f"phase 42: {f} not written: {files}")
    plain = tr.Trainer(cfg, logger=lambda *a: None)
    if plain.status is not tr.WeightStatus.FULL_TRAINED:
        raise AssertionError(f"phase 42: resumed as {plain.status}")
    finite("phase 42 resumed maps", infer.posterior_maps(
        plain.tuner, volumes(np.random.default_rng(42), (1, 32, 32, 8),
                             base.scan.n_taus))["oef"])
    log(f"phase 42: train --mesh on 2 ranks {secs:.1f} s; losses equal on "
        f"both ranks ({timeless[0]['finetune'].get('loss')}); rank 0 wrote "
        f"the checkpoints and maps; an unsharded Trainer resumed "
        f"final_model.msgpack; launches by rank "
        f"{[{k: r['launches'][k] for k in SHARDED_KERNELS} for r in ranks]}"
        f" [{card}]")
    for k in SHARDED_KERNELS:
        got = [r["launches"][k] for r in ranks]
        if min(got) == 0:
            raise AssertionError(f"phase 42: {k} not launched on a rank: "
                                 f"{got}")
        launches.setdefault(k, {})["phase 42 (ranks 0-1)"] = got
    return {"seconds": secs, "metrics": timeless[0]}


# ---- the sweep (phases 43-46) -----------------------------------------------

# configurations/sweep_prior.yaml as yaml.safe_load reads it (the card's
# machine has no pyyaml; tests/test_torch_sweep.py holds the two equal):
# YAML 1.1 reads the dot-less exponents as strings, which the overrides
# coerce to the field's type
SWEEP_PRIOR = {
    "method": "bayes",
    "metric": {"name": "val_elbo", "goal": "minimize"},
    "parameters": {
        "no_units": {"value": 30},
        "student_t_df": {"value": 2},
        "no_pt_epochs": {"values": [10, 20]},
        "crop_size": {"value": 16},
        "pt_lr": {"values": ["2e-3", "1e-3", "8e-4", "5e-4", "1e-4", "5e-5",
                             "1e-5"]},
        "ft_lr": {"value": "2e-3"},
        "inv_gamma_alpha": {"min": 0.1, "max": 10.0},
        "inv_gamma_beta": {"min": 0.1, "max": 10.0},
        "misalign_prob": {"value": 0.0},
        "use_blood": {"values": [True]},
        "activation": {"values": ["relu"]},
        "use_r2p_loss": {"values": [False]},
        "multi_image_normalisation": {"values": [True]},
        "dropout_rate": {"value": 0.0},
        "no_intermediate_layers": {"value": 1},
        "no_ft_epochs": {"value": 40},
        "use_layer_norm": {"value": False},
        "kl_weight": {"value": 1.0},
        "smoothness_weight": {"value": 1.0},
        "im_loss_sigma": {"value": 0.08},
    },
}


POP_TRIALS = (           # phase 44: one group (every trial has the prior)
    {"pt_lr": 2e-3, "inv_gamma_alpha": 1.0, "inv_gamma_beta": 1.0,
     "ft_lr": 5e-3, "adamw_decay": 2e-4},
    {"pt_lr": 1e-3, "inv_gamma_alpha": 3.0, "inv_gamma_beta": 1.0,
     "ft_lr": 2e-3, "adamw_decay": 0.0},
    {"pt_lr": 5e-4, "inv_gamma_alpha": 0.5, "inv_gamma_beta": 2.0,
     "ft_lr": 1e-3, "adamw_decay": 1e-3},
    {"pt_lr": 4e-3, "inv_gamma_alpha": 2.0, "inv_gamma_beta": 0.5,
     "ft_lr": 8e-3, "adamw_decay": 5e-4})
S_TRIAL_SEEDS = (11, 2 ** 40 + 3, 977, 12345)      # phase 43's four trials
PT_GATE = dict(rtol=2e-4, atol=1e-5)  # tests/test_sweep.py:207-216
FT_GATE = dict(rtol=5e-4, atol=1e-5)  # tests/test_sweep.py:729-733
SWEEP_KERNELS = {"S": "synth_batch", "F_fwd": "fused_elbo_forward",
                 "F_bwd": "fused_elbo_backward"}


def no_failed(tag: str, results) -> None:
    """A card phase accepts no trial whose status is "failed": the
    population batch's retry would otherwise hide a kernel that fails to
    build or launch behind a failed trial ranked last."""
    bad = [r for r in results if r.get("status") == "failed"]
    if bad:
        raise AssertionError(f"{tag}: failed trials {bad}")
    finite(tag, [r["val_elbo"] for r in results])


def gate(tag: str, got: list, ref: list, keys, tol: dict) -> float:
    """Each trial's metrics within ``tol`` of the oracle's; returns the
    largest relative difference."""
    worst = 0.0
    for a, b in zip(got, ref):
        for k in keys:
            if not np.isclose(a[k], b[k], **tol):
                raise AssertionError(f"{tag}: {k} {a[k]} against {b[k]}")
            worst = max(worst, abs(a[k] - b[k]) / max(abs(b[k]), 1e-30))
    return worst


def sweep_phases(dev, card, base, two_ranks) -> dict:
    """Phases 43-46: kernel S's trial axis, the populations at OPTIMAL's
    width, the searches, the CLI's sweep and the agent, and the trials over
    two ranks (``two_ranks``: phase 41's certification, whose ranks ran the
    population stage). Returns S's trial-axis times and bound, the
    launches of S and F on the population path, and the walls."""
    out = {"launches": {}}
    out["phase43"] = synth_trials_phase(dev, card, base)
    with tempfile.TemporaryDirectory() as d:
        write_real_directory(d, base.scan)
        out["phase44"] = population_phase(dev, card, base, d, out["launches"])
        out["phase45"] = search_phase(dev, card, base, d, out["launches"])
    out["phase46"] = mesh_population_phase(card, two_ranks)
    return out


def synth_trials_phase(dev, card, base) -> dict:
    """Phase 43: S at P = 4 trials of OPTIMAL's batch in one launch."""
    from qbold_vi_tpu_torch.ops import synth_batch as sb
    from qbold_vi_tpu_torch.train import steps

    b, t_n = base.train.pt_batch_size, base.scan.n_taus
    n = b * 500
    seeds = list(S_TRIAL_SEEDS)
    before = (sb.synth_batch.launches, sb.synth_batch.noise_launches)
    got = sb.synth_batch(base, b, seeds=seeds, device=dev)
    torch.cuda.synchronize()
    if (sb.synth_batch.launches - before[0],
            sb.synth_batch.noise_launches - before[1]) != (1, 1):
        raise AssertionError("phase 43: the trial axis is not one launch of "
                             "each pass")
    err = 0.0
    for j, seed in enumerate(seeds):
        one = sb.synth_batch(base, b, seed, device=dev)
        for k in ("x", "y"):
            if not torch.equal(got[k][j], one[k]):
                raise AssertionError(f"phase 43: trial {j}'s {k} is not the "
                                     "one-trial launch's bit for bit")
        dd = {k: torch.from_numpy(v).to(dev)
              for k, v in sb.synth_philox_draws(seed, n, t_n).items()}
        ref = steps.stream_synthetic_batch(base, b, dd)
        for k in ("x", "y"):
            err = max(err, check_rows(f"phase 43 trial {j} {k}", got[k][j],
                                      ref[k]))
    log(f"phase 43: S at P = 4 x {n:,} voxels in one launch: each trial "
        "bit-equal to its one-trial launch, and within ROW_TOL of the "
        f"plain version on the replayed draws (largest {err:.3e})")
    log_clocks("before S's trial-axis timings")
    p4, how4 = s_device_ms(lambda: sb.synth_batch(base, b, seeds=seeds,
                                                  device=dev))
    one_ms, how1 = s_device_ms(lambda: sb.synth_batch(base, b, seeds[0],
                                                      device=dev))
    calls = {"P4": cuda_ms(lambda: sb.synth_batch(base, b, seeds=seeds,
                                                  device=dev)),
             "4x1": cuda_ms(lambda: [sb.synth_batch(base, b, s, device=dev)
                                     for s in seeds])}
    mis = base.synth.misalign_prob > 0.0
    p_bound = synth_bound(4 * n, t_n, mis)
    # the two device times compare only when both are the profiler's
    # (CUDA events add the launches' overhead)
    versus = (f"against 4 x {one_ms:.4f} = {4 * one_ms:.4f} ms in single "
              f"launches (profiler)" if how4 == how1 == "profiler" else
              f"(single launch {one_ms:.4f} ms by {how1}: not compared)")
    log(f"phase 43: S device time {p4:.4f} ms at P = 4 ({how4}) {versus}; "
        f"a call {calls['P4']:.4f} ms against {calls['4x1']:.4f} ms for the "
        f"four (CUDA events); bound {p_bound['bound_ms']:.5f} ms "
        f"({p_bound['bound_by']}, 4 x {n * (3 + t_n) * 4 / 1e6:.1f} MB) "
        f"[{card}]")
    return {"ms_trials4": p4, "ms_trials4_how": how4, "ms_single": one_ms,
            "ms_single_how": how1,
            "call_ms_trials4": calls["P4"], "call_ms_4x1": calls["4x1"],
            "bound_ms_trials4": p_bound["bound_ms"],
            "bound_by_trials4": p_bound["bound_by"], "max_abs_err": err}


def s_device_ms(fn) -> tuple:
    """(kernel S's device ms a call, how it was taken): its two kernels'
    median launches summed from the profiler's trace, at least 4 of 21
    calls' records each (a trace late in a long process dropped most of
    the pass-1 records on the H100: 8 of 21, three times); where even
    fewer are traced, CUDA events around back-to-back calls."""
    try:
        return (sum(kernel_ms(fn, sym, 21, need=4) for sym in S_SYMBOLS),
                "profiler")
    except AssertionError as e:
        log(f"{e}: S timed by CUDA events")
        return cuda_ms(fn), "CUDA events"


def population_phase(dev, card, base, data_dir, launches) -> dict:
    """Phase 44: population_pretrain and population_full_run of 4 trials at
    OPTIMAL's width against their serial oracle (host noise), the device
    noise's launches, the walls, and one population step's profile."""
    from qbold_vi_tpu_torch import sweep
    from qbold_vi_tpu_torch.train import data as data_pipe
    from qbold_vi_tpu_torch.train import steps

    cfg = fresh_save(dataclasses.replace(base, train=dataclasses.replace(
        base.train, no_pt_epochs=1, no_ft_epochs=1,
        data_directory=data_dir)))
    host = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, fused_elbo="host"))
    trials = list(POP_TRIALS)
    # the pretrain objective's trials: its per-trial keys only (the
    # fine-tune's would make each trial a group of its own)
    pt_trials = [{k: v for k, v in t.items() if k in sweep._POP_KEYS}
                 for t in trials]
    pt_keys = ("val_loss", "oef_mse", "dbv_mse", "r2p_mse", "loss")
    ft_keys = ("val_elbo", "val_nll", "val_kl", "val_smoothness", "loss",
               "pt_val_loss")
    walls, errs = {}, {}
    for name, fn, c, ovs, keys, tol in (
            ("pretrain", sweep.population_pretrain, cfg, pt_trials, pt_keys,
             PT_GATE),
            ("full_run", sweep.population_full_run, host, trials, ft_keys,
             FT_GATE)):
        t0 = time.perf_counter()
        pop = fn(c, ovs, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ser = fn(c, ovs, device=dev, serial=True)
        torch.cuda.synchronize()
        walls[f"{name}_host_noise"] = (t1 - t0, time.perf_counter() - t1)
        no_failed(f"phase 44 {name}", pop + ser)
        errs[name] = gate(f"phase 44 {name} against its serial run", pop,
                          ser, keys, tol)
        log(f"phase 44: population_{name} of 4 trials matches its serial "
            f"oracle (largest rel {errs[name]:.2e}); walls "
            f"{walls[name + '_host_noise'][0]:.2f} s against "
            f"{walls[name + '_host_noise'][1]:.2f} s serial [{card}]")
    reset_counts()
    t0 = time.perf_counter()
    pop = sweep.population_full_run(cfg, trials, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    walls["full_run_device_noise"] = wall
    no_failed("phase 44 device noise", pop)
    if len({round(r["val_elbo"], 6) for r in pop}) != 4:
        raise AssertionError("phase 44: the trials are not distinct")
    total = cfg.train.no_ft_epochs * cfg.train.ft_steps_per_epoch
    pt_steps = cfg.train.no_pt_epochs * max(1, round(
        0.9 * cfg.synth.sample_size ** 2 / 500 / cfg.train.pt_batch_size))
    want = {"F_fwd": total, "F_bwd": total, "S": pt_steps}
    for k, v in want.items():
        if counts[k] != v:
            raise AssertionError(f"phase 44: {k} launched {counts[k]} times "
                                 f"in the population, not {v}")
        launches.setdefault(k, {})["phase 44 (P = 4)"] = counts[k]
    log(f"phase 44: population_full_run of 4 trials (device noise): F "
        f"{counts['F_fwd']} + {counts['F_bwd']} launches for {total} steps "
        f"of 4 x {cfg.train.ft_batch_size} crops, S {counts['S']} for "
        f"{pt_steps} pretrain steps; wall {wall:.2f} s (under host noise "
        f"{walls['full_run_host_noise'][0]:.2f} s, serially "
        f"{walls['full_run_host_noise'][1]:.2f} s) [{card}]")
    # one population fine-tune step, profiled
    pop_ = sweep._Population(cfg, trials, range(4), dev)
    vols = torch.from_numpy(data_pipe.blank_crop(np.load(os.path.join(
        data_dir, "ASE_scan.npy")))).to(dev)
    with torch.no_grad():
        priors = [t.encode(vols[..., :-1] * vols[..., -1:])[0][..., :5]
                  for t in pop_.tuners]
    adam = sweep._StackedAdam(pop_.stacked, b2=0.9)
    gen = torch.Generator().manual_seed(44)

    def step():
        batches = [steps.sample_crop_batch(gen, vols, p,
                                           cfg.train.ft_batch_size,
                                           cfg.train.crop_size)
                   for p in priors]
        seeds = [int(torch.randint(0, 2 ** 62, (1,), generator=gen))
                 for _ in range(5)]
        sweep._finetune_step(pop_, cfg, adam, batches, seeds[:4], seeds[4],
                             0, total)

    prof = profile(step, 5, "one population fine-tune step (P = 4, 4 x "
                   "190,000 F rows)", card)
    f_rows = f_population_check(dev, host, trials, vols, card)
    return {"walls_s": walls, "rel_err": errs, "step": prof,
            "launches": counts, "f_rows": f_rows}


def f_population_check(dev, cfg, trials, vols, card) -> dict:
    """Kernel F at the population's shape: the P N rows of all trials that
    one population step (host noise) hands it, captured at its call in
    steps.population_finetune_terms, against the plain rows and gradients
    at ROW_TOL / GRAD_TOL (the backward replaying every draw, and from the
    KL state); then its device noise at an offset: a launch over the last
    half of the rows under a seed draws, bit for bit, what a launch over
    all of them draws there (a trial's draws do not depend on the trials
    launched with it)."""
    from qbold_vi_tpu_torch import sweep
    from qbold_vi_tpu_torch.ops import fused_elbo as fe
    from qbold_vi_tpu_torch.train import steps

    pop = sweep._Population(cfg, trials, range(len(trials)), dev)
    gen = torch.Generator().manual_seed(45)
    with torch.no_grad():
        priors = [t.encode(vols[..., :-1] * vols[..., -1:])[0][..., :5]
                  for t in pop.tuners]
        batches = [steps.sample_crop_batch(gen, vols, p,
                                           cfg.train.ft_batch_size,
                                           cfg.train.crop_size)
                   for p in priors]
        seeds = [int(torch.randint(0, 2 ** 62, (1,), generator=gen))
                 for _ in priors]
        seen, real = [], steps.fused_elbo

        def capture(*args, **kw):
            seen.append((args, kw))
            return real(*args, **kw)

        steps.fused_elbo = capture
        try:
            steps.population_finetune_terms(pop.tuners, cfg, batches,
                                            seeds=seeds, device_seed=0)
        finally:
            steps.fused_elbo = real
    (args, kw), = seen
    *main, c = args
    main = [a.detach().contiguous() for a in main]
    n = main[4].shape[0]
    per = cfg.train.ft_batch_size * cfg.train.crop_size ** 2 * vols.shape[3]
    if n != len(trials) * per or "z_nll" not in kw:
        raise AssertionError(f"phase 44: F was handed {n:,} rows ({kw}), not "
                             f"{len(trials)} x {per:,} under host noise")
    g = torch.Generator(device=dev).manual_seed(46)
    ct_n, ct_k = (torch.randn(n, device=dev, generator=g) for _ in range(2))
    state = torch.empty(n, fe.KL_STATE, device=dev)
    got = fe.fused_elbo_forward(*main, c, state=state, **kw)
    grads = fe.fused_elbo_backward(*main, ct_n, ct_k, c, **kw)
    from_state = fe.fused_elbo_backward(*main, ct_n, ct_k, c, state=state,
                                        **kw)
    ref = fe.elbo_rows_plain(*main, kw["z_nll"], kw["z_kl"], c, kw["mvg"])
    gref = fe.elbo_grads_plain(*main, kw["z_nll"], kw["z_kl"], ct_n, ct_k,
                               c, kw["mvg"])
    names = ("dq", "dp", "dy", "dsigma")
    e_rows = max(check_rows(f"phase 44 F fwd at {n:,} rows {nm}", x, r)
                 for nm, x, r in zip(("nll", "kl"), got, ref))
    e_grads = max(check_grad(f"phase 44 F bwd at {n:,} rows {nm}{way}", x, r)
                  for way, gs in (("", grads), (" from the state", from_state))
                  for nm, x, r in zip(names, gs, gref))
    dkw = {k: kw[k] for k in ("mvg", "s_nll", "s_kl")}
    half = n // 2
    tail = [a[half:] for a in main]
    whole = fe.fused_elbo_forward(*main, c, seed=4407, **dkw)
    part = fe.fused_elbo_forward(*tail, c, seed=4407, offset=half, **dkw)
    g_whole = fe.fused_elbo_backward(*main, ct_n, ct_k, c, seed=4407, **dkw)
    g_part = fe.fused_elbo_backward(*tail, ct_n[half:], ct_k[half:], c,
                                    seed=4407, offset=half, **dkw)
    for nm, a, b in zip(("nll", "kl") + names, (*whole, *g_whole),
                        (*part, *g_part)):
        if not torch.equal(a[half:], b):
            raise AssertionError(f"phase 44: F's {nm} over rows {half:,}.. at "
                                 "their offset is not the whole launch's")
    log(f"phase 44: F on one population step's {n:,} rows (4 trials x "
        f"{per:,}, host noise) against the plain version: rows within "
        f"ROW_TOL (largest {e_rows:.3e}), gradients within GRAD_TOL "
        f"(largest {e_grads:.3e}), replayed and from the state; device "
        f"noise at offset {half:,} bit-equal to the whole launch's rows "
        f"[{card}]")
    return {"rows": n, "max_abs_err": e_rows, "max_grad_err": e_grads}


def search_phase(dev, card, base, data_dir, launches) -> dict:
    """Phase 45: bayes_search (populations of 4 through full_run) and
    random_search (populations through the pretrain objective) over
    sweep_prior.yaml's space, the CLI's grid sweep (serial Trainer trials)
    and the wandb agent with a stand-in module."""
    import threading

    from qbold_vi_tpu_torch import sweep

    space, metric, goal, _ = sweep.parse_wandb_sweep(SWEEP_PRIOR)
    # the schedule cut as in phase 44
    space = dict(space, no_pt_epochs=("fixed", 1), no_ft_epochs=("fixed", 1))
    cfg = fresh_save(dataclasses.replace(base, train=dataclasses.replace(
        base.train, data_directory=data_dir)))
    out = {}
    reset_counts()
    t0 = time.perf_counter()
    res = sweep.bayes_search(cfg, space, 8, run_fn=sweep.full_run,
                             metric=metric, maximize=goal == "maximize",
                             parallel_trials=4, n_startup=4, device=dev)
    out["bayes_s"] = time.perf_counter() - t0
    no_failed("phase 45 bayes_search", res)
    counts = read_counts()
    for k in SWEEP_KERNELS:
        if counts[k] == 0:
            raise AssertionError(f"phase 45: {k} not launched by the search")
        launches.setdefault(k, {})["phase 45 (bayes_search, 2 x P = 4)"] = \
            counts[k]
    log(f"phase 45: bayes_search of 8 trials in populations of 4 over "
        f"sweep_prior.yaml's space ({out['bayes_s']:.1f} s): best val_elbo "
        f"{res[0]['val_elbo']:.4f} at pt_lr {res[0]['overrides']['pt_lr']}; "
        f"launches {counts} [{card}]")
    t0 = time.perf_counter()
    res = sweep.random_search(cfg, space, 4, parallel_trials=4, device=dev)
    out["random_s"] = time.perf_counter() - t0
    no_failed("phase 45 random_search", res)
    log(f"phase 45: random_search of 4 trials, one population through the "
        f"pretrain objective ({out['random_s']:.1f} s): best val_elbo "
        f"{res[0]['val_elbo']:.4f} [{card}]")
    save = fresh_save(base).train.save_directory
    reset_counts()
    t0 = time.perf_counter()
    rc, lines = run_cli(["sweep", "--preset", "optimal", "--layers", "2",
                         "--units", "60", "--seeds", "2", "--set",
                         "no_pt_epochs=1", "--set", "no_ft_epochs=1",
                         "--set", "pt_on_device_synth=True", "--set",
                         f"d={data_dir}", "--set",
                         f"save_directory={save}"])
    out["cli_s"] = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"phase 45: sweep exited {rc}: {lines[-5:]}")
    text = "\n".join(lines)
    res = json.loads(text[text.index("[\n"):])
    no_failed("phase 45 sweep CLI", res)
    if [r["status"] for r in res] != ["FULL_TRAINED"] * 2:
        raise AssertionError(f"phase 45: the CLI's trials: {res}")
    counts = read_counts()
    if min(counts[k] for k in SWEEP_KERNELS) == 0:
        raise AssertionError(f"phase 45: the CLI's sweep launched {counts}")
    log(f"phase 45: sweep --layers 2 --units 60 --seeds 2 (two serial "
        f"full_run trials, streaming pretrain) {out['cli_s']:.1f} s: val_elbo "
        f"{[round(r['val_elbo'], 4) for r in res]}; launches {counts} "
        f"[{card}]")

    class Run:
        def __init__(self, config):
            self.config, self.logged = config, []

        def log(self, m):
            self.logged.append(m)

        def finish(self, exit_code=0):
            self.exit_code = exit_code

    class Wandb:
        """wandb's stand-in: agent() calls the function a proposal."""

        def __init__(self, proposals):
            self.proposals, self.runs = list(proposals), []
            self.lock = threading.Lock()

        def init(self, **kw):
            with self.lock:
                run = Run(self.proposals[len(self.runs)])
                self.runs.append(run)
                return run

        def agent(self, sweep_id, function=None, count=None):
            for _ in range(count):
                function()

    fake = Wandb([{"pt_lr": 1e-3, "ft_lr": 2e-3},
                  {"pt_lr": 5e-4, "ft_lr": 5e-3},
                  {"pt_lr": 2e-3, "ft_lr": 1e-3}])
    agent_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, no_pt_epochs=1, no_ft_epochs=1))
    t0 = time.perf_counter()
    n = sweep.run_wandb_agent("smoke/sweep", agent_cfg, count=3,
                              wandb_module=fake, parallel_trials=2,
                              device=dev)
    out["agent_s"] = time.perf_counter() - t0
    if n != 3 or any(r.exit_code for r in fake.runs):
        raise AssertionError("phase 45: the agent's runs did not all finish "
                             "cleanly")
    no_failed("phase 45 agent", [r.logged[0] for r in fake.runs])
    log(f"phase 45: run_wandb_agent (stand-in wandb, parallel_trials 2, "
        f"count 3) {out['agent_s']:.1f} s: val_elbo "
        f"{[round(r.logged[0]['val_elbo'], 4) for r in fake.runs]} [{card}]")
    return out


def mesh_population_phase(card, out) -> dict:
    """Phase 46: the population stage of phase 41's certification (3
    trials over 2 ranks sharing the card, held by multihost.certify to one
    process), then ``dryrun --devices 2`` with its population stage."""
    no_failed("phase 46", out["population"])
    if (len(out["population"]) != MESH_POP_TRIALS
            or min(out["population_s_launches"]) == 0):
        raise AssertionError(f"phase 46: the ranks' population: "
                             f"{out['population']}, S launches by rank "
                             f"{out['population_s_launches']}")
    log(f"phase 46: {MESH_POP_TRIALS} trials over 2 ranks ({out['backend']}, "
        f"phase 41's ranks) bit-equal across ranks, within rel "
        f"{out['population_rel_err']:.2e} of one process; S launches by rank "
        f"{out['population_s_launches']} [{card}]")
    t0 = time.perf_counter()
    rc, lines = run_cli(["dryrun", "--devices", "2"])
    dry_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"phase 46: dryrun exited {rc}")
    dry = json.loads(lines[-1])
    if not dry["ok"] or len(dry["population"]) != 2:
        raise AssertionError(f"phase 46: dryrun {dry}")
    no_failed("phase 46 dryrun", dry["population"])
    log(f"phase 46: dryrun --devices 2 with its population stage "
        f"(rel {dry['population_rel_err']:.2e}) {dry_s:.1f} s [{card}]")
    return {"rel_err": out["population_rel_err"], "dryrun_s": dry_s}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--weights", help="params .npz (io/from_jax.py "
                    "save_params_npz); default: init_params seed 0")
    args = ap.parse_args()

    # ---- 1. device -------------------------------------------------------
    t_start = time.perf_counter()

    def elapsed(what: str) -> None:
        log(f"[{time.perf_counter() - t_start:.1f} s] {what}")

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
    check_mufu_sass(_cuda.library()._name)
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
            for mix in HEAD_MIXES:
                q = torch.from_numpy(raw_head(rng, n, mix)).to(dev)
                for mvg in (True, False):
                    kw = dict(ranges, mvg=mvg)
                    tag = f"A n={n} {mix} mvg={mvg}"
                    m, v = quad.quad_posterior_summaries(q, **kw)
                    mr, vr = quad.posterior_summaries_quadrature(q, **kw)
                    e = max(check_close(tag, m, mr, "mean"),
                            check_close(tag, v, vr, "var", mr))
                    if n == N_FULL and mvg and mix == "straddling":
                        err["quad"] = e
                    if n == N_FULL and mvg:
                        # float64: the plain code in double on the same
                        # float32 node words
                        m64, v64 = quad.posterior_summaries_quadrature(
                            q.double(), **kw)
                        f64 = [float((a.double() - b).abs().max()) for a, b
                               in ((m, m64), (mr, m64), (v, v64), (vr, v64))]
                        log(f"{tag} against float64: means {f64[0]:.3e} "
                            f"(plain {f64[1]:.3e}), variances {f64[2]:.3e} "
                            f"(plain {f64[3]:.3e})")
            torch.cuda.synchronize()
            log(f"kernel A vs plain ok at N={n} ({', '.join(HEAD_MIXES)} "
                "heads; mvg and diag)")
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
    b_bound = stream1_bounds(N_FULL, cfg, scan.n_taus, raw_b,
                             cfg.use_mvg)["B"]
    raw_a = squashed(q, cfg.use_mvg)
    log(f"timed heads of A: {branch_shares(raw_a, cfg.use_mvg)}; B's: "
        f"{branch_shares(raw_b, cfg.use_mvg)}")
    clock = mufu_clock_hz()
    a_bound = bound(N_FULL * 4 * 11, ops_quad(raw_a, cfg.use_mvg))
    a_bound["mufu_bound_ms"] = mufu_bound(mufu_quad(raw_a, cfg.use_mvg),
                                          clock)
    b_bound["mufu_bound_ms"] = mufu_bound(mufu_quad(raw_b, cfg.use_mvg),
                                          clock)
    log_bounds({"A": times["quad"][0], "B": times["fused"][0]},
               {"A": a_bound, "B": b_bound}, card)
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
         **a_bound, "library_ms": None},
        {"name": "encode_quad_fused", "route": "cuda",
         "source": "qbold_vi_tpu_torch/csrc/encode_quad.cu",
         "replaces": "qbold_vi_tpu/ops/pallas_infer.py:353",
         "launches": launches["fused"], "max_abs_err": err["fused"],
         "ms": times["fused"][0], "plain_ms": times["fused"][2],
         **b_bound, "library_ms": None},
    ]
    elapsed("phases 10-13")
    sampled = sampled_phases(dev, card, OPTIMAL, tuner, ranges, enc_kw,
                             raw_b)
    kernels += sampled["kernels"]
    elapsed("phases 23-25 and 47")
    err64, wide = stream1_phases(dev, card, OPTIMAL, tuner, ranges, enc_kw)
    kernels += wide["kernels"]
    elapsed("phases 6-9 and 19-22")
    phases = fine_tune_phases(dev, card, OPTIMAL, tuner)
    kernels += phases["kernels"]
    elapsed("phase 14")
    conv = conv_phases(dev, card)
    elapsed("phases 15-18")
    two = two_phase_path(dev, card, OPTIMAL, conv)
    kernels += two["kernels"]
    elapsed("phases 26-28")
    stream = stream_phases(dev, card, OPTIMAL)
    kernels += stream["kernels"]
    elapsed("phases 29-33")
    bf16 = bf16_phases(dev, card, OPTIMAL, tuner)
    kernels += bf16["kernels"]
    elapsed("phases 34-36")
    cli = cli_phases(dev, card, OPTIMAL)
    elapsed("phases 37-39")
    new = dropout_export_cli_phases(dev, card, OPTIMAL, tuner)
    elapsed("phases 40-42")
    sharded = sharded_phases(dev, card, OPTIMAL, tuner)
    for entry in kernels:
        for k, name in SHARDED_KERNELS.items():
            if entry["name"] == name:
                entry["launches_sharded"] = sharded["launches"][k]
    elapsed("phases 43-46")
    swept = sweep_phases(dev, card, OPTIMAL, sharded["phase41"])
    for entry in kernels:
        for k, name in SWEEP_KERNELS.items():
            if entry["name"] == name:
                entry["launches_sweep"] = swept["launches"][k]
        if entry["name"] == "synth_batch":
            entry.update({k: swept["phase43"][k] for k in (
                "ms_trials4", "ms_trials4_how", "bound_ms_trials4",
                "bound_by_trials4", "ms_single_how")})
            entry["ms_4_single_launches"] = 4 * swept["phase43"]["ms_single"]
    elapsed("done")
    print(json.dumps({"posterior_maps_wall_ms": walls,
                      "mc_posterior_maps_wall_ms": sampled["mc_walls"],
                      "elbo_maps_wall_ms_per_subject": sampled["elbo_ms"],
                      "finetune_step_ms": phases["step_ms"],
                      "finetune_epoch_wall_ms": phases["epoch_ms"],
                      "finetune_diag_prior_step_ms": phases["pop_step_ms"],
                      "finetune_diag_prior_epoch_wall_ms":
                          phases["pop_epoch_ms"],
                      "pretrain_step_ms": two["pretrain_step_ms"],
                      "pretrain_epoch_s": two["pretrain_epoch_s"],
                      "pretrain_data_s": two["pretrain_data_s"],
                      "finetune_step_ms_by_conv": two["finetune_step_ms"],
                      "finetune_epoch_wall_ms_conv_on":
                          two["finetune_epoch_on_ms"],
                      "stream2_wall_ms_by_conv": two["stream2_wall_ms"],
                      **{k: v for k, v in stream.items() if k != "kernels"},
                      "bf16": {k: v for k, v in bf16.items()
                               if k != "kernels"},
                      "stream1_float64_err": err64,
                      "wide_stream1": {
                          "trunk": WIDE_TRUNK, "past": PAST_TRUNK,
                          "past_wide": PAST_WIDE_TRUNK,
                          "split": SPLIT_TRUNK,
                          "cluster": CLUSTER_TRUNK,
                          "cluster_chunked": CHUNK_TRUNK,
                          "dense": DENSE_TRUNK,
                          "dense_tau_step": DENSE_TAU_STEP,
                          "dense_wide": DENSE_WIDE_TRUNK,
                          "dense_wide_tau_step": DENSE_WIDE_TAU_STEP,
                          "windowed": WINDOW_TRUNK,
                          "windowed_narrow": WINDOW_NARROW_TRUNK,
                          "windowed_wide": WINDOW_WIDE_TRUNK,
                          "windowed_tau_step": WINDOW_TAU_STEP,
                          "ms": {"-".join(k): v
                                 for k, v in wide["ms"].items()},
                          "routes_ms": {"-".join(k): v for k, v
                                        in wide["routes_ms"].items()},
                          "requests": wide["requests"]},
                      "cli": cli,
                      "dropout_export_cli": new,
                      "sharded": {k: v for k, v in sharded.items()
                                  if k != "launches"},
                      "sweep": {k: v for k, v in swept.items()
                                if k != "launches"},
                      "card": card}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
