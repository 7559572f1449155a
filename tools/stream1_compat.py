"""Kernels B and C of two checkouts of the port, compared on the card.

    env PYTHONPATH=<a> python3 tools/stream1_compat.py save F.npz
    env PYTHONPATH=<b> python3 tools/stream1_compat.py compare F.npz
    env PYTHONPATH=<a> python3 tools/stream1_compat.py export-pt2 F.pt2
    env PYTHONPATH=<b> python3 tools/stream1_compat.py run-pt2 F.pt2

``PYTHONPATH`` names the checkout whose ``qbold_vi_tpu_torch`` is imported
(e.g. the parent commit unpacked by ``git archive`` into a git-ignored
directory, and this one).

* ``save`` / ``compare``: kernel B's (means, vars, raw) and kernel C's q
  on a 1,032,192-voxel request (seeded uniform signals, a random mask
  channel), both input layouts, at each trunk of ``COMPAT``: OPTIMAL in
  both trunks (the resident kernels), 256 units x 2 blocks in bf16 (the
  streamed bf16 kernels), 256 x 2, 100 x 2 and 60 x 7 in float32 (the wgmma
  kernels), 320 x 2 (the chunked kernels), 448 x 1 and 768 x 1 in
  float32 (the split kernels), 833 x 1 and 1280 x 1 (the cluster kernels
  of one product a block) and, on dense scans (``COMPAT_TAUS``), 768 x 1
  on 51 taus, 256 x 2 and 1472 x 1 on 128 taus (the split, wgmma and
  cluster kernels with the staged rows in the activation rows) --
  ``init_params`` seed 0 -- from checkout a; then b's, held bit for bit
  against them (exit 1 if any differs). A shape whose plan b changed is
  not among them (320 x 2 on 330 taus, streamed until the chunked kernels
  took it with the rows staged a window of k-steps at a time; 768 x 1 on
  51 taus before the shared rows came).
* ``export-pt2`` / ``run-pt2``: a's fused serving ``.pt2`` of each trunk of
  ``PT2``: bf16 at OPTIMAL (F.pt2), float32 at 100 x 2 (F-f32-100x2.pt2),
  at 320 x 2 (F-f32-320x2.pt2), at 448 x 1 (F-f32-448x1.pt2), at 833 x 1
  (F-f32-833x1.pt2) and at 1281 x 1 (F-f32-1281x1.pt2: widths whose
  float32 design b may have changed), run by b and held bit for bit
  against b's kernel B on the same rows: an artifact of a's weight-blob
  layout still runs on b's op.

Prints the package each step imported. Needs one CUDA card.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

import qbold_vi_tpu_torch
from qbold_vi_tpu_torch import OPTIMAL, FineTuner, init_params
from qbold_vi_tpu_torch.io import export_model as em
from qbold_vi_tpu_torch.ops import fused_infer as fi

N = 14 * 96 * 96 * 8
PT2_SHAPE = (1, 24, 20, 4)
# (trunk, units, blocks): the kernels whose outputs must not move
COMPAT = (("float32", 60, 2), ("bfloat16", 60, 2), ("bfloat16", 256, 2),
          ("float32", 256, 2), ("float32", 100, 2), ("float32", 60, 7),
          ("float32", 320, 2), ("float32", 448, 1), ("float32", 768, 1),
          ("float32", 833, 1), ("float32", 1280, 1))
# (tau_step, ((trunk, units, blocks), ...)): on scans of 51 and 128 taus
COMPAT_TAUS = ((0.0016, (("float32", 768, 1),)),
               (0.000635, (("float32", 256, 2), ("float32", 1472, 1))))
# (trunk, units, blocks, the artifact's suffix)
PT2 = (("bfloat16", 60, 2, ""), ("float32", 100, 2, "-f32-100x2"),
       ("float32", 320, 2, "-f32-320x2"),
       ("float32", 448, 1, "-f32-448x1"), ("float32", 833, 1, "-f32-833x1"),
       ("float32", 1281, 1, "-f32-1281x1"))


def tuner(trunk: str, units: int = 60, blocks: int = 2,
          scan=OPTIMAL.scan) -> FineTuner:
    cfg = dataclasses.replace(OPTIMAL.model, compute_dtype=trunk,
                              no_units=units, no_intermediate_layers=blocks)
    t = FineTuner(cfg, scan, device="cuda")
    t.load_state_dict(init_params(cfg, scan,
                                  torch.Generator().manual_seed(0)))
    return t


def kernel_b(t, x, trunk, layout, scan=OPTIMAL.scan):
    cfg = t.cfg
    return fi.encode_quad_fused(
        x, t.encoder, se_idx=scan.se_idx, multi_image=False,
        activation=cfg.activation, n_blocks=cfg.no_intermediate_layers,
        trunk=trunk, mvg=cfg.use_mvg, oef_range=cfg.oef_range,
        min_oef=cfg.min_oef, dbv_range=cfg.dbv_range, min_dbv=cfg.min_dbv,
        dw_coeff=float(scan.dw_coeff * scan.hct), mask_channel=True,
        input_layout=layout)


def outputs() -> dict:
    out = {}
    scans = [(OPTIMAL.scan, COMPAT)] + [
        (dataclasses.replace(OPTIMAL.scan, tau_step=step), trunks)
        for step, trunks in COMPAT_TAUS]
    for scan, trunks in scans:
        rng = np.random.default_rng(0)
        x = rng.uniform(50, 150, size=(N, scan.n_taus + 1)).astype(
            np.float32)
        x[:, -1] = rng.uniform(size=N) > 0.2
        x = torch.from_numpy(x).cuda()
        for trunk, units, blocks in trunks:
            t = tuner(trunk, units, blocks, scan)
            for layout in ("voxel", "channel"):
                xi = x if layout == "voxel" else x.T.contiguous()
                b = kernel_b(t, xi, trunk, layout, scan)
                q = fi.encode_q1_packed(
                    xi, t.encoder, se_idx=scan.se_idx, multi_image=False,
                    activation=t.cfg.activation,
                    n_blocks=t.cfg.no_intermediate_layers, trunk=trunk,
                    mask_channel=True, input_layout=layout)
                tag = (trunk if (units, blocks) == (60, 2)
                       else f"{trunk}-{units}x{blocks}")
                if scan is not OPTIMAL.scan:
                    tag += f"-t{scan.n_taus}"
                for k, v in zip(("means", "vars", "raw", "q"),
                                list(b) + [q]):
                    out[f"{tag}-{layout}-{k}"] = v.cpu().numpy()
    return out


def pt2_path(path: str, suffix: str) -> str:
    return path[:-4] + suffix + ".pt2" if path.endswith(".pt2") else \
        path + suffix


def main() -> int:
    if len(sys.argv) != 3 or not torch.cuda.is_available():
        print(__doc__)
        return 1
    mode, path = sys.argv[1:]
    print(f"package {qbold_vi_tpu_torch.__file__}", flush=True)
    if mode == "save":
        np.savez(path, **outputs())
        return 0
    if mode == "compare":
        got = outputs()
        with np.load(path) as ref:
            same = {k: bool(np.array_equal(ref[k], v)) for k, v in got.items()}
        print(f"bit-equal: {same}")
        return 0 if all(same.values()) else 1
    if mode == "export-pt2":
        for trunk, units, blocks, suffix in PT2:
            em.save_exported(em.export_inference(
                tuner(trunk, units, blocks), fused=True, platforms=("cuda",),
                example_shape=PT2_SHAPE), pt2_path(path, suffix))
            print(f"exported {pt2_path(path, suffix)}")
        return 0
    if mode == "run-pt2":
        rng = np.random.default_rng(1)
        x = torch.from_numpy(rng.uniform(
            50, 150, size=(12, int(np.prod(PT2_SHAPE)))).astype(
                np.float32)).cuda()
        ok = True
        for trunk, units, blocks, suffix in PT2:
            got = em.load_exported(pt2_path(path, suffix))(x)
            ref = kernel_b(tuner(trunk, units, blocks), x, trunk, "channel")
            same = {k: bool(torch.equal(got[k], r)) for k, r in
                    zip(("means", "stds", "raw_log_stds"), ref)}
            print(f"the {trunk} {units} x {blocks} .pt2 against this "
                  f"package's kernel B, bit-equal: {same}")
            ok = ok and all(same.values())
        return 0 if ok else 1
    print(__doc__)
    return 1


if __name__ == "__main__":
    sys.exit(main())
