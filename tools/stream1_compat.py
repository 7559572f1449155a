"""Kernels B and C of two checkouts of the port, compared on the card.

    env PYTHONPATH=<a> python3 tools/stream1_compat.py save F.npz
    env PYTHONPATH=<b> python3 tools/stream1_compat.py compare F.npz
    env PYTHONPATH=<a> python3 tools/stream1_compat.py export-pt2 F.pt2
    env PYTHONPATH=<b> python3 tools/stream1_compat.py run-pt2 F.pt2

``PYTHONPATH`` names the checkout whose ``qbold_vi_tpu_torch`` is imported
(e.g. the parent commit unpacked by ``git archive`` into a git-ignored
directory, and this one).

* ``save`` / ``compare``: kernel B's (means, vars, raw) and kernel C's q
  at OPTIMAL (``init_params`` seed 0) on a 1,032,192-voxel request (seeded
  uniform signals, a random mask channel), both trunks and both input
  layouts, from checkout a; then b's, held bit for bit against them (exit
  1 if any differs).
* ``export-pt2`` / ``run-pt2``: a's fused bf16 serving ``.pt2`` at
  OPTIMAL, run by b and held bit for bit against b's kernel B on the same
  rows: an artifact of a's weight-blob layout still runs on b's op.

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


def tuner(trunk: str) -> FineTuner:
    cfg = dataclasses.replace(OPTIMAL.model, compute_dtype=trunk)
    t = FineTuner(cfg, OPTIMAL.scan, device="cuda")
    t.load_state_dict(init_params(cfg, OPTIMAL.scan,
                                  torch.Generator().manual_seed(0)))
    return t


def kernel_b(t, x, trunk, layout):
    cfg, scan = t.cfg, OPTIMAL.scan
    return fi.encode_quad_fused(
        x, t.encoder, se_idx=scan.se_idx, multi_image=False,
        activation=cfg.activation, n_blocks=cfg.no_intermediate_layers,
        trunk=trunk, mvg=cfg.use_mvg, oef_range=cfg.oef_range,
        min_oef=cfg.min_oef, dbv_range=cfg.dbv_range, min_dbv=cfg.min_dbv,
        dw_coeff=float(scan.dw_coeff * scan.hct), mask_channel=True,
        input_layout=layout)


def outputs() -> dict:
    rng = np.random.default_rng(0)
    x = rng.uniform(50, 150, size=(N, 12)).astype(np.float32)
    x[:, -1] = rng.uniform(size=N) > 0.2
    x = torch.from_numpy(x).cuda()
    out = {}
    for trunk in ("float32", "bfloat16"):
        t = tuner(trunk)
        for layout in ("voxel", "channel"):
            xi = x if layout == "voxel" else x.T.contiguous()
            b = kernel_b(t, xi, trunk, layout)
            q = fi.encode_q1_packed(
                xi, t.encoder, se_idx=OPTIMAL.scan.se_idx, multi_image=False,
                activation=t.cfg.activation,
                n_blocks=t.cfg.no_intermediate_layers, trunk=trunk,
                mask_channel=True, input_layout=layout)
            for k, v in zip(("means", "vars", "raw", "q"), list(b) + [q]):
                out[f"{trunk}-{layout}-{k}"] = v.cpu().numpy()
    return out


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
    t = tuner("bfloat16")
    if mode == "export-pt2":
        em.save_exported(em.export_inference(
            t, fused=True, platforms=("cuda",), example_shape=PT2_SHAPE),
            path)
        print(f"exported {path}")
        return 0
    if mode == "run-pt2":
        rng = np.random.default_rng(1)
        x = torch.from_numpy(rng.uniform(
            50, 150, size=(12, int(np.prod(PT2_SHAPE)))).astype(
                np.float32)).cuda()
        got = em.load_exported(path)(x)
        ref = kernel_b(t, x, "bfloat16", "channel")
        same = {k: bool(torch.equal(got[k], r)) for k, r in
                zip(("means", "stds", "raw_log_stds"), ref)}
        print(f"the .pt2 against this package's kernel B, bit-equal: {same}")
        return 0 if all(same.values()) else 1
    print(__doc__)
    return 1


if __name__ == "__main__":
    sys.exit(main())
