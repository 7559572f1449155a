"""Kernel C's bf16 trunk on deep narrow trunks: how far the kernel and its
plain version each lie from a float64 replay of the same bf16 rounding
points.

    env PYTHONPATH=. python3 tools/bf16_drift.py [--voxels N]
        [--units U] [--blocks 8,16,32] [--acts softplus,relu]

Run it from the repository's root on a machine with the card. For each
activation and depth, a trunk of U units (30: the resident kernel
csrc/encode_quad_bf16.cu) with ``init_params`` weights (seed = the
blocks), on N voxels of seeded signals (``chip_smoke.volumes``, with a
mask channel), computes q (5, N) three ways:

* the kernel: ``fused_infer.encode_q1_packed`` at trunk="bfloat16";
* the plain version: ``fused_infer.encode_q_plain`` on the card (bf16
  tensors, float32 sums of each layer's products);
* the replay: the plain version's float32 normalised rows rounded to
  bf16, each layer's products summed in float64 and rounded to bf16, the
  bf16 bias added in float64 and rounded to bf16, the activation's steps
  (``models/encoder.py::_STEPS``, jax.nn's compositions) each computed in
  float64 and rounded to bf16; the float32 head in float64.

The replay rounds where both round; what it leaves out is each one's own
float32 arithmetic between those points (the order of a layer's float32
sum, the float32 exp / log1p). For each pair it prints the largest
difference of q in bf16 ulps of q's largest magnitude (the tests' gate,
``chip_smoke.ulp_err``), the mean difference in the same ulps, and the
share of the last layer's features whose bf16 value differs from the
replay's (the plain version and the replay only: the kernel keeps its
features on chip). A kernel much farther from the replay than the plain
version is a fault of the kernel; both at the same distance is rounding
flips carried through depth. Needs one CUDA card; ~1 minute.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import bf16_ulp, gpu_line, volumes  # noqa: E402
from qbold_vi_tpu_torch import OPTIMAL, FineTuner, init_params  # noqa: E402
from qbold_vi_tpu_torch.models.encoder import normalise_data  # noqa: E402
from qbold_vi_tpu_torch.ops import fused_infer as fi  # noqa: E402


def bf(v: torch.Tensor) -> torch.Tensor:
    """v rounded to bf16 (nearest even), kept as float64."""
    return v.to(torch.bfloat16).double()


def act_f64(name: str, x: torch.Tensor) -> torch.Tensor:
    """jax.nn's bf16 composition of the activation on a bf16-valued x,
    each step in float64 then rounded to bf16."""
    if name == "relu":
        return torch.clamp(x, min=0.0)
    if name == "softplus":
        e = bf(torch.exp(-x.abs()))
        return bf(torch.clamp(x, min=0.0) + bf(torch.log1p(e)))
    raise ValueError(f"no float64 replay of {name!r}")


def replay_q(x, encoder, *, se_idx, activation, n_blocks):
    """q (5, N) by the float64 replay of the bf16 rounding points."""
    wfc, bfc, wb, bb, wf, bfh = fi._stream1_weights(encoder, n_blocks)
    h = normalise_data((x[:, :-1] * x[:, -1:]).float(), se_idx, False).T
    h = bf(h)                                           # (T, N)
    wfc, wb = bf(wfc), bf(wb)
    bfc, bb = bf(bfc), bf(bb)

    def layer(w, b, h):
        return act_f64(activation, bf(bf(w @ h) + b))

    h = layer(wfc, bfc, h)
    for i in range(n_blocks):
        h = layer(wb[i], bb[i], h)
    return wf.double() @ h + bfh.double(), h


def plain_features(x, encoder, *, se_idx, activation, n_blocks):
    """The plain version's last-layer bf16 features (U, N)."""
    wfc, bfc, wb, bb, _, _ = fi._stream1_weights(encoder, n_blocks)
    dt = torch.bfloat16
    act = fi.activation_fn(activation, dt)
    h = normalise_data((x[:, :-1] * x[:, -1:]).float(), se_idx, False).T
    h = act(fi._mm_bf16(wfc.to(dt), h.to(dt)) + bfc.to(dt))
    for i in range(n_blocks):
        h = act(fi._mm_bf16(wb[i].to(dt), h) + bb[i].to(dt))
    return h.double()


def ulps(got, ref) -> tuple:
    ulp = bf16_ulp(ref)
    d = (got.double() - ref).abs()
    return float(d.max()) / ulp, float(d.mean()) / ulp


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this tool needs the card")
        return 1
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--voxels", type=int, default=200_003)
    ap.add_argument("--units", type=int, default=30)
    ap.add_argument("--blocks", default="8,16,32")
    ap.add_argument("--acts", default="softplus,relu")
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    scan = OPTIMAL.scan
    x = torch.from_numpy(volumes(np.random.default_rng(20), (args.voxels,),
                                 scan.n_taus)).to(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        for act in args.acts.split(","):
            for nb in map(int, args.blocks.split(",")):
                cfg = dataclasses.replace(
                    OPTIMAL.model, no_units=args.units,
                    no_intermediate_layers=nb, activation=act,
                    compute_dtype="bfloat16")
                t = FineTuner(cfg, scan, device=dev)
                t.load_state_dict(init_params(
                    cfg, scan, torch.Generator().manual_seed(nb)))
                kw = dict(se_idx=scan.se_idx, multi_image=False,
                          activation=act, n_blocks=nb, trunk="bfloat16",
                          mask_channel=True, input_layout="voxel")
                design = fi._plan(fi._padded_width(args.units), nb,
                                  scan.n_taus, scan.n_taus + 1, "bfloat16",
                                  False, dev).design
                q_k = fi.encode_q1_packed(x, t.encoder, **kw)
                q_p = fi.encode_q_plain(x, t.encoder, **kw)
                q64, h64 = replay_q(x, t.encoder, se_idx=scan.se_idx,
                                    activation=act, n_blocks=nb)
                hp = plain_features(x, t.encoder, se_idx=scan.se_idx,
                                    activation=act, n_blocks=nb)
                torch.cuda.synchronize()
                k64, p64 = ulps(q_k, q64), ulps(q_p, q64)
                kp = ulps(q_k, q_p.double())
                moved = float((hp != h64).double().mean())
                print(f"{act} {args.units} x {nb} ({design}, N="
                      f"{args.voxels}): q in bf16 ulps of its scale, largest "
                      f"/ mean: kernel vs replay {k64[0]:.2f} / {k64[1]:.4f}"
                      f", plain vs replay {p64[0]:.2f} / {p64[1]:.4f}, "
                      f"kernel vs plain {kp[0]:.2f} / {kp[1]:.4f}; last "
                      f"layer's features where plain and replay differ "
                      f"{100 * moved:.2f}%", flush=True)
    print(gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
