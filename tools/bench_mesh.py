"""Certify and time the data-parallel layer on ``--ranks`` ranks of the
cards of one machine.

    python3 tools/bench_mesh.py [--ranks N] [--time-steps 100]

Run it from the repository's root on a machine with the card. It builds
the package's kernels, then runs ``parallel.multihost.certify(N,
width="optimal", device="cuda")``: N spawned ranks (NCCL when each has a
card of its own, gloo on CUDA tensors when they share one) against this
process alone, every metric bit-equal across ranks and the host-draw
stages and maps within rtol 2e-5 of one process. The fine-tune epoch on
the device's draws is timed the same way sharded and unsharded: a warm
epoch, then one of ``--time-steps`` steps whose wall a step is reported
(the crop sampling included), the sharded one on every rank with its 38 /
N crops and the unsharded one on all 38 here. The all-reduces a step are
timed on a third sharded epoch, the device synchronised around each.

Prints the card's name and power limit (``nvidia-smi``), the build's and
the certification's seconds, and certify's JSON on the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    import torch

    from qbold_vi_tpu_torch.ops import _cuda
    from qbold_vi_tpu_torch.parallel import multihost

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=None,
                   help="ranks to certify (default: one a card)")
    p.add_argument("--time-steps", type=int, default=100)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    _cuda.library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    ranks = args.ranks or torch.cuda.device_count()
    print(f"cards {torch.cuda.device_count()}, ranks {ranks}; torch "
          f"{torch.__version__}", flush=True)
    t0 = time.perf_counter()
    out = multihost.certify(ranks, device="cuda", width="optimal",
                            time_steps=args.time_steps, timeout_s=600)
    print(f"certify({ranks}) {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
