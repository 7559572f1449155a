"""Time kernel S (qbold_vi_tpu_torch/csrc/synth_batch.cu), pass by pass, on
OPTIMAL's streaming batch and at P = 4 trials, with each build's errors
against the plain version fed the replayed draws and its registers, spills
and shared memory.

    python3 tools/bench_synth_batch.py [--package DIR] [--only-copies]
        [SRC ...]

Run it from the repository's root on a machine with the card, as
``env PYTHONPATH=. python3 tools/bench_synth_batch.py _chip_checkout/<tag>/
synth_batch.cu ...``, with the edited copies in a git-ignored directory.

Builds the package's kernels (``ops/_cuda.library``) and, for each further
source given -- an edited copy of ``csrc/synth_batch.cu`` with the
package's C entries (``qv_synth_grid``, ``qv_synth_batch``,
``qv_synth_batch_trials``) -- a library of that file alone with the same
nvcc flags and ``-I csrc``, all compiles started at once (a copy's own
directory first on the include path, so an edited ``elbo_math.cuh``
beside it replaces the package's). A copy is launched with the package
wrapper's operands (``ops/synth_batch.py``). ``--package DIR`` imports
``qbold_vi_tpu_torch`` from DIR instead of this checkout and times that
package through its own wrapper (``synth_batch``) -- the way to time
another commit's S, e.g. the parent's unpacked by ``git archive`` into
``_chip_checkout/parent``; copies are not taken then. ``--only-copies``
times the given sources alone.

The batch is OPTIMAL's: 512 pseudo-volumes of 10 x 10 x 5 (256,000
voxels), 11 taus, the surrogate decode, noise on; and P = 4 such batches
under four seeds in one launch of each pass. Per build it prints:

* x and y against the plain version (``train/steps.py::
  stream_synthetic_batch``) fed the draws' host replay
  (``ops/synth_batch.py::synth_philox_draws``), whether a seed replays
  bit for bit, and whether each trial of the P = 4 launch is bit-equal to
  its one-trial launch;
* device ms by the profiler (median of 21 calls after warm-up,
  ``chip_smoke.kernel_ms``) of pass 1 (``qv_synth_batch_kernel``) and the
  noise pass (``qv_synth_noise_kernel``) and their sum, at one trial and
  at P = 4, and ms a call by CUDA events;
* ptxas's registers, stack and spills, and static shared memory, of both
  kernels (``--resource-usage``), beside the function's bound and this
  design's bytes (``chip_smoke.synth_bound``).

Needs one CUDA card; about a minute with a few copies.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", default=None,
                    help="import qbold_vi_tpu_torch from this directory "
                    "and time its S through its own wrapper")
    ap.add_argument("--only-copies", action="store_true",
                    help="time the given sources alone")
    ap.add_argument("sources", nargs="*",
                    help="edited copies of csrc/synth_batch.cu")
    return ap.parse_args()


ARGS = parse_args() if __name__ == "__main__" else None
sys.path.insert(0, str(ROOT))
if ARGS is not None and ARGS.package:
    sys.path.insert(0, str(Path(ARGS.package).resolve()))

import ctypes  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (cuda_ms, gpu_line, kernel_ms,  # noqa: E402
                        synth_bound)
from qbold_vi_tpu_torch import OPTIMAL  # noqa: E402
from qbold_vi_tpu_torch.ops import _cuda  # noqa: E402
from qbold_vi_tpu_torch.ops import synth_batch as sb  # noqa: E402
from qbold_vi_tpu_torch.train import steps  # noqa: E402

SYMBOLS = ("qv_synth_batch_kernel", "qv_synth_noise_kernel")
SEEDS = (11, 2 ** 40 + 3, 977, 12345)
ENTRIES = ("qv_synth_grid", "qv_synth_batch", "qv_synth_batch_trials")


def build_variants(paths):
    """{name: (ctypes library, nvcc log)} of each source, built with the
    port's flags."""
    out_dir = _cuda.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for path in map(Path, paths):
        name = f"{path.parent.name}/{path.stem}"
        so = out_dir / f"{path.parent.name}_{path.stem}.so"
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, f"-I{path.resolve().parent}",
               f"-I{_cuda.CSRC}", "-shared", "-o", str(so), str(path)]
        procs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn in ENTRIES:
            getattr(lib, fn).argtypes = _cuda._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, log)
    return libs


def resources(log: str) -> str:
    """Registers, stack / spills and static shared memory of S's kernels
    from ptxas's --resource-usage report."""
    out, lines = [], log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Function properties for \S*?(qv_synth_\w+_kernel)",
                      line)
        if m and i + 2 < len(lines):
            regs = re.search(r"Used (\d+) registers", lines[i + 2])
            smem = re.search(r"(\d+) bytes smem", lines[i + 2])
            out.append(f"{m.group(1)} {regs.group(1) if regs else '?'} "
                       f"registers, {lines[i + 1].strip()}, "
                       f"{smem.group(1) if smem else 0} B static shared")
    return "; ".join(out)


def copy_call(lib, cfg, b, seed=None, seeds=None, device=None):
    """The package wrapper's launch (ops/synth_batch.py::synth_batch) with
    another build's C entries."""
    scan = cfg.scan
    n = b * 500
    p_n = 1 if seeds is None else len(seeds)
    lead = () if seeds is None else (p_n,)
    C = sb.synth_decode_consts(cfg)
    table = C.device_table(device)
    x = torch.empty(lead + (b, 10, 10, 5, scan.n_taus), device=device)
    y = torch.empty(lead + (b, 10, 10, 5, 3), device=device)
    partial = torch.empty((p_n, lib.qv_synth_grid(n) + 1, scan.n_taus),
                          device=device, dtype=torch.float64)
    prof = sb._profile(scan.n_taus, device)
    consts = sb.synth_consts(cfg)
    stream = torch.cuda.current_stream(device).cuda_stream
    tickets = sb._tickets(device, stream, p_n)
    if seeds is None:
        err = lib.qv_synth_batch(n, C.struct(), table.data_ptr(),
                                 table.numel(), consts, seed, x.data_ptr(),
                                 y.data_ptr(), partial.data_ptr(),
                                 tickets.data_ptr(), prof.data_ptr(), stream)
    else:
        words = np.array(seeds, np.uint64).view(np.int64)
        keys = torch.from_numpy(words).to(device)
        err = lib.qv_synth_batch_trials(
            n, p_n, C.struct(), table.data_ptr(), table.numel(), consts,
            keys.data_ptr(), x.data_ptr(), y.data_ptr(), partial.data_ptr(),
            tickets.data_ptr(), prof.data_ptr(), stream)
    _cuda.check(err, "synthetic batch")
    return {"x": x, "y": y}


def bench(name, call, cfg, dev, log) -> None:
    b, t = cfg.train.pt_batch_size, cfg.scan.n_taus
    n = b * 500
    one = lambda: call(cfg, b, seed=SEEDS[0], device=dev)        # noqa: E731
    four = lambda: call(cfg, b, seeds=list(SEEDS), device=dev)   # noqa: E731
    got, again, trials = one(), one(), four()
    torch.cuda.synchronize()
    dd = sb.synth_philox_draws(SEEDS[0], n, t)
    ref = steps.stream_synthetic_batch(cfg, b, dd, device=dev)
    err = max(float((got[k] - ref[k]).abs().max()) for k in ("x", "y"))
    replays = all(torch.equal(got[k], again[k]) for k in ("x", "y"))
    singles = [call(cfg, b, seed=s, device=dev) for s in SEEDS]
    torch.cuda.synchronize()
    bit_equal = all(torch.equal(trials[k][j], singles[j][k])
                    for j in range(len(SEEDS)) for k in ("x", "y"))
    print(f"{name}: x, y vs plain on the replayed draws {err:.3e} (gate "
          f"1e-5 rtol / atol), seed replays {replays}, P = 4 trials equal "
          f"their single launches {bit_equal}; {resources(log)}", flush=True)
    rows = []
    for label, fn, p_n in (("one trial", one, 1), ("P = 4", four, 4)):
        parts = {s: kernel_ms(fn, s, 21, need=4) for s in SYMBOLS}
        total = sum(parts.values())
        fb = synth_bound(p_n * n, t, cfg.synth.misalign_prob > 0.0)
        design = synth_bound(p_n * n, t, cfg.synth.misalign_prob > 0.0,
                             "design")["bound_ms"]
        rows.append(f"{label} at {p_n * n:,} voxels: pass 1 "
                    f"{parts[SYMBOLS[0]]:.4f}, noise pass "
                    f"{parts[SYMBOLS[1]]:.4f}, {total:.4f} ms on the device "
                    f"({cuda_ms(fn):.4f} a call); bound "
                    f"{fb['bound_ms']:.5f} ({fb['bound_by']}, "
                    f"{100 * fb['bound_ms'] / total:.1f}%), this design's "
                    f"bytes {design:.5f}")
    print(f"{name} ms: " + "; ".join(rows), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this bench needs the card")
        return 1
    args = ARGS
    dev = torch.device("cuda", 0)
    print(f"card: {gpu_line()}", flush=True)
    cfg = OPTIMAL
    with torch.no_grad():
        if not args.only_copies:
            _cuda.library()
            bench(f"package ({Path(sb.__file__).resolve().parent.parent})",
                  sb.synth_batch, cfg, dev, _cuda.build_log())
        if args.package:
            return 0
        for name, (lib, log) in build_variants(args.sources).items():
            bench(name, lambda *a, lib=lib, **k: copy_call(lib, *a, **k),
                  cfg, dev, log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
