"""Time kernel F (qbold_vi_tpu_torch/csrc/fused_elbo.cu) forward and
backward at the fine-tune fold, with each build's error against the plain
version and its registers, spills and stack frame.

    python3 tools/bench_fused_elbo.py [--only-copies] [variant.cu ...]

Builds the package's kernels (``ops/_cuda.library``) and, for each further
source given -- an edited copy of ``csrc/fused_elbo.cu`` with the same C
entries, or a copy of an earlier version of it -- a library of that file
alone with the same nvcc flags and ``-I csrc``, all compiles started at
once (a copy's own directory comes first on the include path, so an
edited ``elbo_math.cuh`` beside it replaces the package's).
``--only-copies`` times the given sources alone, not the package's F.

The fold is OPTIMAL's: 190,000 voxels (38 crops of 25 x 25 x 8), MVG,
Student-t df 200, 11 taus, s_nll 1, s_kl 70, a mask with 20% of the voxels
dead at random, q and p rows with logit stds clear of the KL clamp. Each
case is timed by CUDA events (median of 7 blocks of 20 calls after 3
warm-up calls) and by the profiler (median device time of the kernel over
21 calls, ``chip_smoke.kernel_ms``):

* ``device`` / ``host``: device noise (Philox) / host normals, the
  backward from the forward's KL state (``+state``) and without it
  (replaying every draw);
* ``s_kl0``: no KL draws, the NLL side alone;
* ``live``: only the live voxels, all unmasked;
* ``dead``: every voxel masked (a build that skips dead voxels writes
  zeros and draws nothing);
* ``3% clamped``: the backward from the state with one voxel in 33 past
  the KL clamp (replayed).

It prints the rows' and gradients' largest errors against the plain
version (host noise; device noise against the plain version fed
``philox_normals``), the share of voxels whose KL draws clamp, and the
card's name and power limit. Needs one CUDA card; about a minute with
three variants.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import cuda_ms, gpu_line, kernel_ms  # noqa: E402
from qbold_vi_tpu_torch import OPTIMAL  # noqa: E402
from qbold_vi_tpu_torch.ops import _cuda  # noqa: E402
from qbold_vi_tpu_torch.ops import decode_nll as dn  # noqa: E402
from qbold_vi_tpu_torch.ops import fused_elbo as fe  # noqa: E402

N, S_NLL, S_KL, SEED = 38 * 25 * 25 * 8, 1, 70, 11


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
        libs[name] = (bind(ctypes.CDLL(str(so))), log)
    return libs


def bind(lib):
    for fn in ("qv_elbo_fwd", "qv_elbo_bwd"):
        getattr(lib, fn).argtypes = _cuda._SIGNATURES[fn]
    return lib


def resources(log: str) -> dict:
    """{kernel: (registers, 'stack / spill' text)} of F's kernels from
    ptxas's --resource-usage report."""
    out = {}
    lines = log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Function properties for \S*(qv_elbo_(fwd|bwd)_kernel)",
                      line)
        if m:
            frame = lines[i + 1].strip()
            regs = re.search(r"Used (\d+) registers", lines[i + 2])
            out[m.group(2)] = (int(regs.group(1)) if regs else -1, frame)
    return out


def inputs(dev):
    rng = np.random.default_rng(5)
    f = np.float32
    mask = (rng.uniform(size=N) > 0.2).astype(f)
    q = rng.normal(size=(N, 5)) * 0.7
    p = rng.normal(size=(N, 5)) * 0.7
    q[:, [1, 3]] *= 0.3                # logit stds clear of the KL clamp
    p[:, [1, 3]] *= 0.3
    y = (np.abs(rng.normal(size=(N, 11))) * 50 + 100) * mask[:, None]
    a = dict(q=q, p=p, y=y, sigma=rng.uniform(0.03, 0.2, (N, 11)), mask=mask,
             ct_n=rng.normal(size=N), ct_k=rng.normal(size=N))
    a = {k: torch.from_numpy(np.ascontiguousarray(v, f)).to(dev)
         for k, v in a.items()}
    z = torch.from_numpy(fe.philox_normals(SEED, N, S_NLL + S_KL)).to(dev)
    a["zn"], a["zk"] = z[:S_NLL].contiguous(), z[S_NLL:].contiguous()
    return a


class Calls:
    """The C entries of one build with fixed arguments."""

    def __init__(self, lib, a, C, n=N, s_kl=S_KL):
        self.lib, self.a, self.n, self.s_kl = lib, a, n, s_kl
        self.C, self.table = C.struct(), C.device_table(a["q"].device)
        self.stream = torch.cuda.current_stream().cuda_stream
        dev = a["q"].device
        self.nll, self.kl = (torch.empty(n, device=dev) for _ in range(2))
        self.state = torch.empty(n, 6, device=dev)
        self.dq, self.dp = (torch.empty(n, 5, device=dev) for _ in range(2))
        self.dsig, self.dy = (torch.empty(n, 11, device=dev) for _ in range(2))
        # the wrappers' grids (ops/fused_elbo.py)
        self.grids = (dn._grid(n), dn._grid(fe._BWD_LANES * n))

    def noise(self, host):
        a = self.a
        return ((a["zn"].data_ptr(), a["zk"].data_ptr(), 0, 0) if host
                else (None, None, SEED, 0))

    def fwd(self, host=False, state=True):
        a = self.a
        args = [a[k].data_ptr() for k in ("q", "p", "y", "sigma", "mask")]
        args += [*self.noise(host), self.n, 1, S_NLL, self.s_kl, self.C,
                 self.table.data_ptr(), self.table.numel(),
                 self.nll.data_ptr(), self.kl.data_ptr(),
                 self.state.data_ptr() if state else None]
        err = self.lib.qv_elbo_fwd(*args, self.grids[0], self.stream)
        if err:
            raise RuntimeError(f"forward launch failed ({err})")

    def bwd(self, host=False, state=False):
        a = self.a
        args = [a[k].data_ptr() for k in ("q", "p", "y", "sigma", "mask")]
        args += [*self.noise(host), self.n, 1, S_NLL, self.s_kl,
                 a["ct_n"].data_ptr(), a["ct_k"].data_ptr(),
                 self.state.data_ptr() if state else None, self.C, self.table.data_ptr(), self.table.numel(),
                 self.dq.data_ptr(), self.dp.data_ptr(), self.dsig.data_ptr(),
                 self.dy.data_ptr()]
        err = self.lib.qv_elbo_bwd(*args, self.grids[1], self.stream)
        if err:
            raise RuntimeError(f"backward launch failed ({err})")


def errors(calls: Calls, a, C) -> str:
    """Largest errors of the rows (absolute) and of the gradients (over
    the largest reference entry) against the plain version, both noise
    modes, the backward with and without the state."""
    main = tuple(a[k] for k in ("q", "p", "y", "sigma", "mask"))
    ref_rows = fe.elbo_rows_plain(*main, a["zn"], a["zk"], C, True)
    ref_g = fe.elbo_grads_plain(*main, a["zn"], a["zk"], a["ct_n"],
                                a["ct_k"], C, True)
    out = []
    for host in (True, False):
        calls.fwd(host)
        torch.cuda.synchronize()
        rows = max(float((x - r).abs().max())
                   for x, r in zip((calls.nll, calls.kl), ref_rows))
        # chip_smoke's gates: rtol 1e-5 / atol 1e-5 with host normals,
        # rtol 1e-4 / atol 1e-4 against philox_normals
        tol = 1e-5 if host else 1e-4
        gate = all(bool(((x - r).abs() <= tol + tol * r.abs()).all())
                   for x, r in zip((calls.nll, calls.kl), ref_rows))
        grads = 0.0
        for state in (False, True):
            calls.bwd(host, state)
            torch.cuda.synchronize()
            grads = max(grads, max(
                float((x - r).abs().max() / r.abs().max().clamp(min=1e-8))
                for x, r in zip((calls.dq, calls.dp, calls.dy, calls.dsig),
                                ref_g)))
        out.append(f"{'host' if host else 'device'} rows {rows:.2e} "
                   f"({'within' if gate else 'OUTSIDE'} the gate) "
                   f"grads {grads:.2e}")
    flagged = float((calls.state[:, 5] != 0).float().mean())
    out.append(f"clamped voxels {100 * flagged:.2f}%")
    return "; ".join(out)


def timed(label: str, fn, symbol: str) -> str:
    return (f"{label} {kernel_ms(fn, symbol):.4f} "
            f"({cuda_ms(fn, reps=20):.4f})")


def bench(name, lib, log, a, C) -> None:
    res = resources(log)
    print(f"{name}: " + "; ".join(f"{k} {r} registers, {s}"
                                  for k, (r, s) in sorted(res.items())),
          flush=True)
    main = Calls(lib, a, C)
    print(f"{name} vs plain: {errors(main, a, C)}", flush=True)
    fs, bs = "qv_elbo_fwd_kernel", "qv_elbo_bwd_kernel"
    rows = []
    for host in (False, True):
        tag = "host" if host else "device"
        rows.append(timed(f"fwd {tag}", lambda: main.fwd(host), fs))
        rows.append(timed(f"bwd {tag}", lambda: main.bwd(host), bs))
        main.fwd(host)
        rows.append(timed(f"bwd {tag}+state", lambda: main.bwd(host, True),
                          bs))
    # one voxel in 33 past the KL clamp (chip_smoke's encoder rows have
    # ~2.6% of their voxels clamped)
    q = a["q"].clone()
    q[::33, 0] = C.scalars["kl_bound"] + 1.0
    cl = Calls(lib, dict(a, q=q), C)
    cl.fwd()
    rows.append(timed("bwd device+state 3% clamped",
                      lambda: cl.bwd(state=True), bs))
    nkl = Calls(lib, a, C, s_kl=0)
    rows.append(timed("fwd s_kl0", lambda: nkl.fwd(state=False), fs))
    rows.append(timed("bwd s_kl0", nkl.bwd, bs))
    keep = a["mask"] > 0
    live = {k: (v[keep].contiguous() if v.shape[0] == N else
                v[:, keep].contiguous()) for k, v in a.items()}
    lc = Calls(lib, live, C, n=int(keep.sum()))
    rows.append(timed("fwd live", lc.fwd, fs))
    lc.fwd()
    rows.append(timed("bwd live", lambda: lc.bwd(state=True), bs))
    dead = dict(a, mask=torch.zeros_like(a["mask"]))
    dc = Calls(lib, dead, C)
    rows.append(timed("fwd dead", dc.fwd, fs))
    dc.fwd()
    rows.append(timed("bwd dead", lambda: dc.bwd(state=True), bs))
    print(f"{name} ms, device by profiler (CUDA events a call): "
          + "; ".join(rows), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this bench needs the card")
        return 1
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only-copies", action="store_true",
                    help="time the given sources alone")
    ap.add_argument("sources", nargs="*", help="edited copies of F's source")
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    C = dn.decode_consts(dataclasses.replace(OPTIMAL.model, use_mvg=True),
                         OPTIMAL.scan, True)
    libs = ({} if args.only_copies
            else {"package": (_cuda.library(), _cuda.build_log())})
    libs.update(build_variants(args.sources))
    a = inputs(dev)
    print(f"fold: N={N}, live {int((a['mask'] > 0).sum())}, s_nll {S_NLL}, "
          f"s_kl {S_KL}", flush=True)
    for name, (lib, log) in libs.items():
        bench(name, lib, log, a, C)
    print(gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
