"""Time kernel G (qbold_vi_tpu_torch/csrc/decode_nll.cu, the decode +
NLL rows) forward and backward, with each build's error against the plain
version, its registers, spills, shared memory and SASS (instructions and
special-function instructions by kind).

    python3 tools/bench_decode_nll.py [--only-copies] [--split DIR]
        [--parent SRC ...] [SRC ...]

Run it from the repository's root on a machine with the card, as
``env PYTHONPATH=. python3 tools/bench_decode_nll.py ...``, with edited
copies in a git-ignored directory such as ``_chip_checkout/``.

Builds the package's kernels (``ops/_cuda.library``) and, for each further
source, a library of that file alone with the same nvcc flags and
``-I csrc``, all compiles started at once (a copy's own directory comes
first on the include path, so an edited ``elbo_math.cuh`` beside it
replaces the package's). A plain ``SRC`` keeps the package's C entries;
a ``--parent SRC`` keeps the entries of the earlier one-thread-a-row
kernel (a grid and block of 128 given by the caller, the table
staged in shared memory, dy always written), for example the parent's
sources unpacked by ``git archive <commit> qbold_vi_tpu_torch/csrc``.
``--only-copies`` times the given sources alone. The builds are timed in
turns: the first ``--parent`` copy (and the split), the package and the
other copies, then the other ``--parent`` copies (parent, change,
change, parent with two copies of the parent).

``--split DIR`` writes edited copies of the earlier kernel in DIR
(``decode_nll.cu`` and ``elbo_math.cuh`` of that design) and times each
beside it, with the earlier entries:

* ``io``: I/O alone -- each row's math replaced by a sum of the row's
  loads (forward) or by dsigma = ct sigma, dy = ct y (backward);
* ``math``: math alone -- every thread reads row 0 (a constant row,
  cached) and the backward writes dsigma and dy to shared memory;
* ``staged``: the load layout -- each block copies the y and sigma
  rows of its tile into shared memory with coalesced loads before the
  rows are read, and the backward's dsigma and dy go back the same way;
* ``nody``: the backward without the dy store (and its arithmetic);
* ``fast``: ``__expf``, ``__logf`` and ``__fdividef`` in place of expf,
  logf and the IEEE divisions of the signal and the NLL terms.

The cases are the fine-tune path that kernel G serves: OPTIMAL's widths
and scan with a diagonal posterior and a population prior (kernel F
does not cover it), 38 crops of 25 x 25 x 8 (190,000 rows) of random
volumes through the encoder (``init_params`` seed 0), one posterior
draw a voxel; ``gauss``: the Gaussian NLL at df 200; ``t2_multi``: the
same rows under Student-t df 2 and multi-image normalisation (the
settings of configurations/sweep_prior.yaml); ``s2``: no_samples 2,
380,000 rows, y and sigma broadcast over the two draws, as the
fine-tune step passes them. Each is timed forward, backward writing dy
and, for builds with the package's entries, backward without dy: device
ms by the profiler (median of 21 calls, ``chip_smoke.kernel_ms``) and
ms a call by CUDA events, with the inputs warm in the card's 50 MB L2 as
the calls repeat; and the forward and the backward with dy again with
the L2 emptied before each call ("cold": a 100 MB buffer written between
calls). Errors: rows against ``nll_row_plain`` times
the mask (absolute), gradients against ``nll_row_grads_plain`` times the
masked cotangent, over the largest reference entry, with whether
chip_smoke's gates hold (ROW_TOL; GRAD_TOL). Needs one CUDA card; about
a minute with eight builds.
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

from chip_smoke import (FT_SHAPE, GRAD_TOL, ROW_TOL, cuda_ms,  # noqa: E402
                        gpu_line, kernel_ms, sass, volumes)
from qbold_vi_tpu_torch import OPTIMAL, FineTuner, init_params  # noqa: E402
from qbold_vi_tpu_torch.ops import _cuda  # noqa: E402
from qbold_vi_tpu_torch.ops import decode_nll as dn  # noqa: E402

N = int(np.prod(FT_SHAPE))
FWD, BWD = "qv_decode_nll_fwd_kernel", "qv_decode_nll_bwd_kernel"
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the earlier kernel's C entries (grid and block given, 128 a block)
PARENT = {
    "qv_decode_nll_fwd": [_P, _P, _P, _P, _P, _LL, _cuda.QvDecodeConsts, _P,
                          _I, _P, _I, _I, _P],
    "qv_decode_nll_bwd": [_P, _P, _P, _P, _P, _P, _LL, _cuda.QvDecodeConsts,
                          _P, _I, _P, _P, _P, _P, _I, _I, _P]}
PARENT_BLOCK = 128


# ---- the split: edited copies of the earlier kernel --------------------------

def _edit(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise ValueError(f"split: expected one {old!r} in the source")
    return text.replace(old, new)


_SIG_FWD = """(
    const float* __restrict__ oef, const float* __restrict__ dbv,
    const float* __restrict__ y, const float* __restrict__ sig,
    const float* __restrict__ mask, long long n, QvDecodeConsts C,
    const float* __restrict__ table, float* __restrict__ rows) {
  extern __shared__ float smem[];
  int T = C.n_taus;
  qv_stage_table(table, smem, qv_table_len(T));
  __syncthreads();
  QvTable tb = qv_table(smem, T);
"""
_SIG_BWD = """(
    const float* __restrict__ oef, const float* __restrict__ dbv,
    const float* __restrict__ y, const float* __restrict__ sig,
    const float* __restrict__ mask, const float* __restrict__ ct,
    long long n, QvDecodeConsts C, const float* __restrict__ table,
    float* __restrict__ doef, float* __restrict__ ddbv,
    float* __restrict__ dsig, float* __restrict__ dy) {
  extern __shared__ float smem[];
  int T = C.n_taus;
  qv_stage_table(table, smem, qv_table_len(T));
  __syncthreads();
  QvTable tb = qv_table(smem, T);
"""
_ROWS = """  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < n;
       v += stride) {
"""
_TILES = """  float* ys = smem + qv_table_len(T);
  float* ss = ys + blockDim.x * T;
  float* yr = ys + threadIdx.x * T;
  float* sr = ss + threadIdx.x * T;
  for (long long v0 = (long long)blockIdx.x * blockDim.x; v0 < n;
       v0 += (long long)gridDim.x * blockDim.x) {
    int count = (int)min((long long)blockDim.x, n - v0) * T;
    __syncthreads();
    for (int k = threadIdx.x; k < count; k += blockDim.x) {
      ys[k] = y[v0 * T + k];
      ss[k] = sig[v0 * T + k];
    }
    __syncthreads();
    long long v = v0 + threadIdx.x;
"""
# the split's kernels, each in place of the earlier pair (same entries)
SPLIT_KERNELS = {
    "io": ("  (void)tb;\n" + _ROWS + """    float acc = oef[v] + dbv[v];
    for (int t = 0; t < T; ++t) acc = acc + (y[v * T + t] + sig[v * T + t]);
    rows[v] = acc * mask[v];
  }
}
""", "  (void)tb;\n" + _ROWS + """    float c = ct[v] * mask[v];
    for (int t = 0; t < T; ++t) {
      dsig[v * T + t] = c * sig[v * T + t];
      dy[v * T + t] = c * y[v * T + t];
    }
    doef[v] = c * oef[v];
    ddbv[v] = c * dbv[v];
  }
}
"""),
    "math": (_ROWS + """    float m = mask[v];
    rows[v] = qv_nll_row(C, tb, oef[0], dbv[0], y, sig, mask[0]) * m;
  }
}
""", """  float* s_sig = smem + qv_table_len(T) + threadIdx.x * T;
  float* s_dy = smem + qv_table_len(T) + (blockDim.x + threadIdx.x) * T;
""" + _ROWS + """    float m = mask[v];
    float c = ct[v] * m;
    float go, gd;
    qv_nll_row_grads(C, tb, oef[0], dbv[0], y, sig, mask[0], c, true, s_sig,
                     s_dy, &go, &gd);
    doef[v] = c * go;
    ddbv[v] = c * gd;
  }
}
"""),
    "staged": (_TILES + """    if (v < n) {
      float m = mask[v];
      rows[v] = qv_nll_row(C, tb, oef[v], dbv[v], yr, sr, m) * m;
    }
  }
}
""", _TILES + """    float c = 0.0f, go = 0.0f, gd = 0.0f;
    if (v < n) {
      float m = mask[v];
      c = ct[v] * m;
      qv_nll_row_grads(C, tb, oef[v], dbv[v], yr, sr, m, c, true, sr, yr,
                       &go, &gd);
    }
    __syncthreads();
    for (int k = threadIdx.x; k < count; k += blockDim.x) {
      dsig[v0 * T + k] = ss[k];
      dy[v0 * T + k] = ys[k];
    }
    if (v < n) {
      doef[v] = c * go;
      ddbv[v] = c * gd;
    }
  }
}
""")}
# the launches that give a split kernel shared memory past the table
_SCRATCH_WAYS = {"io": (), "math": ("bwd",), "staged": ("fwd", "bwd")}
_SCRATCH = ("table_len * sizeof(float)",
            "(table_len + 2 * block * C.n_taus) * sizeof(float)")


def split_copies(parent: Path, out: Path) -> list:
    """Write the split's edited copies of the earlier kernel (parent/
    decode_nll.cu, parent/elbo_math.cuh) under out/<name>/; returns the
    copies' paths."""
    src = (parent / "decode_nll.cu").read_text()
    hdr = (parent / "elbo_math.cuh").read_text()
    head = src[:src.index("__global__ void qv_decode_nll_fwd_kernel(")]
    entries = src[src.index('extern "C" int qv_decode_nll_fwd('):]
    copies = {}
    for name, (fwd, bwd) in SPLIT_KERNELS.items():
        ent = entries
        for way in _SCRATCH_WAYS[name]:
            launch = f"qv_decode_nll_{way}_kernel<<<grid, block, "
            ent = _edit(ent, launch + _SCRATCH[0], launch + _SCRATCH[1])
        copies[name] = (head + "__global__ void qv_decode_nll_fwd_kernel"
                        + _SIG_FWD + fwd
                        + "\n__global__ void qv_decode_nll_bwd_kernel"
                        + _SIG_BWD + bwd + "\n" + ent, hdr)
    nody = _edit(hdr, "  dy[t] = first ? vy : dy[t] + vy;\n", "")
    copies["nody"] = (src, _edit(
        nody, "  for (int t = 0; t < C.n_taus; ++t)\n    if (qv_in_window(C, "
        "t)) dy[t] = dy[t] - ky;\n", "  (void)ky;\n"))
    fast = hdr
    for old, new in (
            ("s.tissue = expf(", "s.tissue = __expf("),
            ("s.blood = C.bc * expf(", "s.blood = C.bc * __expf("),
            ("*nll = (C.t_const + logf(sig))",
             "*nll = (C.t_const + __logf(sig))"),
            ("*nll = (logf(sig)", "*nll = (__logf(sig)"),
            ("log1pf((r * r) / dss)", "log1pf(__fdividef(r * r, dss))"),
            ("*d_r = (C.df1 * r) / denom;",
             "*d_r = __fdividef(C.df1 * r, denom);"),
            ("*d_sig = 1.0f / sig - ((C.df1 * r) * r) / (sig * denom);",
             "*d_sig = __fdividef(1.0f, sig) - __fdividef((C.df1 * r) * r, "
             "sig * denom);"),
            ("float rs = r / sig;", "float rs = __fdividef(r, sig);"),
            ("*d_r = r / (sig * sig);", "*d_r = __fdividef(r, sig * sig);"),
            ("*d_sig = 1.0f / sig - (r * r) / (sig * (sig * sig));",
             "*d_sig = __fdividef(1.0f, sig) - __fdividef(r * r, sig * (sig "
             "* sig));"),
            ("float yh = y[t] / t_ref;", "float yh = __fdividef(y[t], t_ref);"),
            ("float q = qv_signal(C, tb, t, oef, dbv).pred / p_ref;",
             "float q = __fdividef(qv_signal(C, tb, t, oef, dbv).pred, "
             "p_ref);"),
            ("    yh = mask > 0.0f ? logf(yh) : 0.0f;\n    q = mask > 0.0f ? "
             "logf(q) : 0.0f;", "    yh = mask > 0.0f ? __logf(yh) : 0.0f;\n"
             "    q = mask > 0.0f ? __logf(q) : 0.0f;"),
            ("float yh_lin = y[t] / t_ref;",
             "float yh_lin = __fdividef(y[t], t_ref);"),
            ("float q_lin = sg.pred / p_ref;",
             "float q_lin = __fdividef(sg.pred, p_ref);"),
            ("    yh = mask > 0.0f ? logf(yh_lin) : 0.0f;\n    z = mask > 0.0f"
             " ? logf(q_lin) : 0.0f;", "    yh = mask > 0.0f ? __logf(yh_lin)"
             " : 0.0f;\n    z = mask > 0.0f ? __logf(q_lin) : 0.0f;"),
            ("e = e / q_lin;", "e = __fdividef(e, q_lin);"),
            ("d_r / fmaxf(yh_lin, 1e-30f)", "__fdividef(d_r, fmaxf(yh_lin, "
             "1e-30f))"),
            ("float ep = e / p_ref;", "float ep = __fdividef(e, p_ref);"),
            ("vy = ct * (c / t_ref);", "vy = ct * __fdividef(c, t_ref);")):
        fast = _edit(fast, old, new)
    copies["fast"] = (src, fast)
    paths = []
    for name, (cu, cuh) in copies.items():
        d = out / f"split_{name}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "decode_nll.cu").write_text(cu)
        (d / "elbo_math.cuh").write_text(cuh)
        paths.append(d / "decode_nll.cu")
    return paths


# ---- builds -----------------------------------------------------------------

def build_variants(specs):
    """{name: (library, nvcc log, .so path, earlier entries?)} of each
    (source, earlier) given, built with the port's flags."""
    out_dir = _cuda.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for path, earlier in specs:
        path = Path(path)
        name = f"{path.parent.name}/{path.stem}"
        so = out_dir / f"g_{path.parent.name}_{path.stem}.so"
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, f"-I{path.resolve().parent}",
               f"-I{_cuda.CSRC}", "-shared", "-o", str(so), str(path)]
        procs.append((name, so, earlier, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, earlier, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        libs[name] = (bind(ctypes.CDLL(str(so)), earlier), log, so, earlier)
    return libs


def bind(lib, earlier: bool):
    for fn in ("qv_decode_nll_fwd", "qv_decode_nll_bwd"):
        getattr(lib, fn).argtypes = (PARENT if earlier
                                     else _cuda._SIGNATURES)[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def resources(log: str) -> dict:
    """{kernel: (registers, shared bytes, 'stack / spill' text)} of G's
    kernels from ptxas's --resource-usage report."""
    out = {}
    lines = log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Function properties for (\S*qv_decode_nll_(fwd|bwd)"
                      r"_kernel\S*)", line)
        if m and i + 2 < len(lines):
            regs = re.search(r"Used (\d+) registers", lines[i + 2])
            smem = re.search(r"(\d+) bytes smem", lines[i + 2])
            out[m.group(1)] = (int(regs.group(1)) if regs else -1,
                               int(smem.group(1)) if smem else 0,
                               lines[i + 1].strip())
    return out


# ---- cases ------------------------------------------------------------------

def cases(dev) -> dict:
    """{name: operands} of the three cases (module docstring)."""
    cfg = dataclasses.replace(OPTIMAL.model, use_mvg=False,
                              use_population_prior=True)
    scan = OPTIMAL.scan
    tuner = FineTuner(cfg, scan, device=dev)
    tuner.load_state_dict(init_params(cfg, scan,
                                      torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(4)
    vol = torch.from_numpy(volumes(rng, FT_SHAPE, scan.n_taus)).to(dev)
    mask = vol[..., -1:]
    images = vol[..., :-1] * mask
    with torch.no_grad():
        _, q, sigma = tuner.encode(images)
        z = torch.from_numpy(rng.normal(size=(2,) + FT_SHAPE + (2,)).astype(
            np.float32)).to(dev)
        draws = tuner.dist.sample_many(z, q, False)
    t = scan.n_taus
    gauss = dn.decode_consts(cfg, scan)
    t2 = dn.decode_consts(dataclasses.replace(
        cfg, student_t_df=2.0, multi_image_normalisation=True), scan)

    def rows(s):
        return dict(oef=draws[:s, ..., 0].reshape(-1).contiguous(),
                    dbv=draws[:s, ..., 1].reshape(-1).contiguous(),
                    y=images.expand((s,) + images.shape).reshape(-1, t)
                    .contiguous(),
                    sigma=sigma.expand((s,) + sigma.shape).reshape(-1, t)
                    .contiguous(),
                    mask=mask.expand((s,) + mask.shape).reshape(-1)
                    .contiguous(),
                    ct=torch.from_numpy(rng.normal(size=s * N).astype(
                        np.float32)).to(dev))

    one = rows(1)
    return {"gauss": dict(one, C=gauss), "t2_multi": dict(one, C=t2),
            "s2": dict(rows(2), C=gauss)}


class Calls:
    """The C entries of one build on one case, outputs preallocated."""

    def __init__(self, lib, earlier: bool, a: dict):
        self.lib, self.earlier, self.a = lib, earlier, a
        C = a["C"]
        self.n = a["oef"].shape[0]
        self.C, self.table = C.struct(), C.device_table(a["oef"].device)
        self.coeffs = None if earlier else C.coeffs()
        self.stream = torch.cuda.current_stream().cuda_stream
        self.rows = torch.empty_like(a["oef"])
        self.doef, self.ddbv = (torch.empty_like(a["oef"]) for _ in range(2))
        self.dsig, self.dy = (torch.empty_like(a["y"]) for _ in range(2))

    def _ins(self):
        a = self.a
        return [a[k].data_ptr() for k in ("oef", "dbv", "y", "sigma", "mask")]

    def _consts(self):
        extra = [] if self.earlier else [self.coeffs]
        return [self.C, *extra, self.table.data_ptr(), self.table.numel()]

    def _launch(self):
        if self.earlier:
            grid = max(1, min(-(-self.n // PARENT_BLOCK), 1 << 20))
            return [grid, PARENT_BLOCK, self.stream]
        return [self.stream]

    def fwd(self):
        err = self.lib.qv_decode_nll_fwd(*self._ins(), self.n, *self._consts(),
                                         self.rows.data_ptr(), *self._launch())
        if err:
            raise RuntimeError(f"forward launch failed ({err})")

    def bwd(self, dy=True):
        if not (dy or not self.earlier):
            raise ValueError("the earlier kernel always writes dy")
        err = self.lib.qv_decode_nll_bwd(
            *self._ins(), self.a["ct"].data_ptr(), self.n, *self._consts(),
            self.doef.data_ptr(), self.ddbv.data_ptr(), self.dsig.data_ptr(),
            self.dy.data_ptr() if dy else None, *self._launch())
        if err:
            raise RuntimeError(f"backward launch failed ({err})")


def errors(calls: Calls) -> str:
    a = calls.a
    ins = tuple(a[k] for k in ("oef", "dbv", "y", "sigma", "mask"))
    ref = dn.nll_row_plain(*ins, a["C"]) * a["mask"]
    calls.fwd()
    torch.cuda.synchronize()
    d = (calls.rows.double() - ref.double()).abs()
    row_ok = bool((d <= ROW_TOL[1] + ROW_TOL[0] * ref.double().abs()).all())
    ct = a["ct"] * a["mask"]
    grads = dn.nll_row_grads_plain(*ins, a["C"])
    out = [f"rows {float(d.max()):.2e} ({'within' if row_ok else 'OUTSIDE'}"
           " ROW_TOL)"]
    for dy in (True, False) if not calls.earlier else (True,):
        calls.bwd(dy)
        torch.cuda.synchronize()
        worst, ok = 0.0, True
        got = (calls.doef, calls.ddbv, calls.dsig, calls.dy)
        for g, r in list(zip(got, grads))[:4 if dy else 3]:
            r = (r * (ct if r.ndim == 1 else ct[:, None])).double()
            scale = r.abs().max().clamp(min=1e-8)
            e = (g.double() - r).abs() / scale
            worst = max(worst, float(e.max()))
            ok &= bool((e <= GRAD_TOL[1] + GRAD_TOL[0] * r.abs() / scale)
                       .all())
        out.append(f"grads{'' if dy else ' (no dy)'} {worst:.2e} "
                   f"({'within' if ok else 'OUTSIDE'} GRAD_TOL)")
    return ", ".join(out)


def timed(label: str, fn, symbol: str) -> str:
    return f"{label} {kernel_ms(fn, symbol):.4f} ({cuda_ms(fn):.4f})"


def timed_cold(label: str, fn, symbol: str, flush) -> str:
    """The device time with the 50 MB L2 emptied before each call, by
    writing a buffer twice its size (the profiler's time of the kernel
    alone)."""
    return f"{label} {kernel_ms(lambda: (flush.zero_(), fn()), symbol):.4f}"


def bench(name, lib, log, so, earlier, data, flush) -> None:
    code = sass(so)
    parts = []
    for sym, (regs, smem, frame) in sorted(resources(log).items()):
        short = re.sub(r"^_Z\d+", "", sym)[:40]
        size, mufu = next(((s, m) for k, (s, m) in code.items()
                           if k in sym), (0, {}))
        parts.append(f"{short}: {regs} registers, {smem} B static shared, "
                     f"{frame}, {size} SASS instructions, MUFU "
                     f"{dict(sorted(mufu.items()))}")
    print(f"{name}: " + "; ".join(parts), flush=True)
    for case, a in data.items():
        calls = Calls(lib, earlier, a)
        rows = [timed("fwd", calls.fwd, FWD), timed("bwd", calls.bwd, BWD)]
        if not earlier:
            rows.append(timed("bwd no dy", lambda: calls.bwd(False), BWD))
        rows += [timed_cold("fwd cold", calls.fwd, FWD, flush),
                 timed_cold("bwd cold", calls.bwd, BWD, flush)]
        print(f"{name} {case} (N={calls.n}): {errors(calls)}; ms, device by "
              "profiler (CUDA events a call): " + "; ".join(rows), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this bench needs the card")
        return 1
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only-copies", action="store_true",
                    help="time the given sources alone")
    ap.add_argument("--split", metavar="DIR",
                    help="time the split's edited copies of the earlier "
                    "kernel in DIR")
    ap.add_argument("--parent", action="append", default=[],
                    help="a copy of the earlier kernel (its C entries)")
    ap.add_argument("sources", nargs="*", help="edited copies of the "
                    "package's decode_nll.cu")
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    # timed in turns: the first earlier copy and the split, the package and
    # the other copies, then the other earlier copies
    first = [(p, True) for p in args.parent[:1]]
    if args.split:
        first += [(p, True) for p in split_copies(
            Path(args.split), _cuda.BUILD_DIR / "variants")]
    rest = ([(p, False) for p in args.sources]
            + [(p, True) for p in args.parent[1:]])
    built = build_variants(first + rest)
    names = list(built)
    libs = {k: built[k] for k in names[:len(first)]}
    if not args.only_copies:
        lib = bind(_cuda.library(), False)
        libs["package"] = (lib, _cuda.build_log(), lib._name, False)
    libs.update({k: built[k] for k in names[len(first):]})
    data = cases(dev)
    live = int((data["gauss"]["mask"] > 0).sum())
    print(f"rows: N={N} ({live} live), s2 N={2 * N}; diagonal posterior, "
          "population prior, OPTIMAL's scan", flush=True)
    flush = torch.empty(25 * 2 ** 20, device=dev)        # 100 MB
    for name, (lib, log, so, earlier) in libs.items():
        bench(name, lib, log, so, earlier, data, flush)
    print(gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
