"""Time kernel H (qbold_vi_tpu_torch/csrc/conv3x3.cu) pass by pass on the
card, with each output's error against a float64 conv.

    python3 tools/bench_conv3x3.py [--dtype float32|bfloat16] [variant.cu ...]

Builds the package's kernels (``ops/_cuda.library``) and, for each further
source given -- an edited copy of ``csrc/conv3x3.cu`` with the same C
entries -- a library of that file alone with the same nvcc flags, all
compiles started at once. At the fine-tune fold (304, 25, 25, 60 -> 60)
and a serving chunk (16, 96, 96, 60 -> 60) it times each build's forward,
dx and dw/db entries by CUDA events (median of 7 blocks of 20 calls, after
3 warm-up calls) and each kernel of a pass by its device time (the
profiler's median over 21 calls), and prints the largest error of y, dx,
dw and db against the plain version in float64, as a share of the
largest magnitude. It
prints each build's registers and spills for the forward, dx and dw
kernels, their SASS instructions and the wgmma (HGMMA) among them, and the
card's name and power limit. ``--dtype bfloat16`` times the bf16
trunk's entries (``qv_conv3x3_*_bf16``: bf16 operands, float32 sums) on
the same shapes, the float64 reference taken on the same bf16 values, and
adds each error in bf16 ulps of the largest magnitude. Needs one CUDA
card; about half a minute with two variants.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import cuda_ms, gpu_line, sass  # noqa: E402
from qbold_vi_tpu_torch.ops import _cuda  # noqa: E402
from qbold_vi_tpu_torch.ops import conv3x3 as cv  # noqa: E402

SHAPES = ((304, 25, 25, 60, 60), (16, 96, 96, 60, 60))
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def build_variants(paths):
    """{name: ctypes library} of each source, built with the port's flags."""
    out_dir = _cuda.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for path in map(Path, paths):
        so = out_dir / (path.stem + ".so")
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(so),
               str(path)]
        procs.append((path.stem, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        report(name, log)
        report_sass(name, so)
        lib = ctypes.CDLL(str(so))
        for tag in ("", "_bf16"):
            if not hasattr(lib, "qv_conv3x3_fwd" + tag):
                continue
            getattr(lib, "qv_conv3x3_fwd" + tag).argtypes = (
                [_P] * 5 + [_LL] + [_I] * 4 + [_P])
            getattr(lib, "qv_conv3x3_dx" + tag).argtypes = (
                [_P] * 4 + [_LL] + [_I] * 4 + [_P])
            getattr(lib, "qv_conv3x3_dw" + tag).argtypes = (
                [_P] * 4 + [_LL] + [_I] * 4 + [_LL, _I, _P])
        libs[name] = lib
    return libs


H_KERNELS = {"conv3x3_fwd_kernel": "forward", "conv3x3_dw_kernel": "dw",
             "conv3x3_fwd_wg_bf16_kernel": "bf16 forward",
             "conv3x3_dx_wg_bf16_kernel": "bf16 dx",
             "conv3x3_dw_wg_bf16_kernel": "bf16 dw"}


def report(name: str, log: str) -> None:
    lines = log.splitlines()
    for i, line in enumerate(lines):
        kernel = next((v for k, v in H_KERNELS.items()
                       if "Function properties" in line and k in line), None)
        if kernel:
            print(f"{name} {kernel}: " + " ".join(
                s.replace("ptxas info    :", "").strip()
                for s in lines[i + 1:i + 3]), flush=True)


def report_sass(name: str, so) -> None:
    """Each kernel H's SASS instructions and its wgmma (HGMMA) among them,
    by cuobjdump (a loop body counts once)."""
    code = sass(so)
    print(f"{name} SASS: " + ", ".join(
        f"{k} {code[k][0]} ({code[k][1].get('HGMMA', 0)} HGMMA)"
        for k in sorted(code) if "conv3x3" in k), flush=True)


def dw_slots(lib, bf16: bool) -> tuple:
    """(blocks of the dw pass the card runs at once, whether they are the
    bf16 kernel's): the bf16 entries' own count where the library has it."""
    fn = getattr(lib, "qv_conv3x3_dw_bf16_slots", None) if bf16 else None
    ours = fn is not None
    fn = fn or getattr(lib, "qv_conv3x3_dw_slots", None)
    if fn is None:
        return 3 * 128, ours
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    slots = ctypes.c_int()
    if fn(ctypes.byref(slots)) != 0:
        raise RuntimeError("the dw pass's occupancy query failed")
    return slots.value, ours


def bench(name, lib, shape, dev, dtype=torch.float32) -> None:
    n, h, w, ci, co = shape
    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(n, h, w, ci, generator=gen).to(dev, dtype)
    k = (torch.randn(3, 3, ci, co, generator=gen) * 0.1).to(dev, dtype)
    b = (torch.randn(co, generator=gen) * 0.1).to(dev, dtype)
    ct = torch.randn(n, h, w, co, generator=gen).to(dev, dtype)
    ref = (cv.conv3x3_plain(x.double(), k.double(), b.double()),) + \
        cv.conv3x3_grads_plain(x.double(), k.double(), ct.double())
    tag = "_bf16" if dtype == torch.bfloat16 else ""
    if not hasattr(lib, "qv_conv3x3_fwd" + tag):
        print(f"{name}: no {dtype} entries", flush=True)
        return
    npx = n * h * w
    stream = torch.cuda.current_stream().cuda_stream
    wf_fwd, wf_dx = cv._weight_scratch(x, ci, co), cv._weight_scratch(x, co, ci)
    chunk = cv._dw_chunk(npx, ci, co, *dw_slots(lib, dtype == torch.bfloat16))
    nb = -(-npx // chunk)
    y = torch.empty(n, h, w, co, device=dev, dtype=dtype)
    dx = torch.empty_like(x)
    out = torch.empty(9 * ci * co + co, device=dev, dtype=dtype)
    part = torch.empty(nb, out.numel(), device=dev)
    fwd, dxe, dwe = (getattr(lib, f"qv_conv3x3_{e}{tag}")
                     for e in ("fwd", "dx", "dw"))
    calls = {
        "fwd": lambda: fwd(
            x.data_ptr(), k.data_ptr(), b.data_ptr(), wf_fwd.data_ptr(),
            y.data_ptr(), npx, h, w, ci, co, stream),
        "dx": lambda: dxe(
            ct.data_ptr(), k.data_ptr(), wf_dx.data_ptr(), dx.data_ptr(), npx,
            h, w, ci, co, stream),
        "dw": lambda: dwe(
            x.data_ptr(), ct.data_ptr(), part.data_ptr(), out.data_ptr(), npx,
            h, w, ci, co, chunk, nb, stream)}
    for key, fn in calls.items():
        if fn() != 0:
            raise RuntimeError(f"{name}: the {key} launch failed")
    torch.cuda.synchronize()
    got = (y, dx, out[:9 * ci * co].view(3, 3, ci, co), out[9 * ci * co:])
    errs = []
    for key, g, r in zip(("y", "dx", "dw", "db"), got, ref):
        e, scale = float((g.double() - r).abs().max()), float(r.abs().max())
        errs.append(f"{key} {e / scale:.2e}")
        if dtype == torch.bfloat16:
            ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
            errs[-1] += f" ({e / ulp:.2f} bf16 ulps)"
    times = " ".join(f"{key} {cuda_ms(fn, reps=20):.4f}"
                     for key, fn in calls.items())
    print(f"{name} {shape} {str(dtype)[6:]} ({nb} dw chunks): {times} ms; "
          f"vs float64 {' '.join(errs)}", flush=True)
    print(f"{name} {shape} device ms: " + "; ".join(
        f"{key} " + ", ".join(f"{k} {v:.4f}" for k, v in
                              device_parts(fn).items())
        for key, fn in calls.items()), flush=True)


def device_parts(fn, calls: int = 21) -> dict:
    """{kernel: median device ms a launch} over ``calls`` calls of fn,
    from the profiler's CUDA activity (a kernel whose launches the trace
    drops shows the median of those it kept)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"qv_\w+?_kernel", e.name)
            spans.setdefault(m.group(0) if m else e.name, []).append(
                e.time_range.elapsed_us() / 1e3)
    return {k[11:-7] if k.startswith("qv_conv3x3_") else k:
            statistics.median(v) for k, v in spans.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this bench needs the card")
        return 1
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("variants", nargs="*", help="edited copies of conv3x3.cu")
    args = ap.parse_args()
    dtype = getattr(torch, args.dtype)
    dev = torch.device("cuda", 0)
    libs = {"conv3x3": _cuda.library()}
    report("conv3x3", _cuda.build_log())
    report_sass("conv3x3", libs["conv3x3"]._name)
    libs.update(build_variants(args.variants))
    for shape in SHAPES:
        for name, lib in libs.items():
            bench(name, lib, shape, dev, dtype)
    print(gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
