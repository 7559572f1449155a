"""Time kernel H (qbold_vi_tpu_torch/csrc/conv3x3.cu) pass by pass on the
card, with each output's error against a float64 conv.

    python3 tools/bench_conv3x3.py [variant.cu ...]

Builds the package's kernels (``ops/_cuda.library``) and, for each further
source given -- an edited copy of ``csrc/conv3x3.cu`` with the same C
entries -- a library of that file alone with the same nvcc flags, all
compiles started at once. At the fine-tune fold (304, 25, 25, 60 -> 60)
and a serving chunk (16, 96, 96, 60 -> 60) it times each build's forward,
dx and dw/db entries by CUDA events (median of 7 blocks of 20 calls, after
3 warm-up calls) and prints the largest error of y, dx, dw and db against
the plain version in float64, as a share of the largest magnitude. It
prints each build's registers and spills for the forward and dw kernels,
and the card's name and power limit. Needs one CUDA card; about half a
minute with two variants.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import cuda_ms, gpu_line  # noqa: E402
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
        lib = ctypes.CDLL(str(so))
        lib.qv_conv3x3_fwd.argtypes = [_P] * 5 + [_LL] + [_I] * 4 + [_P]
        lib.qv_conv3x3_dx.argtypes = [_P] * 4 + [_LL] + [_I] * 4 + [_P]
        lib.qv_conv3x3_dw.argtypes = [_P] * 4 + [_LL] + [_I] * 4 + [_LL, _I,
                                                                  _P]
        libs[name] = lib
    return libs


def report(name: str, log: str) -> None:
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Function properties" in line and (
                "conv3x3_fwd_kernel" in line or "conv3x3_dw_kernel" in line):
            kernel = "forward" if "fwd_kernel" in line else "dw"
            print(f"{name} {kernel}: " + " ".join(
                s.replace("ptxas info    :", "").strip()
                for s in lines[i + 1:i + 3]), flush=True)


def dw_slots(lib) -> int:
    fn = getattr(lib, "qv_conv3x3_dw_slots", None)
    if fn is None:
        return 3 * 128
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    slots = ctypes.c_int()
    if fn(ctypes.byref(slots)) != 0:
        raise RuntimeError("qv_conv3x3_dw_slots failed")
    return slots.value


def bench(name, lib, shape, dev) -> None:
    n, h, w, ci, co = shape
    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(n, h, w, ci, generator=gen).to(dev)
    k = (torch.randn(3, 3, ci, co, generator=gen) * 0.1).to(dev)
    b = (torch.randn(co, generator=gen) * 0.1).to(dev)
    ct = torch.randn(n, h, w, co, generator=gen).to(dev)
    ref = (cv.conv3x3_plain(x.double(), k.double(), b.double()),) + \
        cv.conv3x3_grads_plain(x.double(), k.double(), ct.double())
    npx = n * h * w
    stream = torch.cuda.current_stream().cuda_stream
    wf_fwd, wf_dx = cv._weight_scratch(x, ci, co), cv._weight_scratch(x, co, ci)
    chunk = cv._dw_chunk(npx, ci, co, dw_slots(lib))
    nb = -(-npx // chunk)
    y, dx = torch.empty(n, h, w, co, device=dev), torch.empty_like(x)
    out = torch.empty(9 * ci * co + co, device=dev)
    part = torch.empty(nb, out.numel(), device=dev)
    calls = {
        "fwd": lambda: lib.qv_conv3x3_fwd(
            x.data_ptr(), k.data_ptr(), b.data_ptr(), wf_fwd.data_ptr(),
            y.data_ptr(), npx, h, w, ci, co, stream),
        "dx": lambda: lib.qv_conv3x3_dx(
            ct.data_ptr(), k.data_ptr(), wf_dx.data_ptr(), dx.data_ptr(), npx,
            h, w, ci, co, stream),
        "dw": lambda: lib.qv_conv3x3_dw(
            x.data_ptr(), ct.data_ptr(), part.data_ptr(), out.data_ptr(), npx,
            h, w, ci, co, chunk, nb, stream)}
    for key, fn in calls.items():
        if fn() != 0:
            raise RuntimeError(f"{name}: the {key} launch failed")
    torch.cuda.synchronize()
    got = (y, dx, out[:9 * ci * co].view(3, 3, ci, co), out[9 * ci * co:])
    errs = " ".join(
        f"{key} {float((g.double() - r).abs().max() / r.abs().max()):.2e}"
        for key, g, r in zip(("y", "dx", "dw", "db"), got, ref))
    times = " ".join(f"{key} {cuda_ms(fn, reps=20):.4f}"
                     for key, fn in calls.items())
    print(f"{name} {shape} ({nb} dw chunks): {times} ms; vs float64 {errs}",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this bench needs the card")
        return 1
    dev = torch.device("cuda", 0)
    libs = {"conv3x3": _cuda.library()}
    report("conv3x3", _cuda.build_log())
    libs.update(build_variants(sys.argv[1:]))
    for shape in SHAPES:
        for name, lib in libs.items():
            bench(name, lib, shape, dev)
    print(gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
