"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface and are bound with ``ctypes``: no
PyTorch headers are compiled. A cold build starts one ``nvcc`` per source,
all at once, and links their objects into one shared library, which is
built at first use into
``qbold_vi_tpu_torch/_build/`` (git-ignored), under a name keyed by a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. Nothing here runs at import time.
Processes that start cold together (the ranks of a sharded run) build
once: the build holds an exclusive ``flock`` on ``_build/.lock``, and a
process that waited for it finds the library built.

Each C entry launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` turns a non-zero code into an
exception, so a refused launch (too many threads, too much shared
memory, no image for this card) never passes silently.

No ``--use_fast_math``: it would give every ``expf``, ``tanhf`` and
division the hardware's approximation. The kernels ask for it by name
where their gates allow (``__expf``/``__fdividef`` in the quadrature's
sigmoids and densities and in kernel D's sigmoids) and keep IEEE
elsewhere (the log-std transforms' ``tanhf``). ``--fmad=false``
keeps nvcc from contracting a*b + c into one rounding: the plain
version rounds every product, and the posterior variances (E[x^2] -
E[x]^2) amplify a last-bit difference. The dense chain of the fused
kernel asks for its FMAs explicitly (``fmaf``), and the 3x3 convolution
(kernel H) takes its products on the tensor cores (``mma``), both of
which the flag leaves alone.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["library", "build_log", "check", "quad_consts", "quad_ranges",
           "QvDecodeConsts", "QvDecodeCoeffs", "QvSynthConsts", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("quadrature.cu", "encode_quad.cu", "encode_quad_bf16.cu",
           "encode_stream_bf16.cu", "encode_stream_wg.cu",
           "encode_stream_wgc.cu", "encode_stream_wgx.cu",
           "encode_stream_wgx_c.cu", "encode_stream_wgk.cu",
           "encode_stream_wgk_c.cu", "encode_stream_wgk_w.cu",
           "encode_stream_wgk_wc.cu", "decode_nll.cu", "fused_elbo.cu",
           "summarize.cu", "conv3x3.cu", "synth_batch.cu")
HEADERS = ("quad_math.cuh", "elbo_math.cuh", "mma_math.cuh",
           "encode_act.cuh", "encode_stream.cuh", "encode_stream_wg.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC",
              "--resource-usage")

class QvRanges(ctypes.Structure):
    """csrc/quad_math.cuh::QvRanges: the ranges and the scalar products
    of the summaries, each computed in double and rounded once to
    float32 -- what the plain version's Python-float coefficients give."""

    _fields_ = [(name, ctypes.c_float) for name in (
        "a", "b", "c", "d", "aa", "ab2", "bb", "cc", "cd2", "dd", "ac",
        "ad", "cb", "bd", "dw", "dw2")]


def quad_ranges(*, oef_range: float, min_oef: float, dbv_range: float,
                min_dbv: float, dw_coeff: float) -> QvRanges:
    a, b, c, d, dw = min_oef, oef_range, min_dbv, dbv_range, dw_coeff
    return QvRanges(a, b, c, d, a * a, 2.0 * a * b, b * b, c * c,
                    2.0 * c * d, d * d, a * c, a * d, c * b, b * d, dw,
                    dw * dw)


class QvDecodeConsts(ctypes.Structure):
    """csrc/elbo_math.cuh::QvDecodeConsts: the scalars of one decode
    configuration, built by ops/decode_nll.py::decode_consts."""

    _fields_ = ([(name, ctypes.c_int) for name in (
        "n_taus", "se", "multi", "log_data", "student", "use_blood",
        "cheb")] + [(name, ctypes.c_float) for name in (
            "envelope", "bc", "mnb", "inv_cmax2", "df", "df1", "half_df1",
            "t_const", "half_log_2pi", "wk", "oef_range", "min_oef",
            "dbv_range", "min_dbv", "kl_bound")])


class QvDecodeCoeffs(ctypes.Structure):
    """csrc/decode_nll.cu::QvDecodeCoeffs: the surrogate's coefficients
    and its derivative's (a decode table's ci and cd), passed to kernel G
    by value."""

    _fields_ = [("ci", ctypes.c_float * 21), ("cd", ctypes.c_float * 20)]


class QvSynthConsts(ctypes.Structure):
    """csrc/synth_batch.cu::QvSynthConsts: the population mixture's,
    the misalignment's and the noise's scalars, built by
    ops/synth_batch.py::synth_consts."""

    _fields_ = [("misalign", ctypes.c_int), ("noise", ctypes.c_int)] + [
        (name, ctypes.c_float) for name in (
            "oef_lo", "oef_hi", "oef_mean", "oef_std", "dbv_lo", "dbv_hi",
            "dbv_mean", "dbv_std", "tn_a", "tn_b", "uniform_prop",
            "misalign_prob", "k_r2p", "snr_lo", "snr_hi")]


_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "qv_quad_posterior_summaries": [
        _P, _LL, _I, _I, QvRanges, _P, _P, _P, _I, _I, _P],
    "qv_encode_quad_fused": [
        _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, QvRanges,
        _P, _P, _P, _I, _I, _LL, _P],
    "qv_encode_q1": [
        _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P, _I, _LL, _P],
    "qv_encode_quad_fused_bf16": [
        _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, QvRanges,
        _P, _P, _P, _I, _I, _LL, _P],
    "qv_encode_q1_bf16": [
        _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P, _I, _LL, _P],
    "qv_encode_quad_wg": [
        _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, QvRanges, _P, _P,
        _P, _I, _I, _I, _I, _I, _LL, _P],
    "qv_encode_q1_wg": [
        _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I,
        _LL, _P],
    "qv_encode_quad_wgc": [
        _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, QvRanges, _P, _P,
        _P, _I, _I, _I, _I, _I, _I, _LL, _P],
    "qv_encode_q1_wgc": [
        _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I,
        _I, _LL, _P],
    "qv_encode_quad_wgx": [
        _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, QvRanges, _P, _P,
        _P, _I, _I, _I, _I, _I, _LL, _P],
    "qv_encode_q1_wgx": [
        _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I,
        _LL, _P],
    "qv_encode_quad_wgk": [
        _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, QvRanges, _P, _P,
        _P, _I, _I, _I, _I, _I, _I, _I, _LL, _P],
    "qv_encode_q1_wgk": [
        _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I,
        _I, _I, _LL, _P],
    "qv_encode_wgk_clusters": [
        _I, _I, _I, _I, _I, _I, _LL, ctypes.POINTER(ctypes.c_int)],
    "qv_encode_quad_wgk_w": [
        _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, QvRanges, _P, _P,
        _P, _I, _I, _I, _I, _I, _I, _I, _LL, _P],
    "qv_encode_q1_wgk_w": [
        _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I,
        _I, _I, _LL, _P],
    "qv_encode_quad_stream_bf16": [
        _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _P, QvRanges, _P, _P, _P,
        _I, _I, _I, _I, _I, _LL, _P],
    "qv_encode_q1_stream_bf16": [
        _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I,
        _LL, _P],
    "qv_max_dynamic_smem": [],
    "qv_quad_scratch_floats": [_I],
    "qv_decode_nll_fwd": [
        _P, _P, _P, _P, _P, _LL, QvDecodeConsts, QvDecodeCoeffs, _P, _I, _P,
        _P],
    "qv_decode_nll_bwd": [
        _P, _P, _P, _P, _P, _P, _LL, QvDecodeConsts, QvDecodeCoeffs, _P, _I,
        _P, _P, _P, _P, _P],
    "qv_elbo_fwd": [
        _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _I, _I, _I, QvDecodeConsts,
        _P, _I, _P, _P, _P, _I, _P],
    "qv_elbo_bwd": [
        _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _I, _I, _I, _P, _P, _P,
        QvDecodeConsts, _P, _I, _P, _P, _P, _P, _I, _P],
    "qv_mc_summaries": [
        _P, _LL, _LL, _LL, _I, QvRanges, _P, _LL, _LL, _I, _I, _F, _P, _P,
        _LL, _LL, _I, _I, _P],
    "qv_mc_kl_map": [_P, _P, _LL, _I, _P, _LL, _LL, _I, _F, _P, _I, _P],
    "qv_conv3x3_fwd": [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P],
    "qv_conv3x3_dx": [_P, _P, _P, _P, _LL, _I, _I, _I, _I, _P],
    "qv_conv3x3_dw": [_P, _P, _P, _P, _LL, _I, _I, _I, _I, _LL, _I, _P],
    "qv_conv3x3_fwd_bf16": [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P],
    "qv_conv3x3_dx_bf16": [_P, _P, _P, _P, _LL, _I, _I, _I, _I, _P],
    "qv_conv3x3_dw_bf16": [_P, _P, _P, _P, _LL, _I, _I, _I, _I, _LL, _I, _P],
    "qv_conv3x3_dw_slots": [ctypes.POINTER(ctypes.c_int)],
    "qv_conv3x3_dw_bf16_slots": [ctypes.POINTER(ctypes.c_int)],
    "qv_synth_grid": [_LL],
    "qv_synth_batch": [
        _LL, QvDecodeConsts, _P, _I, QvSynthConsts, ctypes.c_ulonglong, _P,
        _P, _P, _P, _P, _P],
    "qv_synth_batch_trials": [
        _LL, _I, QvDecodeConsts, _P, _I, QvSynthConsts, _P, _P, _P, _P, _P,
        _P, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                           "kernels are built on the machine with the card")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build() -> Path:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libqbold_kernels_{_digest()}.so"
    if lib.is_file():
        return lib
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)       # released when closed
        if not lib.is_file():
            _compile(lib)
    return lib


def _compile(lib: Path) -> None:
    tag = f"tmp{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(s).stem}_{_digest()}.{tag}.o" for s in SOURCES]
    cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
            for s, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    tmp = lib.with_suffix(f".so.{tag}")
    link = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", str(tmp), *map(str, objs)]
    failed = [c for c, p in zip(cmds, procs) if p.returncode != 0]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True,
                              check=False)
        outs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed = [link]
    log = BUILD_DIR / (lib.stem + ".log")
    log.write_text("".join(" ".join(c) + "\n" + o
                           for c, o in zip(cmds + [link], outs)))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed: {' '.join(failed[0])}\n"
                           + log.read_text())
    os.replace(tmp, lib)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    lib = ctypes.CDLL(str(_build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.qv_error_string.argtypes = [ctypes.c_int]
    lib.qv_error_string.restype = ctypes.c_char_p
    return lib


def build_log() -> str:
    """nvcc's command line and ``--resource-usage`` report of the build
    that ``library()`` loaded (registers, shared memory, spills)."""
    return (BUILD_DIR / f"libqbold_kernels_{_digest()}.log").read_text()


def check(err: int, kernel: str) -> None:
    if err != 0:
        msg = library().qv_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({err})")


@functools.lru_cache(maxsize=None)
def quad_consts(device: torch.device) -> torch.Tensor:
    """The quadrature node table (ops/quadrature.py::QUAD_CONSTS) as a
    float32 tensor on ``device``, uploaded once per device."""
    from .quadrature import QUAD_CONSTS

    return torch.from_numpy(QUAD_CONSTS).to(device)
