"""The encoder trunk's 3x3 SAME convolution, forward and backward (kernel H).

The counterpart of ``qbold_vi_tpu/ops/pallas_conv.py::make_conv3x3``:
``nn.Conv((3, 3), padding="SAME")`` on channels-last x (N, H, W, Ci) with
weights (3, 3, Ci, Co) HWIO and bias (Co,), giving (N, H, W, Co), with a
closed-form backward for dx, dw and db. x, w and b share one dtype, the
activations': float32, or bfloat16 (the trunk at ``compute_dtype=
"bfloat16"``), where every sum is float32 and each output is rounded to
bf16 once -- y after the bias is added in float32, dx from its sums, dw
and db after their sums over all pixels (pallas_conv.py:105-113, 280-281).

* ``conv3x3_plain`` / ``conv3x3_grads_plain``: the plain torch versions --
  nine shifted products of the zero-padded input summed in float32, and
  their closed-form gradients (dx is the same sum on the cotangent with the
  taps flipped and transposed; dw and db are sums over all pixels);
* ``conv3x3_forward`` / ``conv3x3_backward``: the wrappers of the
  hand-written kernel ``csrc/conv3x3.cu`` (tensor cores: 3xTF32
  ``mma.sync`` products at float32 accuracy; at bf16, ``wgmma`` products
  with float32 sums from asynchronously staged bf16 strips and, in the
  forward and dx, weights resident in shared memory). A CUDA tensor
  launches it or raises; a CPU tensor runs the plain version.
  Launches are counted in ``conv3x3.fwd_launches`` and
  ``conv3x3.bwd_launches``, the bf16 kernels' in ``conv3x3.fwd_bf16_launches``
  and ``conv3x3.bwd_bf16_launches`` (a forward call launches the weight
  split -- at bf16 the weight image -- and the conv; one backward call
  launches dx with its weight split, when the input needs a gradient, and
  the two passes of dw and db);
* ``conv3x3``: the op as a ``torch.autograd.Function``.

The encoder keeps its conv weight OIHW (``nn.Conv2d``, the bridged
layout); the permute to HWIO happens in the caller, and the activations
stay NHWC, so the kernel path makes no activation transposes.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _cuda

__all__ = ["conv3x3_available", "conv3x3", "conv3x3_forward",
           "conv3x3_backward", "conv3x3_plain", "conv3x3_grads_plain"]

_DW_TILE = 128           # pixels the float32 dw/db pass stages at a time


def conv3x3_available(h: int, w: int) -> bool:
    """Planes smaller than the 3x3 window go to the library conv (the JAX
    package's rule, pallas_conv.py:85-88)."""
    return h >= 3 and w >= 3


def _taps(xp: torch.Tensor, h: int, w: int):
    """(dy, dx, the (N*H*W, C) view of padded xp shifted by the tap)."""
    c = xp.shape[-1]
    for dy in range(3):
        for dx in range(3):
            yield dy, dx, xp[:, dy:dy + h, dx:dx + w, :].reshape(-1, c)


def conv3x3_plain(x: torch.Tensor, w_hwio: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """y[n, h, w] = b + sum over the nine taps of xpad[n, h + dy, w + dx]
    @ w[dy, dx], in float32 (bf16 operands: their products summed and the
    bias added in float32, then one rounding to bf16)."""
    if x.dtype == torch.bfloat16:
        return conv3x3_plain(x.float(), w_hwio.float(), b.float()).to(x.dtype)
    n, h, wd, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    acc = None
    for dy, dx, xs in _taps(xp, h, wd):
        d = xs @ w_hwio[dy, dx]
        acc = d if acc is None else acc + d
    return (acc + b).reshape(n, h, wd, -1)


def conv3x3_grads_plain(x: torch.Tensor, w_hwio: torch.Tensor,
                        ct: torch.Tensor, need_dx: bool = True):
    """(dx or None, dw, db) of sum(ct * conv3x3_plain(x, w, b)); bf16
    operands: float32 sums, each gradient rounded to bf16 once."""
    if x.dtype == torch.bfloat16:
        grads = conv3x3_grads_plain(x.float(), w_hwio.float(), ct.float(),
                                    need_dx)
        return tuple(g if g is None else g.to(x.dtype) for g in grads)
    n, h, wd, ci = x.shape
    co = ct.shape[-1]
    dx = None
    if need_dx:
        # the flipped, transposed taps: wt[dy, dx] = w[2 - dy, 2 - dx].T
        wt = torch.flip(w_hwio, (0, 1)).transpose(2, 3)
        dx = conv3x3_plain(ct, wt, ct.new_zeros(ci))
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    ct2 = ct.reshape(-1, co)
    dw = torch.stack([xs.T @ ct2 for _, _, xs in _taps(xp, h, wd)])
    return dx, dw.reshape(3, 3, ci, co), ct2.sum(0)


def _check_shapes(x, w_hwio, b=None, ct=None):
    """The shapes the op takes, on every device; raises otherwise."""
    if x.ndim != 4 or w_hwio.shape != (3, 3, x.shape[-1], w_hwio.shape[-1]):
        raise ValueError(f"conv3x3 takes x (N, H, W, Ci) and w (3, 3, Ci, Co), "
                         f"got {tuple(x.shape)} and {tuple(w_hwio.shape)}")
    n, h, wd, _ = x.shape
    co = w_hwio.shape[-1]
    if not conv3x3_available(h, wd):
        raise ValueError(f"conv3x3 needs planes of at least 3 x 3, got "
                         f"{h} x {wd}")
    if b is not None and tuple(b.shape) != (co,):
        raise ValueError(f"bias must be ({co},), got {tuple(b.shape)}")
    if ct is not None and tuple(ct.shape) != (n, h, wd, co):
        raise ValueError(f"cotangent must be {(n, h, wd, co)}, got "
                         f"{tuple(ct.shape)}")


def _check_cuda(x, w_hwio, b=None, ct=None):
    """Device, dtype and layout the kernel takes; raises otherwise."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the conv3x3 kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    for t in (x, w_hwio, b, ct):
        if t is None:
            continue
        if t.device.type != "cuda" or t.dtype != x.dtype \
                or t.device != x.device:
            raise TypeError(f"the conv3x3 kernel takes tensors of one dtype "
                            f"on one CUDA device, got {t.dtype} on {t.device} "
                            f"beside {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError("the conv3x3 kernel takes contiguous tensors "
                             "(x and the cotangent NHWC, w HWIO)")


def _weight_scratch(x: torch.Tensor, cin: int, cout: int) -> torch.Tensor:
    """The kernel's weights for cin -> cout, as float32 words
    (csrc/conv3x3.cu): float32, qv_conv3x3_wsplit_kernel's fragments, 9 taps
    x ceil(cin / 8) k-steps x ceil(cout / 64) * 8 column tiles x 32 lanes x
    4 floats of 3xTF32 hi / lo pairs; bf16, qv_conv3x3_wimg_bf16_kernel's
    image, 9 taps of 64 x 64 bf16 for each chunk of 64 input and of 64
    output channels."""
    if x.dtype == torch.bfloat16:
        words = 9 * -(-cin // 64) * -(-cout // 64) * 64 * 64 // 2
    else:
        words = 9 * -(-cin // 8) * 8 * -(-cout // 64) * 32 * 4
    return torch.empty(words, device=x.device, dtype=torch.float32)


def _entry(name: str, x: torch.Tensor):
    """The C entry of kernel H's pass ``name`` for x's dtype."""
    lib = _cuda.library()
    return getattr(lib, name + ("_bf16" if x.dtype == torch.bfloat16
                                else ""))


@functools.lru_cache(maxsize=None)
def _dw_slots(device: torch.device, bf16: bool = False) -> int:
    """Blocks of the dw pass (float32 or bf16) that ``device`` runs at
    once."""
    slots = ctypes.c_int()
    fn = "qv_conv3x3_dw_bf16_slots" if bf16 else "qv_conv3x3_dw_slots"
    with torch.cuda.device(device):
        _cuda.check(getattr(_cuda.library(), fn)(ctypes.byref(slots)),
                    "conv3x3 dw occupancy")
    return slots.value


def _dw_chunk(np_: int, ci: int, co: int, slots: int,
              bf16: bool = False) -> int:
    """Pixels a dw block sums: a multiple of the kernel's tile, with as many
    chunks as make one wave of blocks (the channel tiles a chunk, times the
    3 tap rows of the float32 kernel, whose block sums one; the bf16
    kernel's sums all three over tiles of up to 256 pixels) where the
    pixels allow."""
    tile = 2 * _DW_TILE if bf16 else _DW_TILE
    blocks = (1 if bf16 else 3) * -(-ci // 64) * -(-co // 64)
    chunks = max(1, slots // blocks)
    return tile * -(-np_ // (tile * chunks))


def _device_of(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no conv3x3 kernel for device {x.device}")
    return x.device.type


def conv3x3_forward(x: torch.Tensor, w_hwio: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """(N, H, W, Co). CUDA: kernel H's forward (counted in
    ``conv3x3.fwd_launches``); CPU: the plain version."""
    _check_shapes(x, w_hwio, b)
    if _device_of(x) == "cpu":
        return conv3x3_plain(x, w_hwio, b)
    _check_cuda(x, w_hwio, b)
    n, h, wd, ci = x.shape
    co = w_hwio.shape[-1]
    y = x.new_empty((n, h, wd, co))
    if n == 0:
        return y
    with torch.cuda.device(x.device):
        err = _entry("qv_conv3x3_fwd", x)(
            x.data_ptr(), w_hwio.data_ptr(), b.data_ptr(),
            _weight_scratch(x, ci, co).data_ptr(), y.data_ptr(),
            n * h * wd, h, wd, ci, co,
            torch.cuda.current_stream(x.device).cuda_stream)
    _cuda.check(err, "conv3x3 forward")
    if x.dtype == torch.bfloat16:
        conv3x3.fwd_bf16_launches += 1
    else:
        conv3x3.fwd_launches += 1
    return y


def conv3x3_backward(x: torch.Tensor, w_hwio: torch.Tensor, ct: torch.Tensor,
                     need_dx: bool = True):
    """(dx or None, dw (3, 3, Ci, Co), db (Co,)) of sum(ct * conv(x, w, b)).
    CUDA: kernel H's dx pass (when ``need_dx``) and its two-pass dw/db
    reduction, counted once in ``conv3x3.bwd_launches``; the reduction adds
    its float32 partial sums in a fixed order (then rounds them to bf16
    for a bf16 x), so dw is the same bits in every run. CPU: the plain
    version."""
    _check_shapes(x, w_hwio, ct=ct)
    if _device_of(x) == "cpu":
        return conv3x3_grads_plain(x, w_hwio, ct, need_dx)
    _check_cuda(x, w_hwio, ct=ct)
    n, h, wd, ci = x.shape
    co = w_hwio.shape[-1]
    np_ = n * h * wd
    stream = torch.cuda.current_stream(x.device).cuda_stream
    dx = x.new_empty(x.shape) if need_dx else None
    out = (x.new_empty if np_ else x.new_zeros)(9 * ci * co + co)
    with torch.cuda.device(x.device):
        if need_dx and np_:
            _cuda.check(_entry("qv_conv3x3_dx", x)(
                ct.data_ptr(), w_hwio.data_ptr(),
                _weight_scratch(x, co, ci).data_ptr(), dx.data_ptr(), np_,
                h, wd, ci, co, stream), "conv3x3 dx")
        if np_:
            bf16 = x.dtype == torch.bfloat16
            chunk = _dw_chunk(np_, ci, co, _dw_slots(x.device, bf16), bf16)
            nb = -(-np_ // chunk)
            part = torch.empty((nb, out.numel()), device=x.device,
                               dtype=torch.float32)
            _cuda.check(_entry("qv_conv3x3_dw", x)(
                x.data_ptr(), ct.data_ptr(), part.data_ptr(), out.data_ptr(),
                np_, h, wd, ci, co, chunk, nb, stream), "conv3x3 dw/db")
    if x.dtype == torch.bfloat16:
        conv3x3.bwd_bf16_launches += 1
    else:
        conv3x3.bwd_launches += 1
    return dx, out[:9 * ci * co].view(3, 3, ci, co), out[9 * ci * co:]


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_hwio, b):
        ctx.save_for_backward(x, w_hwio)
        return conv3x3_forward(x, w_hwio, b)

    @staticmethod
    def backward(ctx, ct):
        x, w_hwio = ctx.saved_tensors
        need = ctx.needs_input_grad
        if x.device.type == "cuda":
            ct = ct.contiguous()
        dx, dw, db = conv3x3_backward(x, w_hwio, ct, need_dx=need[0])
        return dx, (dw if need[1] else None), (db if need[2] else None)


def conv3x3(x: torch.Tensor, w_hwio: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv of x (N, H, W, Ci) with w (3, 3, Ci, Co) and b (Co,),
    differentiable in all three: kernel H on a CUDA tensor, the plain
    version on a CPU tensor."""
    return _Conv3x3.apply(x, w_hwio, b)


conv3x3.fwd_launches = conv3x3.bwd_launches = 0
conv3x3.fwd_bf16_launches = conv3x3.bwd_bf16_launches = 0
