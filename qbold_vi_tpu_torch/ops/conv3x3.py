"""The encoder trunk's 3x3 SAME convolution, forward and backward (kernel H).

The counterpart of ``qbold_vi_tpu/ops/pallas_conv.py::make_conv3x3``:
``nn.Conv((3, 3), padding="SAME")`` on channels-last float32 x (N, H, W, Ci)
with weights (3, 3, Ci, Co) HWIO and bias (Co,), giving (N, H, W, Co), with
a closed-form backward for dx, dw and db.

* ``conv3x3_plain`` / ``conv3x3_grads_plain``: the plain torch versions --
  nine shifted products of the zero-padded input summed in float32, and
  their closed-form gradients (dx is the same sum on the cotangent with the
  taps flipped and transposed; dw and db are sums over all pixels);
* ``conv3x3_forward`` / ``conv3x3_backward``: the wrappers of the
  hand-written kernel ``csrc/conv3x3.cu`` (tensor cores, 3xTF32 products:
  float32 accuracy). A CUDA tensor launches it or raises; a CPU tensor
  runs the plain version. Launches are counted in ``conv3x3.fwd_launches``
  and ``conv3x3.bwd_launches`` (a forward call launches the weight split
  and the conv; one backward call launches dx with its weight split, when
  the input needs a gradient, and the two passes of dw and db);
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

_DW_TILE = 128           # pixels the dw/db pass stages at a time


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
    @ w[dy, dx], in float32."""
    n, h, wd, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    acc = None
    for dy, dx, xs in _taps(xp, h, wd):
        d = xs @ w_hwio[dy, dx]
        acc = d if acc is None else acc + d
    return (acc + b).reshape(n, h, wd, -1)


def conv3x3_grads_plain(x: torch.Tensor, w_hwio: torch.Tensor,
                        ct: torch.Tensor, need_dx: bool = True):
    """(dx or None, dw, db) of sum(ct * conv3x3_plain(x, w, b))."""
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
    for t in (x, w_hwio, b, ct):
        if t is None:
            continue
        if t.device.type != "cuda" or t.dtype != torch.float32 \
                or t.device != x.device:
            raise TypeError(f"the conv3x3 kernel takes float32 tensors on one "
                            f"CUDA device, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError("the conv3x3 kernel takes contiguous tensors "
                             "(x and the cotangent NHWC, w HWIO)")


def _weight_scratch(x: torch.Tensor, cin: int, cout: int) -> torch.Tensor:
    """The kernel's 3xTF32 weight fragments for cin -> cout: 9 taps x
    ceil(cin / 8) k-steps x ceil(cout / 64) * 8 column tiles x 32 lanes x
    4 floats (csrc/conv3x3.cu, qv_conv3x3_wsplit_kernel)."""
    return x.new_empty(9 * -(-cin // 8) * 8 * -(-cout // 64) * 32 * 4)


@functools.lru_cache(maxsize=None)
def _dw_slots(device: torch.device) -> int:
    """Blocks of the dw pass that ``device`` runs at once."""
    slots = ctypes.c_int()
    with torch.cuda.device(device):
        _cuda.check(_cuda.library().qv_conv3x3_dw_slots(ctypes.byref(slots)),
                    "conv3x3 dw occupancy")
    return slots.value


def _dw_chunk(np_: int, ci: int, co: int, slots: int) -> int:
    """Pixels a dw block sums: a multiple of the tile, with as many chunks as
    make one wave of blocks (3 tap rows x the channel tiles a chunk) where
    the pixels allow."""
    blocks = 3 * -(-ci // 64) * -(-co // 64)
    chunks = max(1, slots // blocks)
    return _DW_TILE * -(-np_ // (_DW_TILE * chunks))


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
        err = _cuda.library().qv_conv3x3_fwd(
            x.data_ptr(), w_hwio.data_ptr(), b.data_ptr(),
            _weight_scratch(x, ci, co).data_ptr(), y.data_ptr(),
            n * h * wd, h, wd, ci, co,
            torch.cuda.current_stream(x.device).cuda_stream)
    _cuda.check(err, "conv3x3 forward")
    conv3x3.fwd_launches += 1
    return y


def conv3x3_backward(x: torch.Tensor, w_hwio: torch.Tensor, ct: torch.Tensor,
                     need_dx: bool = True):
    """(dx or None, dw (3, 3, Ci, Co), db (Co,)) of sum(ct * conv(x, w, b)).
    CUDA: kernel H's dx pass (when ``need_dx``) and its two-pass dw/db
    reduction, counted once in ``conv3x3.bwd_launches``; the reduction adds
    its partial sums in a fixed order, so dw is the same bits in every run.
    CPU: the plain version."""
    _check_shapes(x, w_hwio, ct=ct)
    if _device_of(x) == "cpu":
        return conv3x3_grads_plain(x, w_hwio, ct, need_dx)
    _check_cuda(x, w_hwio, ct=ct)
    n, h, wd, ci = x.shape
    co = w_hwio.shape[-1]
    np_ = n * h * wd
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _cuda.library()
    dx = x.new_empty(x.shape) if need_dx else None
    out = (x.new_empty if np_ else x.new_zeros)(9 * ci * co + co)
    with torch.cuda.device(x.device):
        if need_dx and np_:
            _cuda.check(lib.qv_conv3x3_dx(ct.data_ptr(), w_hwio.data_ptr(),
                                          _weight_scratch(x, co, ci)
                                          .data_ptr(), dx.data_ptr(), np_,
                                          h, wd, ci, co, stream),
                        "conv3x3 dx")
        if np_:
            chunk = _dw_chunk(np_, ci, co, _dw_slots(x.device))
            nb = -(-np_ // chunk)
            part = x.new_empty((nb, out.numel()))
            _cuda.check(lib.qv_conv3x3_dw(x.data_ptr(), ct.data_ptr(),
                                          part.data_ptr(), out.data_ptr(),
                                          np_, h, wd, ci, co, chunk, nb,
                                          stream), "conv3x3 dw/db")
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


conv3x3.fwd_launches = 0
conv3x3.bwd_launches = 0
