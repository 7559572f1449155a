"""Voxelwise two-stream encoder (PyTorch).

The counterpart of ``qbold_vi_tpu/models/encoder.py`` (flax), with the
same architecture and a parameter tree whose names follow flax's, so the
weight bridge (io/from_jax.py) is a rename and a transpose:

* 1x1x1 convolutions are ``nn.Linear`` on the trailing channel axis.
* The 3x3x1 convolution is a 2-D 3x3 convolution with z folded into the
  batch. The fold is hoisted once ahead of the trunk (every op between
  the embed and the heads is voxelwise or the z-folded conv), except
  under ``use_layer_norm``: GroupNorm(groups=1) pools over the whole
  (X, Y, Z, C) crop, so that configuration keeps the 5-D path.
* Activations stay channels-last, as in the JAX package. ``fused_conv``
  routes the 3x3 conv as the JAX package's ``_ConvImpl`` does
  (qbold_vi_tpu/models/encoder.py:83-127): "on" and "interpret" run kernel
  H (ops/conv3x3.py; its plain version on a CPU tensor) on the NHWC
  activations and the HWIO view of the OIHW weight; "auto" and "off" run
  cuDNN on an NCHW view (in bf16 with the bias added after the rounding,
  as flax's nn.Conv adds it). A plane smaller than 3 x 3 raises under "on"
  and "interpret" (the JAX package silently takes nn.Conv under "on";
  the port's forced modes raise, as ``fused_elbo`` and
  ``fused_decode_nll`` do). The parameters are ``nn.Conv2d``'s either
  way, so the bridge and saved state_dicts do not see the flag.

Numerics: ``compute_dtype`` sets the trunk's dtype (``_dtype_of``):
"auto" and "float32" resolve to float32, as the JAX package resolves
"auto" off the TPU, and "bfloat16" runs the trunk in bf16 as flax's
``dtype=jnp.bfloat16`` does. The parameters stay float32; each trunk
layer (the first Dense, each block's shared and gate Dense, both 3x3
convs) casts its input, weight and bias to bf16, so a gradient flows
back through those casts and reaches a float32 parameter rounded to
bf16. A Dense rounds its float32 sums to bf16 and then adds the bf16
bias in bf16 (``_dense``); activations, the gate's sigmoid and the
blend run in bf16; GroupNorm takes its statistics in float32 and, as
flax's does with float32 parameters, returns float32; the heads run in
float32 on the float32-cast features. cuDNN runs float32 convolutions
in TF32 by default on Hopper, which keeps about three decimal digits,
and cuBLAS may reduce bf16 products in bf16 (split-K); ``forward``
therefore turns TF32 and reduced-precision bf16 reductions off for its
duration (``_full_fp32``) and restores the caller's settings afterwards.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig, normalize_mode
from ..ops.conv3x3 import conv3x3, conv3x3_available

__all__ = ["Encoder", "GatedResBlock", "ConvXY", "Dropout", "normalise_data",
           "activation_fn"]


def normalise_data(data: torch.Tensor, se_idx: int,
                   multi_image: bool) -> torch.Tensor:
    """Clip, divide by the mean of the spin-echo(-adjacent) images, log
    (reference model.py:97-113)."""
    data = torch.clamp(data, 1e-2, 1e8)
    if multi_image:
        ref = torch.mean(data[..., max(se_idx - 1, 0):se_idx + 2], dim=-1,
                         keepdim=True)
    else:
        ref = data[..., se_idx:se_idx + 1]
    return torch.log(data / ref)


def _sigmoid_steps(x):
    return 1.0 / (1.0 + torch.exp(-x))


def _const(value: float, x: torch.Tensor) -> torch.Tensor:
    """A constant in x's dtype, as JAX rounds a weak-typed Python float
    (torch would keep a Python scalar in float32 on the card)."""
    return torch.tensor(value, dtype=x.dtype, device=x.device)


def _gelu_steps(x):
    inner = x + _const(0.044715, x) * (x * x * x)
    return x * (0.5 * (1.0 + torch.tanh(_const(math.sqrt(2.0 / math.pi), x)
                                        * inner)))


# jax.nn's definitions, one torch op a step: in bf16 each step rounds where
# JAX's rounds (sigmoid 1 / (1 + exp(-x)), softplus logaddexp(x, 0), gelu's
# tanh form, leaky_relu's slope rounded to bf16); in float32 the single ops
# below agree to float32 rounding
_STEPS = {
    "sigmoid": _sigmoid_steps,
    "softplus": lambda x: torch.clamp(x, min=0.0)
    + torch.log1p(torch.exp(-torch.abs(x))),
    "gelu": _gelu_steps,
    "silu": lambda x: x * _sigmoid_steps(x),
    "swish": lambda x: x * _sigmoid_steps(x),
    "leaky_relu": lambda x: torch.where(x >= 0, x, _const(0.01, x) * x),
}


def activation_fn(name: str, dtype: torch.dtype = torch.float32):
    """The torch form of a flax activation name (``nn.gelu`` is the tanh
    approximation; ``leaky_relu``'s slope is 0.01, as in ``jax.nn``). For
    a bf16 trunk the compositions of ``jax.nn`` step by step, so that each
    intermediate rounds to bf16 as the JAX package's does."""
    if dtype != torch.float32 and name in _STEPS:
        return _STEPS[name]
    table = {
        "relu": F.relu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "tanh": torch.tanh,
        "sigmoid": torch.sigmoid,
        "softplus": F.softplus,
        "elu": F.elu,
        "silu": F.silu,
        "swish": F.silu,
        "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
        "relu6": F.relu6,
        "linear": lambda x: x,
    }
    if name not in table:
        raise ValueError(f"unknown activation {name!r}")
    return table[name]


def _dtype_of(cfg: ModelConfig) -> torch.dtype:
    """The trunk's dtype: "auto" is float32 (the JAX package's "auto" off
    the TPU), "bfloat16" bf16; anything else raises."""
    if cfg.compute_dtype in ("auto", "float32"):
        return torch.float32
    if cfg.compute_dtype == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}")


@contextlib.contextmanager
def _full_fp32():
    """Run float32 convs and matmuls in full float32 (no TF32), and bf16
    matmuls with float32 reductions."""
    matmul = torch.backends.cuda.matmul
    saved = (torch.backends.cudnn.allow_tf32, matmul.allow_tf32,
             matmul.allow_bf16_reduced_precision_reduction)
    torch.backends.cudnn.allow_tf32 = False
    matmul.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, matmul.allow_tf32,
         matmul.allow_bf16_reduced_precision_reduction) = saved


def _dense(layer: nn.Linear, x: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: in float32 the layer itself; in
    bf16 the input, weight and bias cast to bf16, the product's float32
    sums rounded to bf16, then the bias added in bf16."""
    if dtype == torch.float32:
        return layer(x)
    return F.linear(x.to(dtype), layer.weight.to(dtype)) \
        + layer.bias.to(dtype)


class ConvXY(nn.Module):
    """3x3x1 'Conv3D' as a z-folded 2-D conv on channels-last input:
    5-D (B, X, Y, Z, C) (folded and unfolded around the conv) or already
    folded 4-D (B*Z, X, Y, C). ``fused`` is cfg.fused_conv; ``dtype`` the
    trunk's: the input, weight and bias are cast to it."""

    def __init__(self, features: int, *, fused: str = "off",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.fused = normalize_mode(fused, ("auto", "on", "off", "interpret"),
                                    "fused_conv")
        self.dtype = dtype
        self.Conv_0 = nn.Conv2d(features, features, 3, padding=1,
                                device=device)

    def _use_kernel(self, h: int, w: int) -> bool:
        # "auto" is off: the JAX package keeps its conv kernel off unless
        # forced (qbold_vi_tpu/models/encoder.py:90-96)
        if self.fused in ("auto", "off"):
            return False
        if not conv3x3_available(h, w):
            raise ValueError(f"fused_conv was forced to {self.fused!r} but "
                             "the plane is smaller than the 3x3 window: "
                             f"{h} x {w}")
        return True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 4:
            dt = self.dtype
            x = x.to(dt)
            w, b = self.Conv_0.weight.to(dt), self.Conv_0.bias.to(dt)
            if self._use_kernel(x.shape[1], x.shape[2]):
                return conv3x3(x.contiguous(),
                               w.permute(2, 3, 1, 0).contiguous(), b)
            x = x.permute(0, 3, 1, 2)
            if dt == torch.float32:
                y = F.conv2d(x, w, b, padding=1)
            else:   # nn.Conv(dtype=bf16): rounded to bf16, then the bias
                y = F.conv2d(x, w, None, padding=1) + b[:, None, None]
            return y.permute(0, 2, 3, 1)
        b, h, w, d, c = x.shape
        x2 = x.permute(0, 3, 1, 2, 4).reshape(b * d, h, w, c)
        y = self.forward(x2)
        return y.reshape(b, d, h, w, -1).permute(0, 2, 3, 1, 4)


class _GroupNorm1(nn.Module):
    """flax GroupNorm(num_groups=1) on channels-last input: statistics
    over all non-batch axes, variance as E[x^2] - E[x]^2 clipped at 0,
    epsilon 1e-6, per-channel scale and bias. A bf16 input is taken in
    float32 and the output is float32, as flax promotes it with the
    float32 parameters."""

    def __init__(self, features: int, *, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        dims = tuple(range(1, x.ndim))
        mean = x.mean(dim=dims, keepdim=True)
        mean2 = (x * x).mean(dim=dims, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + 1e-6) * self.scale
        return (x - mean) * mul + self.bias


class Dropout:
    """flax ``nn.Dropout(rate)`` in a training pass (``deterministic=False``):
    each unit is kept with probability 1 - rate and scaled by 1 / (1 -
    rate), the rest are zeroed; rate 1 zeroes everything and draws
    nothing. The scale is a division by the keep rate in the activation's
    dtype, as flax divides by a weak-typed Python float (in bf16 by
    bf16(0.9) = 0.8984375 at rate 0.1).

    Each call takes the next mask: drawn as ``torch.rand(shape) < 1 - rate``
    from ``generator`` (a generator of the activations' device), or taken
    from ``masks``, booleans of each activation's shape in the order the
    trunk asks for them (two a block, block 0 first: before its first and
    second GroupNorm position), which is how a test injects the masks the
    JAX package drew."""

    def __init__(self, rate: float, *, generator: torch.Generator = None,
                 masks=None):
        if (generator is None) == (masks is None):
            raise ValueError("Dropout takes a generator or its masks")
        self.rate = float(rate)
        self.generator = generator
        self._masks = None if masks is None else iter(masks)

    def _mask(self, h: torch.Tensor) -> torch.Tensor:
        if self._masks is None:
            return torch.rand(h.shape, generator=self.generator,
                              device=h.device) < 1.0 - self.rate
        try:
            m = torch.as_tensor(next(self._masks), device=h.device)
        except StopIteration:
            raise ValueError("the trunk asked for more dropout masks than "
                             "were given") from None
        if m.shape != h.shape:
            raise ValueError(f"dropout mask of shape {tuple(m.shape)} for "
                             f"an activation of shape {tuple(h.shape)}")
        return m.to(torch.bool)

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        if self.rate >= 1.0:
            return torch.zeros_like(h)
        return torch.where(self._mask(h), h / _const(1.0 - self.rate, h),
                           _const(0.0, h))


class GatedResBlock(nn.Module):
    """One two-stream block (reference model.py:142-174): stream 1 is
    act(shared(net1)); stream 2 blends act(shared(net2)) with a residual
    path of two 3x3x1 convs by a learned sigmoid gate. A training pass's
    ``dropout`` acts where flax's ``norm_drop`` puts it: on the residual
    path's input and on the first conv's output, each before its GroupNorm
    position; stream 1 and the skip never see it."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        u = cfg.no_units
        self.cfg = cfg
        self.dtype = dt = _dtype_of(cfg)
        self.act = activation_fn(cfg.activation, dt)
        self.sigmoid = activation_fn("sigmoid", dt)
        self.Dense_0 = nn.Linear(u, u, device=device)       # shared
        self.ConvXY_0 = ConvXY(u, fused=cfg.fused_conv, dtype=dt,
                               device=device)
        self.ConvXY_1 = ConvXY(u, fused=cfg.fused_conv, dtype=dt,
                               device=device)
        self.Dense_1 = nn.Linear(u, u if cfg.channelwise_gating else 1,
                                 device=device)              # gate
        if cfg.use_layer_norm:
            self.GroupNorm_0 = _GroupNorm1(u, device=device)
            self.GroupNorm_1 = _GroupNorm1(u, device=device)

    def stream1(self, net1: torch.Tensor) -> torch.Tensor:
        return self.act(_dense(self.Dense_0, net1, self.dtype))

    def forward(self, net1, net2, dropout: Dropout = None):
        cfg, act = self.cfg, self.act
        out1 = self.stream1(net1)
        skip = act(_dense(self.Dense_0, net2, self.dtype))
        h = net2 if dropout is None else dropout(net2)
        if cfg.use_layer_norm:
            h = self.GroupNorm_0(h)
        h = self.ConvXY_0(act(h))
        if dropout is not None:
            h = dropout(h)
        if cfg.use_layer_norm:
            h = self.GroupNorm_1(h)
        h = self.ConvXY_1(act(h))
        gate = self.sigmoid(_dense(self.Dense_1, h, self.dtype)
                            + cfg.gate_offset)
        out2 = skip * (1.0 - gate) + h * gate
        return out1, out2


class Encoder(nn.Module):
    """The full encoder (reference outer model, model.py:122-223).

    ``forward(images, dropout=None)`` returns (dist_params,
    dist_params_neighbourhood, im_sigma): 4 (diag) or 5 (mvg) channels,
    + 4 exp(hyperprior) channels on stream 1 when ``infer_inv_gamma``.
    ``dropout`` (a ``Dropout``) makes it a training pass; its masks have
    the trunk's shape, (B*Z, X, Y, U) where the trunk is z-folded and
    (B, X, Y, Z, U) under ``use_layer_norm``, as the JAX encoder's."""

    def __init__(self, cfg: ModelConfig, n_taus: int, se_idx: int, *,
                 device=None):
        super().__init__()
        self.dtype = _dtype_of(cfg)
        u = cfg.no_units
        self.cfg, self.n_taus, self.se_idx = cfg, n_taus, se_idx
        self.act = activation_fn(cfg.activation, self.dtype)
        self.first_conv = nn.Linear(n_taus, u, device=device)
        for i in range(cfg.no_intermediate_layers):
            self.add_module(f"block_{i}", GatedResBlock(cfg, device=device))
        self.final = nn.Linear(u, 5 if cfg.use_mvg else 4, device=device)
        self.sigma_head = nn.Linear(u, n_taus, device=device)
        if cfg.infer_inv_gamma:
            self.inv_gamma_raw = nn.Parameter(torch.empty(4, device=device))

    @property
    def blocks(self) -> list:
        return [getattr(self, f"block_{i}")
                for i in range(self.cfg.no_intermediate_layers)]

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """Raw images (..., T) -> post-first-conv features (..., U)."""
        x = normalise_data(images, self.se_idx,
                           self.cfg.multi_image_normalisation)
        return self.act(_dense(self.first_conv, x, self.dtype))

    def _hyper(self, out1: torch.Tensor) -> torch.Tensor:
        if not self.cfg.infer_inv_gamma:
            return out1
        hyper = torch.exp(self.inv_gamma_raw)
        return torch.cat([out1, torch.ones_like(out1[..., :4]) * hyper], -1)

    def stream1(self, images: torch.Tensor) -> torch.Tensor:
        """Stream 1 alone (voxelwise): the first output of ``forward``
        without the conv trunk of stream 2."""
        with _full_fp32():
            h = self.embed(images)
            for blk in self.blocks:
                h = blk.stream1(h)
            return self._hyper(self.final(h.float()))

    def forward(self, images: torch.Tensor, dropout: Dropout = None):
        with _full_fp32():
            features = self.embed(images)
            fold = features.ndim == 5 and not self.cfg.use_layer_norm
            if fold:
                b, h, w, d, c = features.shape
                features = features.permute(0, 3, 1, 2, 4).reshape(
                    b * d, h, w, c)

                def unfold(y):
                    return y.reshape(b, d, h, w, -1).permute(0, 2, 3, 1, 4)
            else:
                def unfold(y):
                    return y
            net1 = net2 = features
            for blk in self.blocks:
                net1, net2 = blk(net1, net2, dropout)
            # the heads run in float32 on the float32-cast features
            net1, net2 = net1.float(), net2.float()
            out1 = self._hyper(unfold(self.final(net1)))
            out2 = unfold(self.final(net2))
            sigma = unfold(torch.exp(self.sigma_head(net2)))
        return out1, out2, sigma


def he_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator):
    """flax's he_normal: truncated normal at +-2 std, variance 2/fan_in."""
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def _normal_(w: torch.Tensor, std: float, generator: torch.Generator):
    with torch.no_grad():
        return w.normal_(0.0, std, generator=generator)


def init_encoder_(enc: Encoder, generator: torch.Generator) -> Encoder:
    """Initialise ``enc`` in place with flax's initialisers (same shapes
    and distributions as the JAX package; not the same numbers)."""
    cfg = enc.cfg
    with torch.no_grad():
        he_normal_(enc.first_conv.weight, enc.n_taus, generator)
        enc.first_conv.bias.zero_()
        for blk in enc.blocks:
            he_normal_(blk.Dense_0.weight, cfg.no_units, generator)
            blk.Dense_0.bias.zero_()
            for conv in (blk.ConvXY_0.Conv_0, blk.ConvXY_1.Conv_0):
                _normal_(conv.weight, cfg.resid_init_std, generator)
                conv.bias.zero_()
            _normal_(blk.Dense_1.weight, cfg.resid_init_std, generator)
            blk.Dense_1.bias.zero_()
            if cfg.use_layer_norm:
                for gn in (blk.GroupNorm_0, blk.GroupNorm_1):
                    gn.scale.fill_(1.0)
                    gn.bias.zero_()
        he_normal_(enc.final.weight, cfg.no_units, generator)
        enc.final.bias.zero_()
        _normal_(enc.sigma_head.weight, cfg.resid_init_std, generator)
        enc.sigma_head.bias.fill_(math.log(cfg.im_loss_sigma))
        if cfg.infer_inv_gamma:
            enc.inv_gamma_raw.copy_(torch.log(torch.tensor(
                [20.0, 2.5, 20.0, 2.5])))
    return enc
