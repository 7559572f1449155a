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
* Activations stay channels-last, as in the JAX package; the conv sees
  an NCHW view in channels-last memory, so no copy is made around it.

Numerics: the trunk runs in float32 ("auto" resolves to float32, as the
JAX package does off TPU; "bfloat16" is not ported yet and raises).
cuDNN runs float32 convolutions in TF32 by default on Hopper, which
keeps about three decimal digits; ``forward`` therefore turns TF32 off
for both cuDNN and matmuls for its duration (``_full_fp32``) and
restores the caller's settings afterwards.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig

__all__ = ["Encoder", "GatedResBlock", "ConvXY", "normalise_data",
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


def activation_fn(name: str):
    """The torch form of a flax activation name (``nn.gelu`` is the tanh
    approximation; ``leaky_relu``'s slope is 0.01, as in ``jax.nn``)."""
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
    if cfg.compute_dtype in ("auto", "float32"):
        return torch.float32
    if cfg.compute_dtype == "bfloat16":
        raise NotImplementedError(
            "compute_dtype='bfloat16' is not ported yet (ROADMAP.md, "
            "Queue 2: kernel B's bf16 trunk)")
    raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}")


@contextlib.contextmanager
def _full_fp32():
    """Run float32 convs and matmuls in full float32 (no TF32)."""
    cudnn = torch.backends.cudnn.allow_tf32
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul


class ConvXY(nn.Module):
    """3x3x1 'Conv3D' as a z-folded 2-D conv on channels-last input:
    5-D (B, X, Y, Z, C) (folded and unfolded around the conv) or already
    folded 4-D (B*Z, X, Y, C)."""

    def __init__(self, features: int, *, device=None):
        super().__init__()
        self.Conv_0 = nn.Conv2d(features, features, 3, padding=1,
                                device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 4:
            y = self.Conv_0(x.permute(0, 3, 1, 2))
            return y.permute(0, 2, 3, 1)
        b, h, w, d, c = x.shape
        x2 = x.permute(0, 3, 1, 2, 4).reshape(b * d, h, w, c)
        y = self.forward(x2)
        return y.reshape(b, d, h, w, -1).permute(0, 2, 3, 1, 4)


class _GroupNorm1(nn.Module):
    """flax GroupNorm(num_groups=1) on channels-last input: statistics
    over all non-batch axes, variance as E[x^2] - E[x]^2 clipped at 0,
    epsilon 1e-6, per-channel scale and bias."""

    def __init__(self, features: int, *, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = tuple(range(1, x.ndim))
        mean = x.mean(dim=dims, keepdim=True)
        mean2 = (x * x).mean(dim=dims, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + 1e-6) * self.scale
        return (x - mean) * mul + self.bias


class GatedResBlock(nn.Module):
    """One two-stream block (reference model.py:142-174): stream 1 is
    act(shared(net1)); stream 2 blends act(shared(net2)) with a residual
    path of two 3x3x1 convs by a learned sigmoid gate. Dropout is an
    identity at inference and is not ported yet (training)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        u = cfg.no_units
        self.cfg = cfg
        self.act = activation_fn(cfg.activation)
        self.Dense_0 = nn.Linear(u, u, device=device)       # shared
        self.ConvXY_0 = ConvXY(u, device=device)
        self.ConvXY_1 = ConvXY(u, device=device)
        self.Dense_1 = nn.Linear(u, u if cfg.channelwise_gating else 1,
                                 device=device)              # gate
        if cfg.use_layer_norm:
            self.GroupNorm_0 = _GroupNorm1(u, device=device)
            self.GroupNorm_1 = _GroupNorm1(u, device=device)

    def stream1(self, net1: torch.Tensor) -> torch.Tensor:
        return self.act(self.Dense_0(net1))

    def forward(self, net1, net2):
        cfg, act = self.cfg, self.act
        out1 = self.stream1(net1)
        skip = act(self.Dense_0(net2))
        h = self.GroupNorm_0(net2) if cfg.use_layer_norm else net2
        h = self.ConvXY_0(act(h))
        if cfg.use_layer_norm:
            h = self.GroupNorm_1(h)
        h = self.ConvXY_1(act(h))
        gate = torch.sigmoid(self.Dense_1(h) + cfg.gate_offset)
        out2 = skip * (1.0 - gate) + h * gate
        return out1, out2


class Encoder(nn.Module):
    """The full encoder (reference outer model, model.py:122-223).

    ``forward(images)`` returns (dist_params, dist_params_neighbourhood,
    im_sigma): 4 (diag) or 5 (mvg) channels, + 4 exp(hyperprior)
    channels on stream 1 when ``infer_inv_gamma``."""

    def __init__(self, cfg: ModelConfig, n_taus: int, se_idx: int, *,
                 device=None):
        super().__init__()
        _dtype_of(cfg)
        u = cfg.no_units
        self.cfg, self.n_taus, self.se_idx = cfg, n_taus, se_idx
        self.act = activation_fn(cfg.activation)
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
        return self.act(self.first_conv(x))

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
            return self._hyper(self.final(h))

    def forward(self, images: torch.Tensor):
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
                net1, net2 = blk(net1, net2)
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
