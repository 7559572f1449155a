"""Tau-protocol transfer: retarget a trained encoder to a new tau grid.

The counterpart of ``qbold_vi_tpu/models/transfer.py`` (reference
model.py:183,216-223; the pt_transfer_model.h5 / transfer_model.h5 weight
files at train.py:195-196). Everything after the first 1x1x1 conv is
tau-count-agnostic; only the first conv (n_taus -> no_units) and the
heteroscedastic sigma head (no_units -> n_taus) belong to the protocol.
``transfer_params`` keeps the trained trunk (blocks, final head and the
hyperprior where there is one) and initialises those two layers afresh.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig, ScanParams
from .vi import init_params

__all__ = ["transfer_params"]

_PROTOCOL_LAYERS = ("first_conv", "sigma_head")


def transfer_params(generator: torch.Generator, trained: dict,
                    cfg: ModelConfig, new_scan: ScanParams,
                    sample_images) -> dict:
    """A FineTuner state_dict for ``new_scan``'s tau grid from the
    state_dict ``trained`` of the old protocol: every encoder tensor
    outside ``first_conv`` and ``sigma_head`` is ``trained``'s own (the
    same tensors), those two layers are drawn afresh by ``init_params``
    (``models.encoder.init_encoder_``) from ``generator`` (a CPU
    generator), and ``pop_prior`` / ``log_sigma`` are ``trained``'s, or
    fresh where the config asks for them and ``trained`` lacks them (JAX
    transfer.py:40-48). ``sample_images`` (..., new n_taus), an example
    batch, is checked against the new grid (the JAX function infers the
    new shapes from it)."""
    n_taus = tuple(sample_images.shape)[-1]
    if n_taus != new_scan.n_taus:
        raise ValueError(f"sample_images carry {n_taus} taus, the new "
                         f"protocol {new_scan.n_taus}")
    fresh = init_params(cfg, new_scan, generator)
    out = {}
    for name, tensor in fresh.items():
        parts = name.split(".")
        if parts[0] == "encoder":
            keep = parts[1] not in _PROTOCOL_LAYERS and name in trained
        else:
            keep = name in trained
        out[name] = trained[name] if keep else tensor
    return out
