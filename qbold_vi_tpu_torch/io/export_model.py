"""Serialized serving artifacts: ``torch.export`` inference programs.

The counterpart of ``qbold_vi_tpu/io/export_model.py``, with
``torch.export`` (``.pt2`` files) in place of ``jax.export`` (StableHLO):
``export_inference`` traces the full-brain posterior-map program --
masking, in-model normalisation, the encoder, the deterministic
quadrature summaries, the math of ``infer.posterior_maps``'s default
estimator -- with the trained weights inside the artifact, and
``save_exported`` / ``load_exported`` write and read it.

* **The default artifact** is shape-polymorphic over ``(s, x, y, z)``
  (``torch.export.Dim``s, x and y >= 3 for the in-plane convs; the tau
  axis stays static: another tau grid is another protocol, hence another
  transferred model). It takes ``(s, x, y, z, n_taus + 1)`` volumes whose
  last channel is the brain mask and returns ``posterior_maps``' dict
  (oef, dbv, r2p, stds, raw_log_stds). It runs the plain torch versions
  (the convs by the library conv, the quadrature by
  ``ops.quadrature.posterior_summaries_quadrature``) and calls no custom
  op, so it loads and runs without this package, on the CPU and on the
  card (``load_exported(path, device=...)`` moves it) -- as the JAX
  package's default artifact holds no Pallas kernel.
* **``fused=True``** exports kernel B through its registered op
  ``torch.ops.qbold_vi_tpu_torch.encode_quad_fused`` (ops/fused_infer.py):
  channel-major ``(n_taus + 1, N)`` input with N baked in, as the JAX
  fused blob bakes its grid, channel-major maps ``{"means" (3, N),
  "stds" (3, N), "raw_log_stds" (2|3, N)}``; stream 1 only. Deviation
  from the JAX package, whose fused blob needs nothing but jax: this
  artifact runs only on the card and only in a process that has imported
  ``qbold_vi_tpu_torch`` (which registers the op) before
  ``torch.export.load`` reads it.

The encoder's convolutions run in float32 without TF32: the callable that
``load_exported`` returns turns cuDNN's TF32 off around each call, as the
encoder's own forward does (a bare ``torch.export.load(...).module()``
runs with whatever the process's cuDNN settings are).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import torch
from torch import nn

from ..infer import _quad_kwargs, _raw_log_stds
from ..models.encoder import _full_fp32
from ..models.vi import FineTuner
from ..ops.fused_infer import (_weight_blob, encode_quad_fused_op,
                               fused_infer_available)
from ..ops.quadrature import posterior_summaries_quadrature

__all__ = ["make_serving_fn", "make_fused_serving_fn", "export_inference",
           "save_exported", "load_exported", "PLATFORMS"]

PLATFORMS = ("cuda", "cpu")


class _Serving(nn.Module):
    """The default artifact's program: volume (S, X, Y, Z, T + 1) ->
    posterior_maps' dict, the weights those of a copy of the tuner whose
    convolutions take the library conv (``fused_conv="off"``: kernel H is
    a ctypes launch, which no exported program holds)."""

    def __init__(self, tuner: FineTuner, use_first_op: bool):
        super().__init__()
        cfg = dataclasses.replace(tuner.cfg, fused_conv="off")
        self.tuner = FineTuner(cfg, tuner.scan, device=tuner.device,
                               full_model=tuner.full_model,
                               use_blood=tuner.use_blood)
        self.tuner.load_state_dict(tuner.state_dict())
        self.use_first_op = use_first_op

    def forward(self, volume: torch.Tensor) -> dict:
        tuner, cfg = self.tuner, self.tuner.cfg
        images = volume[..., :-1] * volume[..., -1:]
        if self.use_first_op:
            q = tuner.encoder.stream1(images)
            if cfg.infer_inv_gamma:
                q = q[..., :-4]
        else:
            q = tuner.encode(images)[1]
        means, variances = posterior_summaries_quadrature(
            q, **_quad_kwargs(tuner))
        return {"oef": means[..., 0:1], "dbv": means[..., 1:2],
                "r2p": means[..., 2:3], "stds": variances,
                "raw_log_stds": _raw_log_stds(tuner, q, -1)}


class _FusedServing(nn.Module):
    """The fused artifact's program: volume_cm (T + 1, N) -> kernel B's
    channel-major maps, the weight blob a buffer."""

    def __init__(self, tuner: FineTuner):
        super().__init__()
        cfg = tuner.cfg
        self.trunk = ("bfloat16" if tuner.encoder.dtype == torch.bfloat16
                      else "float32")
        blob, self.units, self.padded_units, _ = _weight_blob(
            tuner.encoder, cfg.no_intermediate_layers, tuner.device,
            self.trunk)
        self.register_buffer("blob", blob)
        self.n_blocks = cfg.no_intermediate_layers
        self.se_idx = tuner.scan.se_idx
        self.multi_image = cfg.multi_image_normalisation
        self.activation = cfg.activation
        self.quad = _quad_kwargs(tuner)

    def forward(self, volume_cm: torch.Tensor) -> dict:
        q = self.quad
        means, variances, raw = encode_quad_fused_op(
            volume_cm, self.blob, self.units, self.padded_units,
            self.n_blocks, True, True, self.se_idx, self.multi_image,
            self.activation, self.trunk, q["mvg"], q["oef_range"],
            q["min_oef"], q["dbv_range"], q["min_dbv"], q["dw_coeff"])
        if not q["mvg"]:
            raw = raw[:2]
        return {"means": means, "stds": variances, "raw_log_stds": raw}


def make_serving_fn(tuner: FineTuner, use_first_op: bool = True
                    ) -> nn.Module:
    """The default artifact's program as a module (weights copied from
    ``tuner``): ``volume (S, X, Y, Z, n_taus + 1)`` (last channel the brain
    mask) -> the ``infer.posterior_maps`` map dict, by the encoder's stream
    1 (``use_first_op``) or stream 2."""
    return _Serving(tuner, use_first_op).eval()


def make_fused_serving_fn(tuner: FineTuner) -> nn.Module:
    """The fused artifact's program as a module: ``volume_cm (n_taus + 1,
    N)`` channel-major (last row the brain mask) -> ``{"means" (3, N),
    "stds" (3, N), "raw_log_stds" (2|3, N)}`` by kernel B's registered op,
    the stream-1 posterior-map path of ``infer.posterior_maps``."""
    return _FusedServing(tuner).eval()


def _check_platforms(platforms: Sequence[str]) -> tuple:
    platforms = tuple(platforms)
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad or not platforms:
        raise ValueError(f"platforms must be among {PLATFORMS} (a TPU "
                         f"artifact is the JAX package's), got {platforms}")
    return platforms


def export_inference(tuner: FineTuner, *, use_first_op: bool = True,
                     platforms: Sequence[str] = PLATFORMS,
                     polymorphic: bool = True,
                     example_shape: Sequence[int] = (1, 64, 64, 8),
                     fused: bool = False) -> torch.export.ExportedProgram:
    """Export the posterior-map program on the tuner's device as a
    ``torch.export.ExportedProgram`` (``save_exported`` writes it).

    ``polymorphic`` (default) exports with dynamic (s, x, y, z) input
    dimensions (x, y >= 3); otherwise the ``example_shape`` geometry is
    baked in. ``platforms`` are where the artifact is meant to run: the
    default artifact runs on both; ``fused=True`` needs ``("cuda",)``, a
    tuner on the card, ``use_first_op`` and an activation kernel B
    implements, and bakes N = prod(example_shape)."""
    platforms = _check_platforms(platforms)
    n_ch = tuner.scan.n_taus + 1
    device = tuner.device
    if fused:
        if not use_first_op:
            raise ValueError("fused serving export covers the stream-1 "
                             "(use_first_op) posterior-map path only")
        if not fused_infer_available(tuner.cfg.activation):
            raise ValueError(f"fused serving export: activation "
                             f"{tuner.cfg.activation!r} has no kernel "
                             "(ops/fused_infer.SUPPORTED_ACTS)")
        if platforms != ("cuda",) or device.type != "cuda":
            raise ValueError("the fused serving artifact holds kernel B: "
                             "platforms must be ('cuda',) and the tuner on "
                             "the card")
        n = 1
        for d in example_shape:
            n *= int(d)
        example = torch.zeros((n_ch, n), device=device)
        with torch.no_grad():
            exported = torch.export.export(make_fused_serving_fn(tuner),
                                           (example,), strict=False)
        return _without_example(exported)
    dynamic = None
    if polymorphic:
        dims = (torch.export.Dim("s", min=1), torch.export.Dim("x", min=3),
                torch.export.Dim("y", min=3), torch.export.Dim("z", min=1))
        dynamic = ({i: d for i, d in enumerate(dims)},)
        # sizes of 1 would specialise: trace at distinct sizes >= 2
        example_shape = (2, 5, 7, 3)
    example = torch.zeros(tuple(example_shape) + (n_ch,), device=device)
    example[..., -1] = 1.0
    with torch.no_grad(), _full_fp32():
        exported = torch.export.export(make_serving_fn(tuner, use_first_op),
                                       (example,), dynamic_shapes=dynamic,
                                       strict=False)
    return _without_example(exported)


def _without_example(exported: torch.export.ExportedProgram):
    """The program without the example input it was traced at, which
    ``torch.export.save`` would otherwise write into the artifact (the
    fused one's is (n_taus + 1) x N floats, 50 MB at 1.03 M voxels)."""
    exported.example_inputs = None
    return exported


def save_exported(exported: torch.export.ExportedProgram, path: str) -> int:
    """Write an artifact to ``path`` (``torch.export.save``, a .pt2 zip);
    returns its bytes."""
    torch.export.save(exported, path)
    return os.path.getsize(path)


class LoadedArtifact:
    """A loaded serving artifact: call it on a volume (the default
    artifact) or channel-major rows (the fused one) for the map dict;
    ``program`` is the ``torch.export.ExportedProgram``. Each call runs
    with TF32 off (models.encoder._full_fp32) and without autograd."""

    def __init__(self, program: torch.export.ExportedProgram):
        self.program = program
        self._module = program.module()

    def __call__(self, volume: torch.Tensor) -> dict:
        with torch.no_grad(), _full_fp32():
            return self._module(volume)


def load_exported(path: str, device=None) -> LoadedArtifact:
    """Load an artifact written by ``save_exported``, moved to ``device``
    when given (the default artifact runs on the CPU and on the card; the
    fused one on the card only, and only once ``qbold_vi_tpu_torch`` is
    imported, which this module is part of)."""
    program = torch.export.load(path)
    if device is not None:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, torch.device(device))
    return LoadedArtifact(program)
