"""Typed configuration for the PyTorch port (jax-free copy).

A field-for-field copy of ``qbold_vi_tpu/config.py``: the JAX package's
``__init__`` imports jax, so the port cannot import that module, and the
machine that runs the port has no jax. The copy is gated field for field
against the JAX package's ``OPTIMAL`` and ``known_flat_keys()`` in
tests/test_torch_config.py, so the two cannot drift apart silently.

Frozen, hashable dataclasses and a YAML loader that keeps the
reference's "YAML overrides defaults with type coercion" semantics
(reference: utils.py:109-116, train.py:473-480). ``yaml`` is imported
lazily inside ``load_yaml_config``: the port runs where pyyaml is absent.
"""

from __future__ import annotations

import configparser
import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np

__all__ = [
    "ScanParams",
    "SynthParams",
    "ModelConfig",
    "TrainConfig",
    "QBoldConfig",
    "load_yaml_config",
    "load_ini_scan_params",
    "load_ini_synth_params",
    "load_ini_config",
    "known_flat_keys",
    "UnknownConfigKeyError",
    "OPTIMAL",
]


@dataclass(frozen=True)
class ScanParams:
    """Scanner / physics constants (reference: config:1-61).

    The tau grid is derived, not stored, so the dataclass stays hashable and
    usable as a cache key. ``taus()`` reproduces ``tf.range(tau_start, tau_end, tau_step)``
    (reference: signals.py:34-35).
    """

    tr: float = 3.0            # ASE repetition time [s]
    ti: float = 1.21           # ASE inversion time [s]
    te: float = 0.074          # ASE echo time [s]
    tau_start: float = -0.016  # spin-echo displacement grid start [s]
    tau_end: float = 0.065     # grid end (exclusive) [s]
    tau_step: float = 0.008    # grid step [s]
    dchi: float = 2.64e-7      # susceptibility difference (deoxy vs oxy blood)
    gamma: float = 2.67513e8   # proton gyromagnetic ratio [rad/s/T]
    b0: float = 3.0            # field strength [T]
    t1b: float = 1.58          # blood T1 [s]
    r2t: float = 11.5          # tissue R2 [1/s]
    hct: float = 0.34          # haematocrit fraction
    nb: float = 0.775          # blood spin density (reference: signals.py:102)
    simulate_noise: bool = True
    snr: float = 10.0

    def taus(self) -> np.ndarray:
        """The tau grid as float32, matching tf.range semantics."""
        t = np.arange(self.tau_start, self.tau_end, self.tau_step, dtype=np.float64)
        return np.around(t, decimals=7).astype(np.float32)

    @property
    def n_taus(self) -> int:
        return len(self.taus())

    @property
    def se_idx(self) -> int:
        """Index of the spin-echo (tau==0) image (reference: model.py:95).

        Rounded, not truncated: the reference's int() truncation is
        exact for its own grids (0.016/0.008) but text-parsed grids can
        carry fp error (e.g. 0.009/0.003 -> 2.9999...), and truncation
        would silently normalise every consumer (normalise_data, the
        NLL reference window, the fused kernels) by a nonzero-tau image."""
        return int(round(abs(self.tau_start / self.tau_step)))

    @property
    def dw_coeff(self) -> float:
        """delta_omega = dw_coeff * hct * oef (reference: signals.py:142-144)."""
        return (4.0 / 3.0) * math.pi * self.gamma * self.b0 * self.dchi


@dataclass(frozen=True)
class SynthParams:
    """Synthetic population sampling ranges (reference: config:48-61)."""

    oef_start: float = 0.05
    oef_end: float = 0.8
    oef_mean: float = 0.4
    oef_std: float = 0.2
    dbv_start: float = 0.003
    dbv_end: float = 0.195
    dbv_mean: float = 0.025
    dbv_std: float = 0.02
    sample_size: int = 2500
    uniform_prop: float = 0.1   # mixing weight of the uniform component
    misalign_prob: float = 0.0  # slice-misalignment augmentation probability
    variable_hct: bool = False


@dataclass(frozen=True)
class ModelConfig:
    """Encoder architecture hyperparameters (reference: model.py:54-95)."""

    no_intermediate_layers: int = 1
    no_units: int = 30
    use_layer_norm: bool = False
    dropout_rate: float = 0.0
    activation: str = "relu"
    student_t_df: float = 2.0
    im_loss_sigma: float = 0.08      # initial heteroscedastic sigma
    multi_image_normalisation: bool = True
    channelwise_gating: bool = True
    infer_inv_gamma: bool = False
    use_mvg: bool = False
    use_population_prior: bool = False
    mog_components: int = 1
    no_samples: int = 1
    heteroscedastic_noise: bool = True
    predict_log_data: bool = True
    gate_offset: float = 0.0
    resid_init_std: float = 0.1
    # Parameter-space ranges for the logit transforms (reference: model.py:88-91)
    oef_range: float = 0.8
    min_oef: float = 0.04
    dbv_range: float = 0.2
    min_dbv: float = 0.001
    # Compute dtype of the encoder trunk (models/encoder.py::_dtype_of):
    # "auto" and "float32" run it in float32 ("auto" resolves as the JAX
    # package resolves it off the TPU, so bf16 is opt-in); "bfloat16" runs
    # the first Dense, each block's shared and gate Dense and both 3x3
    # convs in bf16 with float32 sums -- on the card through kernels B, C
    # and H at bf16 -- and serving's fused stream-1 kernels at
    # trunk="bfloat16"; anything else raises. Params and the distribution /
    # sigma heads always stay float32.
    compute_dtype: str = "auto"
    # SDR tissue-integral rule for the decode paths (ops/physics.py::
    # select_quad_rule): "auto" | "cheb" | "gj16".
    quad_rule: str = "auto"
    # Fused stream-1 inference encode + quadrature (ops/fused_infer.py,
    # one CUDA kernel at every width and depth: the weights resident in
    # shared memory where they fit, streamed through it elsewhere).
    # "auto" = on for CUDA tensors when the activation is covered, as the
    # JAX "auto"; "on" forces it (and raises where not covered); "off" runs
    # the encoder + the standalone quadrature kernel. The JAX package's
    # "interpret" mode is accepted and means "on" (infer.py).
    fused_infer: str = "auto"
    # 3x3x1 trunk convolution (models/encoder.py::ConvXY): "on" and
    # "interpret" run kernel H (ops/conv3x3.py; its plain version on a CPU
    # tensor) and raise on a plane smaller than 3 x 3; "auto" and "off"
    # run the library conv (cuDNN on the card), as the JAX package's
    # "auto" keeps its Pallas conv off.
    fused_conv: str = "auto"


@dataclass(frozen=True)
class TrainConfig:
    """Two-phase training hyperparameters (reference: utils.py:47-83)."""

    pt_lr: float = 5e-5
    ft_lr: float = 5e-3
    kl_weight: float = 1.0
    smoothness_weight: float = 1.0
    no_pt_epochs: int = 5
    no_ft_epochs: int = 40
    crop_size: int = 16
    use_r2p_loss: bool = False
    full_model: bool = True
    use_blood: bool = True
    use_swa: bool = True
    # Whether to ADOPT the SWA running average into the weights at the
    # end of pretraining. The reference wraps its optimizer in
    # tfa.optimizers.SWA but never calls assign_average_vars
    # (train.py:382-385), so upstream's averaged weights are never
    # applied -- default False matches that executed behaviour; True is
    # the arguably-intended fix, kept behind this flag.
    swa_adopt: bool = False
    adamw_decay: float = 2e-4
    pt_adamw_decay: float = 2e-4
    inv_gamma_alpha: float = 0.0
    inv_gamma_beta: float = 0.0
    # Mid-phase crash recovery: .partial checkpoint every N epochs (> 0).
    checkpoint_every_epochs: int = 0
    # Fused decode+NLL kernel mode for the fine-tune likelihood term.
    fused_decode_nll: str = "auto"
    # Fused ELBO kernel mode ("auto"/"on"/"off"/"host"/...).
    fused_elbo: str = "auto"
    # Subject-sharded training-data residency under a mesh: "on" gives each
    # rank only its ceil(S / n) subjects; "auto" does so above the
    # Trainer's SHARD_SUBJECTS_AUTO_BYTES (1 GiB of volumes + priors).
    ft_shard_subjects: str = "auto"
    ft_steps_per_epoch: int = 100     # reference: train.py:376
    ft_batch_size: int = 38           # reference: train.py:68
    eval_batch_size: int = 3          # reference: train.py:70
    pt_batch_size: int = 512          # reference: train.py:103
    swa_start: int = 880              # reference: train.py:385 (22*40)
    swa_period: int = 22
    # Draw synthetic pretraining batches on the device inside the step
    # instead of a fixed host-generated dataset.
    pt_on_device_synth: bool = False
    seed: int = 1
    save_directory: str = "optimal"
    data_directory: str = "/home/data/qbold"
    wandb_project: str = ""


@dataclass(frozen=True)
class QBoldConfig:
    """Top-level bundle of all configuration groups."""

    scan: ScanParams = field(default_factory=ScanParams)
    synth: SynthParams = field(default_factory=SynthParams)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    name: str = "default"


# Mapping from the reference's flat YAML/argparse keys (utils.py:8-41) to
# (dataclass group, field name) in our typed config.
_FLAT_KEY_MAP: dict[str, tuple[str, str]] = {
    "no_units": ("model", "no_units"),
    "no_intermediate_layers": ("model", "no_intermediate_layers"),
    "student_t_df": ("model", "student_t_df"),
    "pt_lr": ("train", "pt_lr"),
    "ft_lr": ("train", "ft_lr"),
    "kl_weight": ("train", "kl_weight"),
    "smoothness_weight": ("train", "smoothness_weight"),
    "dropout_rate": ("model", "dropout_rate"),
    "no_pt_epochs": ("train", "no_pt_epochs"),
    "no_ft_epochs": ("train", "no_ft_epochs"),
    "im_loss_sigma": ("model", "im_loss_sigma"),
    "crop_size": ("train", "crop_size"),
    "use_layer_norm": ("model", "use_layer_norm"),
    "activation": ("model", "activation"),
    "use_r2p_loss": ("train", "use_r2p_loss"),
    "multi_image_normalisation": ("model", "multi_image_normalisation"),
    "full_model": ("train", "full_model"),
    "use_blood": ("train", "use_blood"),
    "misalign_prob": ("synth", "misalign_prob"),
    "use_population_prior": ("model", "use_population_prior"),
    "inv_gamma_alpha": ("train", "inv_gamma_alpha"),
    "inv_gamma_beta": ("train", "inv_gamma_beta"),
    "gate_offset": ("model", "gate_offset"),
    "resid_init_std": ("model", "resid_init_std"),
    "channelwise_gating": ("model", "channelwise_gating"),
    "infer_inv_gamma": ("model", "infer_inv_gamma"),
    "use_mvg": ("model", "use_mvg"),
    "uniform_prop": ("synth", "uniform_prop"),
    "use_swa": ("train", "use_swa"),
    "swa_adopt": ("train", "swa_adopt"),
    "adamw_decay": ("train", "adamw_decay"),
    "pt_adamw_decay": ("train", "pt_adamw_decay"),
    "predict_log_data": ("model", "predict_log_data"),
    "save_directory": ("train", "save_directory"),
    "wandb_project": ("train", "wandb_project"),
    # extensions (not in the reference's key set)
    "pt_on_device_synth": ("train", "pt_on_device_synth"),
    "checkpoint_every_epochs": ("train", "checkpoint_every_epochs"),
    "fused_decode_nll": ("train", "fused_decode_nll"),
    "fused_elbo": ("train", "fused_elbo"),
    "ft_shard_subjects": ("train", "ft_shard_subjects"),
    "compute_dtype": ("model", "compute_dtype"),
    "quad_rule": ("model", "quad_rule"),
    "fused_infer": ("model", "fused_infer"),
    "fused_conv": ("model", "fused_conv"),
    "d": ("train", "data_directory"),
    "name": (None, "name"),
}


def normalize_mode(value: Any, allowed: tuple, flag: str) -> str:
    """Canonicalise a mode-string switch shared by every fused-kernel /
    residency flag: YAML 1.1 parses a bare ``on``/``off`` as a BOOL,
    which the flat-override coercion stringifies to 'True'/'False', so
    those spellings map back; anything outside ``allowed`` raises with
    the flag name (one helper, one behaviour -- the four call sites
    previously each carried the literal dict)."""
    mode = str(value).strip().lower()
    mode = {"true": "on", "false": "off", "1": "on", "0": "off"}.get(mode,
                                                                     mode)
    if mode not in allowed:
        raise ValueError(
            f"{flag} must be {'|'.join(allowed)}, got {value!r}")
    return mode


def _coerce(current: Any, new: Any) -> Any:
    """Coerce an override to the type of the existing default.

    Mirrors the reference's ``args[key] = type(args.get(key))(val)``
    (utils.py:112-116), including its quirk that bools are parsed with
    Python truthiness (bool("False") is True) -- here we instead parse
    string booleans correctly, which is one of the documented deliberate
    deviations (SURVEY.md "reference quirks").
    """
    if isinstance(current, bool):
        if isinstance(new, str):
            return new.strip().lower() in ("true", "1", "yes")
        return bool(new)
    if current is None:
        return new
    return type(current)(new)


def known_flat_keys() -> set:
    """Every key ``apply_flat_overrides`` can route: the reference-style
    flat keys plus the exact field names of all four config groups."""
    keys = set(_FLAT_KEY_MAP)
    for klass in (ScanParams, SynthParams, ModelConfig, TrainConfig):
        keys.update(f.name for f in dataclasses.fields(klass))
    return keys


class UnknownConfigKeyError(KeyError):
    """An override key that routes nowhere. The reference silently stores
    unknowns in its args dict (utils.py:109-116), so a typo'd
    ``--set pt_lrr=...`` no-ops -- and a typo'd sweep-space dimension has
    every trial silently train the SAME config while the optimiser
    'tunes' noise. Failing loudly (with a did-you-mean) strictly gains
    safety; ``strict=False`` keeps the permissive behaviour for
    forward-compat YAML files."""


def _unknown_key_error(key: str,
                       remedy: str = "--allow-unknown-keys on the CLI / "
                                     "strict=False in the API ignores "
                                     "unknown keys") -> UnknownConfigKeyError:
    import difflib

    close = difflib.get_close_matches(str(key), sorted(known_flat_keys()),
                                      n=3, cutoff=0.6)
    hint = f" -- did you mean {' / '.join(close)}?" if close else ""
    return UnknownConfigKeyError(
        f"unknown config key {key!r}{hint} (known keys: flat reference "
        f"keys and ScanParams/SynthParams/ModelConfig/TrainConfig field "
        f"names; {remedy})")


def apply_flat_overrides(cfg: QBoldConfig, overrides: Mapping[str, Any],
                         *, strict: bool = True) -> QBoldConfig:
    """Apply a flat dict of reference-style keys onto a QBoldConfig.

    ``strict`` (default): unknown keys raise ``UnknownConfigKeyError``
    with a did-you-mean hint; ``strict=False`` warns and ignores them
    (the forward-compat escape for YAML written against a newer build).
    """
    groups = {
        "scan": dict(dataclasses.asdict(cfg.scan)),
        "synth": dict(dataclasses.asdict(cfg.synth)),
        "model": dict(dataclasses.asdict(cfg.model)),
        "train": dict(dataclasses.asdict(cfg.train)),
    }
    name = cfg.name
    for key, val in overrides.items():
        if key in _FLAT_KEY_MAP:
            group, fname = _FLAT_KEY_MAP[key]
            if group is None:
                name = str(val)
            else:
                groups[group][fname] = _coerce(groups[group].get(fname), val)
        else:
            # Fall back to exact field-name matches across the groups
            # (scan constants like tau_start, synth population keys like
            # sample_size / oef_mean -- the reference's INI `config` keys).
            for group in ("scan", "synth", "model", "train"):
                if key in groups[group]:
                    groups[group][key] = _coerce(groups[group][key], val)
                    break
            else:
                if strict:
                    raise _unknown_key_error(key)
                import warnings
                warnings.warn(f"ignoring unknown config key {key!r}",
                              stacklevel=2)
    # Enforce the reference's floors (train.py:431-432).
    groups["model"]["no_intermediate_layers"] = max(1, int(groups["model"]["no_intermediate_layers"]))
    groups["model"]["no_units"] = max(1, int(groups["model"]["no_units"]))
    return QBoldConfig(
        scan=ScanParams(**groups["scan"]),
        synth=SynthParams(**groups["synth"]),
        model=ModelConfig(**groups["model"]),
        train=TrainConfig(**groups["train"]),
        name=name,
    )


def load_yaml_config(path: str, base: QBoldConfig | None = None,
                     *, strict: bool = True) -> QBoldConfig:
    """Load a reference-style flat YAML file over the defaults.

    ``strict=False`` ignores (with a warning) keys this build does not
    know -- the escape for YAML written against a newer framework."""
    import yaml

    with open(path) as f:
        overrides = yaml.safe_load(f) or {}
    return apply_flat_overrides(base or QBoldConfig(), overrides,
                                strict=strict)


def load_ini_scan_params(path: str) -> ScanParams:
    """Load scanner constants from a reference-style INI ``config`` file
    (reference: signals.py:303-305, qbold_build_model.py:38-43)."""
    cp = configparser.ConfigParser()
    cp.read(path)
    p = cp["DEFAULT"]
    return ScanParams(
        tr=float(p["tr"]), ti=float(p["ti"]), te=float(p["te"]),
        tau_start=float(p["tau_start"]), tau_end=float(p["tau_end"]),
        tau_step=float(p["tau_step"]), dchi=float(p["dchi"]),
        gamma=float(p["gamma"]), b0=float(p["b0"]), t1b=float(p["t1b"]),
        r2t=float(p["r2t"]), hct=float(p["hct"]),
        nb=float(p.get("nb", "0.775")),
        simulate_noise=p.get("simulate_noise", "True") == "True",
        snr=float(p.get("snr", "10")),
    )


def load_ini_synth_params(path: str,
                          base: SynthParams | None = None) -> SynthParams:
    """Load the synthetic-population section of a reference-style INI
    ``config`` file: oef/dbv ranges, means, stds and ``sample_size``
    (reference: config:48-61, consumed by signals.py:255-268).

    Keys the INI does not carry (``uniform_prop``, ``misalign_prob``,
    ``variable_hct`` -- the reference passes those as function arguments,
    signals.py:251) keep ``base``'s values, so the INI round-trip is
    lossless over everything the reference's file actually stores."""
    cp = configparser.ConfigParser()
    cp.read(path)
    p = cp["DEFAULT"]
    base = base or SynthParams()

    def f(key: str, cur: float) -> float:
        return float(p.get(key, cur))

    return dataclasses.replace(
        base,
        oef_start=f("oef_start", base.oef_start),
        oef_end=f("oef_end", base.oef_end),
        oef_mean=f("oef_mean", base.oef_mean),
        oef_std=f("oef_std", base.oef_std),
        dbv_start=f("dbv_start", base.dbv_start),
        dbv_end=f("dbv_end", base.dbv_end),
        dbv_mean=f("dbv_mean", base.dbv_mean),
        dbv_std=f("dbv_std", base.dbv_std),
        sample_size=int(float(p.get("sample_size", base.sample_size))),
    )


def load_ini_config(path: str, base: QBoldConfig | None = None) -> QBoldConfig:
    """Load EVERYTHING a reference INI ``config`` file carries -- the
    scanner constants AND the synthetic-population section -- over
    ``base``. The lossless migration entry point for a reference user's
    own INI (``--ini`` on the CLI): ``load_ini_scan_params`` alone
    silently reverted the synth settings to defaults."""
    base = base or QBoldConfig()
    return dataclasses.replace(
        base,
        scan=load_ini_scan_params(path),
        synth=load_ini_synth_params(path, base.synth),
    )


def _optimal() -> QBoldConfig:
    """The published "optimal" run configuration
    (reference: configurations/optimal.yaml:1-32)."""
    return apply_flat_overrides(QBoldConfig(), dict(
        no_units=60,
        no_intermediate_layers=2,
        student_t_df=200,
        pt_lr=2e-3,
        ft_lr=5e-3,
        kl_weight=1.0,
        smoothness_weight=5.0,
        dropout_rate=0.0,
        no_pt_epochs=60,
        no_ft_epochs=40,
        im_loss_sigma=0.05,
        crop_size=25,
        use_layer_norm=False,
        activation="relu",
        use_r2p_loss=False,
        multi_image_normalisation=False,
        full_model=True,
        use_blood=True,
        misalign_prob=0.0,
        use_population_prior=False,
        save_directory="optimal",
        name="optimal",
        inv_gamma_alpha=0.0,
        inv_gamma_beta=0.0,
        channelwise_gating=True,
        gate_offset=-3.0,
        resid_init_std=0.05,
        use_mvg=True,
        uniform_prop=0.0,
        adamw_decay=2e-4,
        pt_adamw_decay=2e-4,
        predict_log_data=False,
    ))


OPTIMAL = _optimal()
