"""Checkpoint files: the JAX Trainer's flax msgpack checkpoints, read and
written by the port.

The counterpart of ``qbold_vi_tpu/train/trainer.py:100-179, 252-298``,
with the names kept (``_CKPT_SCHEMA``, ``_config_fingerprint``,
``CheckpointMismatchError``, ``_save_state``, ``_load_state``). A file is
the msgpack (io/msgpack_lite.py) of

    {"__meta__": {"fingerprint": uint64, "schema": int32,
                  "steps_per_epoch": int32},          (numpy scalars)
     "opt_state": {"0": {"count", "mu", "nu"}, "1": ..., ...},
     "params": the JAX params tree,
     "step": 0-d int32 array,
     "swa": {"average", "n_avg", "step"} or nil}

with every dict's keys sorted, as ``flax.serialization.msgpack_serialize``
writes them (its tree_map sorts), so the port writes the JAX package's
bytes for the same state and each reads the other's files.

``params``, ``mu``, ``nu`` and SWA's ``average`` are trees in the JAX
layout, converted by io/from_jax.py (conv kernels HWIO, Dense kernels
(in, out)); the port's optimiser keeps its moments by parameter, mapped
here by name. ``opt_state`` is the optax chain's state
(qbold_vi_tpu/train/optim.py): entry "0" scale_by_adam's ``{count, mu,
nu}``, then one entry each for the learning rate (``{count}`` when it is
a schedule, ``{}`` when it is a constant) and, for an AdamW, the
scheduled weight decay (``{count}``); every count is the optimiser's
step count (``opt_tail`` gives the layout of each phase).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import QBoldConfig, TrainConfig
from ..io import msgpack_lite
from ..io.from_jax import jax_from_state_dict, state_dict_from_jax
from .optim import ScheduledAdamW, SWAState

__all__ = ["CheckpointMismatchError", "OptState", "TrainState", "opt_tail",
           "capture_state", "restore_optimizer", "_CKPT_SCHEMA",
           "_config_fingerprint", "_save_state", "_load_state"]


class CheckpointMismatchError(RuntimeError):
    """A checkpoint's recorded schema / config fingerprint /
    steps-per-epoch, or its layout, disagrees with the current
    configuration."""


_CKPT_SCHEMA = 1

# Runtime-only switches: they select how a checkpoint is executed, never
# the shape or meaning of its trees, so they are left out of the
# fingerprint (the JAX package's lists, trainer.py:115-121).
_RUNTIME_ONLY_MODEL_KEYS = ("compute_dtype", "quad_rule", "fused_infer",
                            "fused_conv")
_RUNTIME_ONLY_SCAN_KEYS = ("simulate_noise", "snr")
# added after the legacy fingerprint's era: popped in both modes
_POST_LEGACY_MODEL_KEYS = ("fused_conv",)


def _config_fingerprint(cfg: QBoldConfig, *, legacy: bool = False
                        ) -> np.uint64:
    """64-bit fingerprint of the model and scan configs minus the
    runtime-only switches: the first 8 bytes (big-endian) of the SHA-256
    of their sorted JSON. ``legacy=True`` keeps the runtime-only keys, the
    fingerprint of the JAX package's earlier builds, which restores still
    accept."""
    model = dataclasses.asdict(cfg.model)
    scan = dataclasses.asdict(cfg.scan)
    for k in _POST_LEGACY_MODEL_KEYS:
        model.pop(k, None)
    if not legacy:
        for k in _RUNTIME_ONLY_MODEL_KEYS:
            model.pop(k, None)
        for k in _RUNTIME_ONLY_SCAN_KEYS:
            scan.pop(k, None)
    blob = json.dumps({"model": model, "scan": scan}, sort_keys=True)
    return np.uint64(int.from_bytes(
        hashlib.sha256(blob.encode()).digest()[:8], "big"))


class OptState(NamedTuple):
    """The optimiser's state by parameter name, in the port's layout."""
    count: int
    mu: dict                # name -> tensor
    nu: dict
    tail: tuple             # opt_tail's layout of the entries after Adam's


class TrainState(NamedTuple):
    """A checkpoint's content in the port's layout."""
    params: dict            # FineTuner state_dict
    opt_state: OptState
    swa: Optional[SWAState]
    step: int


def opt_tail(phase: str, train: TrainConfig) -> tuple:
    """The optax chain entries after scale_by_adam of ``phase``'s
    optimiser (JAX train/optim.py), True where the entry holds a count:
    the fine-tune AdamW (learning rate and decay schedules) and the SWA
    pretrain AdamW (constant rate and decay, each scheduled) hold two;
    ``optax.adam`` holds one for the learning rate, a count when it is the
    fine-tune schedule, none when it is the constant pt_lr."""
    if phase == "finetune":
        return (True, True) if train.adamw_decay > 0.0 else (True,)
    if phase == "pretrain":
        return (True, True) if train.use_swa else (False,)
    raise ValueError(f"phase must be 'pretrain' or 'finetune', got {phase!r}")


def capture_state(tuner, optimizer: ScheduledAdamW,
                  swa: Optional[SWAState], tail: tuple) -> TrainState:
    """The live state of ``tuner`` and ``optimizer`` (references, not
    copies); the moments are named by the tuner's parameters."""
    slot = {id(p): i for i, p in enumerate(optimizer.params)}
    mu, nu = {}, {}
    for name, p in tuner.named_parameters():
        i = slot[id(p)]
        mu[name], nu[name] = optimizer.mu[i], optimizer.nu[i]
    return TrainState(tuner.state_dict(),
                      OptState(optimizer.count, mu, nu, tail), swa,
                      optimizer.count)


def restore_optimizer(optimizer: ScheduledAdamW, tuner,
                      opt: OptState) -> None:
    """Copy ``opt``'s count and moments into ``optimizer`` by name."""
    slot = {id(p): i for i, p in enumerate(optimizer.params)}
    names = dict(tuner.named_parameters())
    if set(opt.mu) != set(names):
        raise CheckpointMismatchError(
            "the saved optimiser moments do not match the parameters: "
            f"{sorted(set(opt.mu) ^ set(names))}")
    with torch.no_grad():
        for name, p in names.items():
            optimizer.mu[slot[id(p)]].copy_(opt.mu[name])
            optimizer.nu[slot[id(p)]].copy_(opt.nu[name])
    optimizer.count = int(opt.count)


def _sorted(tree):
    """Every dict of ``tree`` with its keys sorted (jax.tree_util's order,
    which flax's writer keeps)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _count(n: int) -> np.ndarray:
    return np.asarray(n, np.int32)


def _state_tree(state: TrainState) -> dict:
    """``state`` as the JAX Trainer's payload, numpy leaves."""
    opt = state.opt_state
    entries = {"0": {"count": _count(opt.count),
                     "mu": jax_from_state_dict(opt.mu),
                     "nu": jax_from_state_dict(opt.nu)}}
    for i, has_count in enumerate(opt.tail, 1):
        entries[str(i)] = {"count": _count(opt.count)} if has_count else {}
    swa = None
    if state.swa is not None:
        swa = {"step": _count(state.swa.step),
               "n_avg": _count(state.swa.n_avg),
               "average": jax_from_state_dict(state.swa.average)}
    return {"params": jax_from_state_dict(state.params), "opt_state": entries,
            "swa": swa, "step": _count(state.step)}


def _save_state(path: str, state: TrainState,
                cfg: Optional[QBoldConfig] = None,
                steps_per_epoch: int = 0) -> int:
    """Write ``state`` to ``path`` (the JAX Trainer's bytes); returns the
    bytes written. Without ``cfg`` the fingerprint is 0, which every
    configuration accepts. The file is written whole under a temporary
    name and then renamed over ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tree = _state_tree(state)
    tree["__meta__"] = {
        "schema": np.int32(_CKPT_SCHEMA),
        "fingerprint": (_config_fingerprint(cfg) if cfg is not None
                        else np.uint64(0)),
        "steps_per_epoch": np.int32(steps_per_epoch),
    }
    blob = msgpack_lite.packb(_sorted(tree))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    return len(blob)


def _check_meta(path: str, meta: dict, cfg: QBoldConfig,
                expect_steps_per_epoch: Optional[int]) -> None:
    if int(meta["schema"]) > _CKPT_SCHEMA:
        raise CheckpointMismatchError(
            f"checkpoint {path} has schema {int(meta['schema'])}, this build "
            f"reads <= {_CKPT_SCHEMA} -- upgrade the framework to restore it")
    have = int(np.uint64(meta["fingerprint"]))
    want = int(_config_fingerprint(cfg))
    legacy = int(_config_fingerprint(cfg, legacy=True))
    if have not in (0, want, legacy):
        raise CheckpointMismatchError(
            f"checkpoint {path} was trained with model/scan config "
            f"fingerprint {have:#018x}, the current config fingerprints "
            f"{want:#018x} -- the architecture or tau protocol changed since "
            "it was written (adjust the config, or retrain)")
    saved_spe = int(meta["steps_per_epoch"])
    if (expect_steps_per_epoch is not None and saved_spe > 0
            and saved_spe != expect_steps_per_epoch):
        raise CheckpointMismatchError(
            f"mid-phase checkpoint {path} was written with {saved_spe} "
            f"steps/epoch but the config now says {expect_steps_per_epoch} "
            "-- the resume position (step // steps_per_epoch) would be "
            "wrong; refusing to resume (delete the .partial to restart the "
            "phase)")


def _load_state(path: str, cfg: QBoldConfig, *, tail: tuple, swa: bool,
                expect_steps_per_epoch: Optional[int] = None) -> TrainState:
    """Read ``path`` into a TrainState (CPU tensors). Checks the schema,
    the fingerprint (0, the current or the legacy one), the steps per
    epoch of a mid-phase file, and that the optimiser state has the
    layout ``tail`` of this phase's optimiser. The SWA state is kept only
    when ``swa`` asks for it, as the JAX Trainer keeps it only when its
    template has one."""
    with open(path, "rb") as f:
        raw = msgpack_lite.unpackb(f.read())
    if not isinstance(raw, dict) or not {"params", "opt_state", "step",
                                         "swa"} <= set(raw):
        raise CheckpointMismatchError(f"{path} is not a Trainer checkpoint")
    meta = raw.get("__meta__")
    if meta is not None:
        _check_meta(path, meta, cfg, expect_steps_per_epoch)
    entries = raw["opt_state"]
    want = ["0"] + [str(i) for i in range(1, len(tail) + 1)]
    layout_ok = isinstance(entries, dict) and sorted(entries) == sorted(want)
    if layout_ok:
        layout_ok = set(entries["0"]) == {"count", "mu", "nu"} and all(
            set(entries[str(i)]) == ({"count"} if has else set())
            for i, has in enumerate(tail, 1))
    if not layout_ok:
        have = ({k: sorted(v) for k, v in entries.items()}
                if isinstance(entries, dict) else entries)
        raise CheckpointMismatchError(
            f"checkpoint {path}'s optimiser state has the entries {have}, "
            f"this phase's optimiser {len(want)} (Adam's, then counts "
            f"{list(tail)}) -- the optimiser configuration (adamw_decay, "
            "use_swa) changed since it was written")
    adam = entries["0"]
    swa_state = None
    if swa and raw["swa"] is not None:
        s = raw["swa"]
        swa_state = SWAState(int(s["step"]), int(s["n_avg"]),
                             state_dict_from_jax(s["average"]))
    return TrainState(
        state_dict_from_jax(raw["params"]),
        OptState(int(adam["count"]), state_dict_from_jax(adam["mu"]),
                 state_dict_from_jax(adam["nu"]), tuple(tail)),
        swa_state, int(raw["step"]))
