"""Weight bridge between the JAX package's params tree and the port.

The JAX FineTuner's params are a nested dict (``{"encoder": flax
variables, "pop_prior"?, "log_sigma"?}``). Given as nested numpy dicts,
they convert to a ``models.vi.FineTuner`` state_dict and back, exactly
(no arithmetic, only renames and transposes):

* flax names become module paths: ``encoder/block_0/ConvXY_1/Conv_0/
  kernel`` <-> ``encoder.block_0.ConvXY_1.Conv_0.weight``;
* a Dense ``kernel (in, out)`` becomes ``weight (out, in)``;
* a conv ``kernel`` HWIO becomes ``weight`` OIHW;
* every other leaf (biases, GroupNorm scales, ``inv_gamma_raw``,
  ``pop_prior``, ``log_sigma``) keeps its name and layout.

A population of sweep trials (sweep.py) carries its parameters with a
leading trial axis, as the JAX population's stacked tree
(``qbold_vi_tpu/sweep.py::_population_group(with_params=True)``) does:
``stacked_state_dict_from_jax`` / ``jax_from_stacked_state_dict`` convert
those trial by trial.

The Trainer's checkpoint files are the JAX Trainer's own, read and
written through this bridge (train/checkpoint.py). For weights alone there
is also an ``.npz`` of the JAX-layout tree with '/'-joined keys
(``save_params_npz`` / ``load_params_npz``; ``chip_smoke.py --weights``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["state_dict_from_jax", "jax_from_state_dict", "flatten_params",
           "unflatten_params", "save_params_npz", "load_params_npz",
           "stacked_state_dict_from_jax", "jax_from_stacked_state_dict"]


def flatten_params(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> {'a/b/c': numpy array}."""
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            flat.update(flatten_params(val, path + "/"))
        else:
            flat[path] = np.asarray(val)
    return flat


def unflatten_params(flat: dict) -> dict:
    tree: dict = {}
    for path, val in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def state_dict_from_jax(tree: dict) -> dict:
    """JAX params tree (nested numpy dicts) -> FineTuner state_dict."""
    out = {}
    for path, val in flatten_params(tree).items():
        *parents, leaf = path.split("/")
        if leaf == "kernel":
            if val.ndim == 2:
                val = val.T
            elif val.ndim == 4:
                val = val.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"unexpected kernel rank at {path}: "
                                 f"{val.shape}")
            leaf = "weight"
        key = ".".join(parents + [leaf])
        out[key] = torch.from_numpy(np.array(val, dtype=np.float32))
    return out


def jax_from_state_dict(state_dict: dict) -> dict:
    """FineTuner state_dict -> JAX params tree (nested numpy dicts)."""
    flat = {}
    for key, val in state_dict.items():
        *parents, leaf = key.split(".")
        arr = val.detach().cpu().numpy()
        if leaf == "weight":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(2, 3, 1, 0)
            leaf = "kernel"
        flat["/".join(parents + [leaf])] = np.array(arr)   # copy, keeps 0-d
    return unflatten_params(flat)


def stacked_state_dict_from_jax(tree: dict) -> dict:
    """A JAX params tree whose leaves carry a leading trial axis (P, ...)
    -> a state_dict of (P, ...) tensors, each trial converted as
    ``state_dict_from_jax`` converts it."""
    flat = flatten_params(tree)
    p_n = len(next(iter(flat.values())))
    trials = [state_dict_from_jax(unflatten_params(
        {k: v[j] for k, v in flat.items()})) for j in range(p_n)]
    return {k: torch.stack([t[k] for t in trials]) for k in trials[0]}


def jax_from_stacked_state_dict(state_dict: dict) -> dict:
    """A state_dict of (P, ...) tensors -> the JAX params tree with a
    leading trial axis on every leaf."""
    p_n = len(next(iter(state_dict.values())))
    trials = [flatten_params(jax_from_state_dict(
        {k: v[j] for k, v in state_dict.items()})) for j in range(p_n)]
    return unflatten_params({k: np.stack([t[k] for t in trials])
                             for k in trials[0]})


def save_params_npz(tree: dict, path: str) -> None:
    """Write a JAX-layout params tree as an .npz with '/'-joined keys."""
    np.savez(path, **flatten_params(tree))


def load_params_npz(path: str) -> dict:
    """Read an .npz written by ``save_params_npz`` back into a tree."""
    with np.load(path, allow_pickle=False) as f:
        return unflatten_params({k: f[k] for k in f.files})
