"""Import trained reference (Keras) encoder weights from a legacy HDF5
file.

The counterpart of the h5py route of ``qbold_vi_tpu/io/keras_import.py``:
a user switching from the reference brings a trained ``pt_model.h5`` /
``final_model.h5`` (the Keras-2 ``save_weights`` layout the reference's
TF 2.x wrote) and gets the port's FineTuner state_dict, tensor for tensor
what the JAX importer gives through the weight bridge (io/from_jax.py).

Layer mapping (reference model.py:122-223), Conv3D layers taken in the
order of the counter in their names (conv3d, conv3d_1, ...), which is
create_encoder's construction order:

    Conv3D 1x1x1 (n_taus -> U)   -> encoder.first_conv
    per block i:
      Conv3D 1x1x1 shared        -> encoder.block_i.Dense_0
      Conv3D 3x3x1 (x2)          -> encoder.block_i.ConvXY_{0,1}.Conv_0
      Conv3D 1x1x1 gating        -> encoder.block_i.Dense_1
    Conv3D 1x1x1 (U -> 4|5)      -> encoder.final
    Conv3D 1x1x1 (U -> n_taus)   -> encoder.sigma_head

and a fine-tuned file's VariableLayer weights -> ``pop_prior`` /
``log_sigma`` (``extras_from_legacy``).

Not ported: the JAX importer's fallback, which rebuilds the reference
encoder with TensorFlow from a checkout of the reference code and loads
the file through Keras (``build_reference_encoder``,
``params_from_reference_encoder``). Neither exists on the card's machine;
where the legacy parse fails, ``load_reference_h5`` raises with the
parser's error. Needs h5py (not on the card's machine: import on a host
that has it and carry the checkpoint over).
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np

from .from_jax import state_dict_from_jax

__all__ = ["params_from_legacy_h5", "extras_from_legacy",
           "load_reference_h5"]


def _names(attr) -> list:
    return [n.decode() if isinstance(n, bytes) else n for n in attr]


def _legacy_h5_weights(h5_path: str) -> tuple:
    """Parse a Keras-2 legacy ``save_weights`` HDF5: root attr
    ``layer_names``, per-layer attr ``weight_names`` whose entries are
    full sub-paths (``conv3d_3/kernel:0``; a nested Model's layer group
    lists every nested weight this way). Returns

        (convs:  [(sub_layer_name, kernel, bias), ...]  (5-D kernels),
         extras: [(sub_layer_name, var_name, array), ...]  (the rest))

    grouping weight names by their sub-layer path, so that a nested layout
    (the reference's ``final_model.h5``, whose outer model holds the
    encoder Model as one layer) keeps each conv apart (ADVICE r1)."""
    import h5py

    convs, extras = [], []
    with h5py.File(h5_path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f

        def walk(group):
            for lname in _names(group.attrs.get("layer_names", [])):
                g = group[lname]
                wnames = _names(g.attrs.get("weight_names", []))
                if wnames:
                    by_sublayer: dict = {}
                    for wn in wnames:
                        parts = wn.split("/")
                        var = parts[-1].split(":")[0]
                        prefix = "/".join(parts[:-1]) or lname
                        by_sublayer.setdefault(prefix, {})[var] = (
                            np.asarray(g[wn]))
                    for prefix, tensors in by_sublayer.items():
                        sub = prefix.split("/")[-1]
                        k = tensors.get("kernel")
                        if k is not None and k.ndim == 5:
                            convs.append((sub, k, tensors.get("bias")))
                        else:
                            extras.extend((sub, var, arr)
                                          for var, arr in tensors.items())
                elif isinstance(g, h5py.Group) and "layer_names" in g.attrs:
                    walk(g)          # a nested model as its own group tree
        walk(root)
    return convs, extras


def extras_from_legacy(extras: list, cfg) -> dict:
    """A legacy fine-tuner file's non-conv weights as the FineTuner's
    extra parameters (reference model.py:252-281): the trainable
    population prior, (5,) for MVG or (4 * mog_components,), ->
    "pop_prior"; the trainable scalar noise, (1,) when the noise is not
    heteroscedastic, -> "log_sigma". Told apart by shape against the
    config, the first match in file order winning (VariableLayer names are
    not stable across Keras versions)."""
    out: dict[str, Any] = {}
    pop_size = 5 if cfg.use_mvg else 4 * cfg.mog_components
    for _sub, _var, arr in extras:
        a = np.asarray(arr).reshape(-1)
        if (cfg.use_population_prior and "pop_prior" not in out
                and a.size == pop_size):
            out["pop_prior"] = a.astype(np.float32)
        elif (not cfg.heteroscedastic_noise and "log_sigma" not in out
              and a.size == 1):
            out["log_sigma"] = np.float32(a[0])
    return out


def params_from_legacy_h5(h5_path: str, cfg) -> dict:
    """A Keras-2 legacy .h5 weights file as a FineTuner state_dict (the
    encoder, plus ``pop_prior`` / ``log_sigma`` where the file holds them
    and the config asks for them); raises ValueError when the file does not
    hold the config's Conv3D layers."""
    convs, extras = _legacy_h5_weights(h5_path)

    def order(item):
        match = re.search(r"_(\d+)$", item[0])
        return int(match.group(1)) if match else -1

    convs.sort(key=order)
    n_blocks = cfg.no_intermediate_layers
    expected = 1 + 4 * n_blocks + 2
    if len(convs) != expected:
        raise ValueError(f"expected {expected} Conv3D layers in {h5_path}, "
                         f"found {len(convs)}")

    def dense(item):
        _, k, b = item
        return {"kernel": np.squeeze(k, axis=(0, 1, 2)), "bias": b}

    def convxy(item):
        _, k, b = item
        return {"Conv_0": {"kernel": np.squeeze(k, axis=2), "bias": b}}

    enc: dict[str, Any] = {"first_conv": dense(convs[0])}
    for i in range(n_blocks):
        base = 1 + 4 * i
        enc[f"block_{i}"] = {"Dense_0": dense(convs[base]),
                             "ConvXY_0": convxy(convs[base + 1]),
                             "ConvXY_1": convxy(convs[base + 2]),
                             "Dense_1": dense(convs[base + 3])}
    enc["final"] = dense(convs[1 + 4 * n_blocks])
    enc["sigma_head"] = dense(convs[2 + 4 * n_blocks])
    tree: dict[str, Any] = {"encoder": enc}
    tree.update(extras_from_legacy(extras, cfg))
    return state_dict_from_jax(tree)


def load_reference_h5(h5_path: str, cfg) -> dict:
    """An upstream .h5 checkpoint (``pt_model.h5``, or a fine-tuned
    ``final_model.h5`` with its population-prior / trainable-sigma extras)
    as a FineTuner state_dict, by the legacy-HDF5 parser. Where that parse
    fails the JAX importer falls back to Keras; the port has no Keras
    route, so it raises with the parser's error."""
    try:
        return params_from_legacy_h5(h5_path, cfg)
    except (OSError, KeyError, ValueError) as e:
        raise ValueError(
            f"legacy-HDF5 parse of {h5_path!r} failed ({type(e).__name__}: "
            f"{e}); the JAX package's Keras route (a rebuilt reference "
            "encoder loading the file through TensorFlow) is not available "
            "in the port: convert the file with python -m qbold_vi_tpu "
            "import-weights where TensorFlow and the reference code are "
            "installed") from e
