"""Input pipelines (numpy): synthetic pseudo-volumes and their shuffled
batches for pretraining; blank crop, per-voxel priors from the pretrained
encoder and random-crop batches for fine-tuning.

A copy of ``qbold_vi_tpu/train/data.py:42-206`` (reference
train.py:17-103, 208-238) for the port, which cannot import the JAX
package.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional

import numpy as np

__all__ = ["split_synthetic", "synthetic_batch_indices", "synthetic_batches",
           "blank_crop", "predict_priors", "load_real_directory",
           "RealCropSampler"]


def load_real_directory(d: str) -> dict:
    """Load the reference's real-data directory layout (reference
    train.py:208-238): ``ASE_scan.npy`` / ``ASE_INF.npy`` / ``ASE_SUP.npy``
    (training volumes, a trailing brain-mask channel) and optionally
    ``hyperv_ase.npy`` / ``baseline_ase.npy`` study sets with TWO trailing
    channels (GM mask, brain mask).

    Returns ``{"train", "study", "hyperv", "baseline"}``: ``train`` the
    concatenation of the ASE sets (None when none exist); ``study`` the
    hyperv + baseline concatenation with the brain mask dropped, so that
    the GM mask is the mask channel -- the set the reference's ELBO
    validation evaluates (train.py:223-226, 325-359), None unless both
    exist; ``hyperv`` / ``baseline`` the arrays as loaded (both masks)."""
    import os

    def load(name):
        p = os.path.join(d, name)
        return np.load(p) if os.path.isfile(p) else None

    parts = [x for x in (load("ASE_scan.npy"), load("ASE_INF.npy"),
                         load("ASE_SUP.npy")) if x is not None]
    train = np.concatenate(parts, axis=0) if parts else None
    hyperv, baseline = load("hyperv_ase.npy"), load("baseline_ase.npy")
    study = None
    if hyperv is not None and baseline is not None:
        study = np.concatenate([hyperv[..., :-1], baseline[..., :-1]],
                               axis=0)
    return {"train": train, "study": study,
            "hyperv": hyperv, "baseline": baseline}


def split_synthetic(x: np.ndarray, y: np.ndarray, vol_shape=(10, 10, 5)):
    """Flat voxels -> pseudo-volumes of ``vol_shape``, split 90/10
    (reference train.py:82-98); voxels beyond the last whole volume are
    dropped. Returns ((train_x, train_y), (val_x, val_y))."""
    vol = int(np.prod(vol_shape))
    n = (x.shape[0] // vol) * vol
    if n == 0:
        raise ValueError(
            f"need at least {vol} synthetic voxels, got {x.shape[0]}")
    x = np.reshape(x[:n], (-1, *vol_shape, x.shape[-1]))
    y = np.reshape(y[:n], (-1, *vol_shape, 3))
    n_valid = max(1, x.shape[0] // 10)
    return (x[:-n_valid], y[:-n_valid]), (x[-n_valid:], y[-n_valid:])


def synthetic_batch_indices(rng: np.random.Generator, n: int,
                            batch_size: int) -> Iterator[np.ndarray]:
    """The volume indices of one epoch's shuffled batches: full batches
    only, or the whole set as one batch when it is smaller than a batch."""
    order = rng.permutation(n)
    n_full = n // batch_size
    if n_full == 0:
        yield order
        return
    for i in range(n_full):
        yield order[i * batch_size:(i + 1) * batch_size]


def synthetic_batches(rng: np.random.Generator, x: np.ndarray, y: np.ndarray,
                      batch_size: int) -> Iterator[dict]:
    """One epoch of shuffled {x, y} batches (reference train.py:100-103)."""
    for idx in synthetic_batch_indices(rng, x.shape[0], batch_size):
        yield {"x": x[idx], "y": y[idx]}


def blank_crop(data: np.ndarray) -> np.ndarray:
    """Crop away mostly-empty margins (reference: train.py:20).

    The fixed margins are sized for the reference's 96x96 acquisitions;
    on smaller (e.g. simulated) volumes they would silently produce an
    EMPTY array -- and NaN losses downstream -- so the crop is skipped
    with a warning when it would remove everything."""
    if data.shape[1] <= 34 or data.shape[2] <= 20:
        import warnings
        warnings.warn(
            f"blank_crop margins (34, 20) would empty volumes of shape "
            f"{data.shape[1:3]}; skipping the crop", stacklevel=2)
        return np.float32(data)
    return np.float32(data[:, 17:-17, 10:-10])


def predict_priors(encode_fn: Callable, data: np.ndarray, k: int,
                   chunk: int = 4) -> np.ndarray:
    """Per-voxel prior maps from the pretrained encoder on masked volumes
    (reference: train.py:26-31). ``encode_fn(images) -> (q, q2, sigma)``;
    returns q[..., :k] as float32 (``encode_fn`` returns numpy arrays).
    Chunked over subjects to bound device memory; the ragged final chunk
    is zero-padded to the chunk shape, as the JAX pipeline does, and
    sliced off the output."""
    outs = []
    for i in range(0, data.shape[0], chunk):
        block = np.float32(data[i:i + chunk])
        n_blk = block.shape[0]
        if n_blk < chunk:
            block = np.concatenate(
                [block, np.zeros((chunk - n_blk,) + block.shape[1:],
                                 block.dtype)], axis=0)
        masked = block[..., :-1] * block[..., -1:]
        q, _, _ = encode_fn(masked)
        outs.append(np.asarray(q[:n_blk, ..., :k], np.float32))
    return np.concatenate(outs, axis=0)


class RealCropSampler:
    """Random-crop batch sampler over real volumes + priors.

    data: (S, X, Y, Z, n_taus + 1) with the mask as the last channel
    (already blank-cropped); priors: (S, X, Y, Z, 4|5).

    ``sample(batch)`` draws ``batch`` subjects (with replacement -- in
    distribution equivalent to the reference's infinite-repeat +
    shuffle(10000) stream over a handful of subjects, train.py:65-68) and
    one random x/y crop each. ``eval_batches`` walks subjects
    sequentially with a fixed top-left crop, batch 3, mirroring the
    study-set evaluation pipeline (train.py:238,70).
    """

    def __init__(self, data: np.ndarray, priors: np.ndarray, crop_size: int,
                 rng: Optional[np.random.Generator] = None):
        assert data.ndim == 5 and priors.ndim == 5
        self.data = np.float32(data)
        self.priors = np.float32(priors)
        self.crop = (min(crop_size, data.shape[1]), min(crop_size, data.shape[2]))
        self.rng = rng or np.random.default_rng(0)

    def _window(self, s: int, x0: int, y0: int) -> dict:
        cx, cy = self.crop
        d = self.data[s, x0:x0 + cx, y0:y0 + cy]
        p = self.priors[s, x0:x0 + cx, y0:y0 + cy]
        mask = d[..., -1:]
        images = d[..., :-1] * mask
        return {"images": images, "mask": mask, "priors": p}

    def sample(self, batch: int) -> dict:
        cx, cy = self.crop
        s_idx = self.rng.integers(0, self.data.shape[0], size=batch)
        xs = self.rng.integers(0, self.data.shape[1] - cx + 1, size=batch)
        ys = self.rng.integers(0, self.data.shape[2] - cy + 1, size=batch)
        parts = [self._window(s, x0, y0) for s, x0, y0 in zip(s_idx, xs, ys)]
        return {k: np.stack([p[k] for p in parts]) for k in parts[0]}

    def eval_batches(self, batch: int = 3) -> Iterator[dict]:
        # Full batches only, remainder dropped -- REFERENCE PARITY: the
        # upstream eval pipeline is batch(3, drop_remainder=True)
        # (train.py:70), so e.g. 8 study subjects evaluate as 2 batches
        # of 3 there too. The n_full == 0 case below is the one
        # deliberate deviation (the reference would evaluate nothing).
        n_full = self.data.shape[0] // batch
        if n_full == 0:
            # fewer subjects than one batch: evaluate what exists
            # (mirrors synthetic_batches; an empty iterator would
            # silently drop the ELBO validation -- and with it a sweep
            # trial's ranking metric -- on small study sets)
            parts = [self._window(s, 0, 0)
                     for s in range(self.data.shape[0])]
            yield {k: np.stack([p[k] for p in parts]) for k in parts[0]}
            return
        for i in range(n_full):
            parts = [self._window(s, 0, 0)
                     for s in range(i * batch, (i + 1) * batch)]
            yield {k: np.stack([p[k] for p in parts]) for k in parts[0]}
