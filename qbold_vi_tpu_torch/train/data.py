"""Real-data input pipeline: blank crop, per-voxel priors from the
pretrained encoder, and random-crop fine-tune batches (numpy).

A copy of ``qbold_vi_tpu/train/data.py:77-206`` (reference
train.py:17-72) for the port, which cannot import the JAX package. The
synthetic-data pipeline (pretraining) is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional

import numpy as np

__all__ = ["blank_crop", "predict_priors", "RealCropSampler"]


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
