"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*).

Inputs are drawn with numpy from a seed and handed to both the JAX
function and its port; weights cross over through the port's bridge
(qbold_vi_tpu_torch/io/from_jax.py). Not a test module (no ``test_``
prefix), so pytest does not collect it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

# Tier-1 runs several xdist workers; one intra-op thread each keeps them
# from oversubscribing the cores.
torch.set_num_threads(1)


def jax_tuner_and_params(cfg, scan, images, seed: int = 0):
    """A JAX FineTuner and its params initialised on ``images``."""
    import jax

    from qbold_vi_tpu.models.vi import FineTuner

    tuner = FineTuner(cfg, scan)
    params = jax.jit(tuner.init)(jax.random.PRNGKey(seed), images)
    return tuner, params


def port_params(cfg, scan, seed: int = 0):
    """A JAX params tree (numpy leaves) drawn by the port's
    ``init_params`` -- no flax init to compile -- and the JAX FineTuner
    it belongs to."""
    from qbold_vi_tpu.models.vi import FineTuner
    from qbold_vi_tpu_torch import config as tcfg
    from qbold_vi_tpu_torch.io.from_jax import jax_from_state_dict
    from qbold_vi_tpu_torch.models.vi import init_params

    sd = init_params(tcfg.ModelConfig(**_fields(cfg)),
                     tcfg.ScanParams(**_fields(scan)),
                     torch.Generator().manual_seed(seed))
    return FineTuner(cfg, scan), jax_from_state_dict(sd)


def port_tuner(cfg, scan, jax_params, **kw):
    """The port's FineTuner (on the CPU) carrying the JAX params; ``kw``
    (full_model, use_blood) go to the FineTuner."""
    import jax

    from qbold_vi_tpu_torch import config as tcfg
    from qbold_vi_tpu_torch.io.from_jax import state_dict_from_jax
    from qbold_vi_tpu_torch.models.vi import FineTuner

    tuner = FineTuner(tcfg.ModelConfig(**_fields(cfg)),
                      tcfg.ScanParams(**_fields(scan)), device="cpu", **kw)
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    tuner.load_state_dict(state_dict_from_jax(tree))
    return tuner


def _fields(dc) -> dict:
    import dataclasses

    return {f.name: getattr(dc, f.name) for f in dataclasses.fields(dc)}


def volume(rng, shape, n_taus: int) -> np.ndarray:
    """Positive ASE-like signals (..., n_taus), float32."""
    return (np.abs(rng.normal(size=tuple(shape) + (n_taus,)))
            .astype(np.float32) * 50.0 + 100.0)


def raw_head(rng, n: int, k: int = 5) -> np.ndarray:
    """Raw posterior head rows whose logit stds straddle the s = 1.5
    split (log-std tanh(q)*3-1 >= log 1.5 where q >= ~0.51)."""
    q = rng.normal(size=(n, k)).astype(np.float32)
    q[:, 0] *= 3.0
    q[:, 2] *= 3.0
    q[:, 1] *= 1.5
    q[:, 3] *= 1.5
    return q


EPS32 = float(np.finfo(np.float32).eps)


def assert_vars_close(got, ref, mean_ref, *, rtol: float, atol: float):
    """Posterior variances (..., 3) of (OEF, DBV, R2') against a
    reference. OEF and DBV at (rtol, atol). The R2' variance is
    dw^2 E[(oef dbv)^2] - E[r]^2 in float32 with dw ~ 300: its rounding
    noise is a few ulps of the second moment E[r^2], not of the variance,
    so its absolute bound is the larger of atol and 16 ulps of E[r^2]."""
    got, ref, mean_ref = (np.asarray(a) for a in (got, ref, mean_ref))
    np.testing.assert_allclose(got[..., :2], ref[..., :2], rtol=rtol,
                               atol=atol, err_msg="OEF/DBV variances")
    second = ref[..., 2] + mean_ref[..., 2] ** 2
    bound = rtol * np.abs(ref[..., 2]) + np.maximum(atol, 16 * EPS32 * second)
    err = np.abs(got[..., 2] - ref[..., 2])
    assert (err <= bound).all(), (
        f"R2' variance: max excess {np.max(err - bound)}")


@pytest.fixture
def cuda_device():
    """The first CUDA card; tests that need one skip without it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the H100 with "
                    "python -m pytest --noconftest -m cuda tests/test_torch_cuda.py")
    return torch.device("cuda", 0)
