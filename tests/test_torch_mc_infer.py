"""The slice end to end: the port's sampled posterior maps
(``posterior_maps(method="mc")``) and fine-tuned export (``elbo_maps``,
``save_predictions(fine_tuned=True)``) against the JAX package's, on the
same weights and cohort.

The port draws through one function, infer.draw_noise; here it is
replaced by the normals of the JAX key chain (qbold_vi_tpu/infer.py:
posterior_maps' per-chunk ``split``, _elbo_maps_one's decode and KL keys,
dist/logit_mvn.py's per-sample ``split``), so both packages take the same
draws. Tolerances: the posterior maps at rtol 1e-4 / atol 3e-5 (means) and
rtol 1e-3 / atol 3e-5 (variances, with the R2' floor of
torch_parity_utils.assert_vars_close); the likelihood, KL and residual
maps at rtol 1e-5 / atol 1e-5.
"""

import dataclasses
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity_utils import (assert_vars_close, port_params,  # noqa: E402
                                port_tuner, volume)
from qbold_vi_tpu import infer as jinfer  # noqa: E402
from qbold_vi_tpu.config import OPTIMAL, ScanParams  # noqa: E402
from qbold_vi_tpu_torch import config as tcfg  # noqa: E402
from qbold_vi_tpu_torch import infer as tinfer  # noqa: E402
from qbold_vi_tpu_torch.io import nifti  # noqa: E402
from qbold_vi_tpu_torch.models.vi import FineTuner, init_params  # noqa: E402

SCAN = ScanParams(simulate_noise=False)
CFG = dataclasses.replace(OPTIMAL.model, compute_dtype="float32",
                          no_units=16)
MEAN_TOL = dict(rtol=1e-4, atol=3e-5)
VAR_TOL = dict(rtol=1e-3, atol=3e-5)
MAP_TOL = dict(rtol=1e-5, atol=1e-5)


def _cohort(seed, shape=(4, 6, 6, 2)):
    rng = np.random.default_rng(seed)
    data = volume(rng, shape, SCAN.n_taus + 1)
    data[..., -1] = rng.uniform(size=shape) > 0.3
    return data


def _normals(key, shape, draws=None, index=None):
    """draw ``index`` of split(key, draws), or all of them stacked."""
    keys = jax.random.split(key, draws)
    pick = range(draws) if index is None else [index]
    z = np.stack([np.asarray(jax.random.normal(keys[i], shape + (2,),
                                               jnp.float32)) for i in pick])
    return torch.from_numpy(z if index is None else z[0])


def jax_key_chain(key, chunk):
    """A draw_noise replacement giving the normals the JAX package draws
    from ``key`` at this ``chunk``."""
    chain = []

    def chunk_key(c):
        while len(chain) <= c:
            prev = chain[-1][0] if chain else key
            chain.append(jax.random.split(prev))
        return chain[c][1]

    def draw(stream, seed, start, shape, draws, device, index=None):
        del seed, device
        k = chunk_key(start // chunk)
        if stream == "summaries":
            return {"z": _normals(k, shape, draws)}
        k_dec, k_kl = jax.random.split(k)
        if stream == "kl":
            return {"z": _normals(k_kl, shape, draws)}
        k_sample, _ = jax.random.split(k_dec)
        return {"z": _normals(k_sample, shape, draws, index)}

    return draw


@pytest.fixture
def jax_draws(monkeypatch):
    def use(key, chunk):
        monkeypatch.setattr(tinfer, "draw_noise", jax_key_chain(key, chunk))
    return use


@pytest.mark.parametrize("use_first_op", [True, False],
                         ids=["stream1", "stream2"])
def test_mc_posterior_maps_match_jax(jax_draws, use_first_op):
    data = _cohort(0)
    jt, params = port_params(CFG, SCAN, seed=4)
    key = jax.random.PRNGKey(0)
    ref = jinfer.posterior_maps(jt, params, data, key, use_pallas=False,
                                chunk=2, use_first_op=use_first_op,
                                method="mc")
    jax_draws(key, 2)
    tuner = port_tuner(dataclasses.replace(CFG, fused_infer="on"), SCAN,
                       params)
    got = tinfer.posterior_maps(tuner, data, chunk=2, method="mc",
                                antithetic=False, use_first_op=use_first_op)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
    for k in ("oef", "dbv", "r2p", "raw_log_stds"):
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **MEAN_TOL)
    means = np.concatenate([ref["oef"], ref["dbv"], ref["r2p"]], -1)
    assert_vars_close(got["stds"], ref["stds"], means, **VAR_TOL)


ELBO_CASES = {
    "mvg-priors": (CFG, True),
    "diag-population-prior": (dataclasses.replace(
        CFG, use_mvg=False, use_population_prior=True), False),
}


@pytest.mark.parametrize("case", list(ELBO_CASES))
def test_elbo_maps_match_jax(jax_draws, case):
    cfg, with_priors = ELBO_CASES[case]
    data = _cohort(1, (2, 6, 6, 2))
    rng = np.random.default_rng(2)
    priors = ((rng.normal(size=data.shape[:-1] + (5,)) * 0.5
               ).astype(np.float32) if with_priors else None)
    jt, params = port_params(cfg, SCAN, seed=5)
    qcfg = dataclasses.replace(OPTIMAL, model=cfg, scan=SCAN)
    key = jax.random.PRNGKey(3)
    ref = jinfer.elbo_maps(jt, qcfg, params, data, priors, key,
                           no_samples=12, use_pallas_kl=False)
    jax_draws(key, 1)
    tuner = port_tuner(cfg, SCAN, params)
    tq = tcfg.QBoldConfig(model=tuner.cfg, scan=tuner.scan)
    got = tinfer.elbo_maps(tuner, tq, data, priors, no_samples=12)
    assert set(got) == set(ref) == {"likelihood", "kl", "residual"}
    for k in ref:
        assert got[k].shape == ref[k].shape == data.shape[:-1] + (1,)
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), err_msg=k,
                                   **MAP_TOL)


@pytest.mark.parametrize("with_priors", [True, False])
def test_save_predictions_fine_tuned(tmp_path, with_priors):
    cfg = tcfg.ModelConfig(use_mvg=True, no_units=8)
    scan = tcfg.ScanParams()
    tuner = FineTuner(cfg, scan, device="cpu")
    tuner.load_state_dict(init_params(cfg, scan,
                                      torch.Generator().manual_seed(0)))
    qcfg = tcfg.QBoldConfig(model=cfg, scan=scan)
    data = _cohort(2, (2, 4, 3, 2))
    priors = (np.random.default_rng(3).normal(size=data.shape[:-1] + (5,))
              .astype(np.float32) if with_priors else None)
    prefix = str(tmp_path / "out" / "maps")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        maps = tinfer.save_predictions(tuner, qcfg, data, prefix,
                                       fine_tuned=True, priors=priors,
                                       method="mc", seed=2)
    warned = any("priors" in str(w.message) for w in caught)
    assert warned is not with_priors
    keys = ["oef", "dbv", "r2p", "stds", "raw_log_stds", "likelihood",
            "residual"] + (["kl"] if with_priors else [])
    assert set(maps) == set(keys)
    suffix = {"stds": "_logstds", "raw_log_stds": "_raw_logstds"}
    written = sorted(os.listdir(tmp_path / "out"))
    assert written == sorted(f"maps{suffix.get(k, '_' + k)}.nii.gz"
                             for k in keys)
    for k in keys:
        back = nifti.load_nifti(prefix + suffix.get(k, "_" + k) + ".nii.gz")
        m = maps[k]
        folded = np.concatenate(np.split(m, m.shape[0], 0), -1)[0]
        np.testing.assert_array_equal(back, folded, err_msg=k)
        assert np.isfinite(m).all(), k
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        again = tinfer.save_predictions(tuner, qcfg, data, prefix + "2",
                                        fine_tuned=True, priors=priors,
                                        method="mc", seed=2)
    for k in keys:
        np.testing.assert_array_equal(again[k], maps[k], err_msg=k)

