"""The port's fine-tune losses (train/losses.py) against the JAX package's:
the reconstruction NLL, the three KL branches and the TV smoothness,
values and gradients. The sampled KLs take the normals the JAX function
draws from its key (the split structure of losses.kl_loss /
LogitMVN.mvg_kl_samples), handed over as numpy.

Tolerances: values rtol 1e-5 / atol 1e-6; gradients scale-normalised at
rtol 5e-4 / atol 5e-5 (tests/test_pallas_elbo.py:88-97).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_parity_utils  # noqa: E402,F401  (thread cap)
from qbold_vi_tpu.config import ModelConfig as JModel  # noqa: E402
from qbold_vi_tpu.dist.logit_mvn import LogitMVN as JDist  # noqa: E402
from qbold_vi_tpu.train import losses as jl  # noqa: E402
from qbold_vi_tpu_torch.config import ModelConfig  # noqa: E402
from qbold_vi_tpu_torch.dist.logit_mvn import LogitMVN  # noqa: E402
from qbold_vi_tpu_torch.train import losses as tl  # noqa: E402

VAL = dict(rtol=1e-5, atol=1e-6)
SHAPE = (2, 6, 5, 2)
SE_IDX = 2


def _grad_close(got, ref):
    ref = np.asarray(ref)
    scale = np.abs(ref).max() + 1e-8
    np.testing.assert_allclose(np.asarray(got) / scale, ref / scale,
                               rtol=5e-4, atol=5e-5)


def _mask(rng):
    return (rng.uniform(size=SHAPE + (1,)) > 0.25).astype(np.float32)


def _both(fn_j, fn_t, *arrays):
    """Value and gradients (w.r.t. every array) of a JAX and a torch
    scalar function of the same numpy arrays."""
    v_ref, g_ref = jax.value_and_grad(fn_j, argnums=tuple(
        range(len(arrays))))(*map(jnp.asarray, arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    v = fn_t(*ts)
    g = torch.autograd.grad(v, ts)
    np.testing.assert_allclose(float(v.detach()), float(v_ref), **VAL)
    for a, b in zip(g, g_ref):
        _grad_close(a.numpy(), b)


@pytest.mark.parametrize("df,multi,log", [
    (200.0, False, False),          # OPTIMAL: Gaussian branch
    (2.0, True, False),             # Student-t, 3-image normaliser
    (4.0, False, True),             # log-domain residuals
])
def test_fine_tune_nll(df, multi, log):
    rng = np.random.default_rng(1)
    kw = dict(student_t_df=df, multi_image_normalisation=multi,
              predict_log_data=log)
    jcfg, tcfg = JModel(**kw), ModelConfig(**kw)
    mask = _mask(rng)
    y = (np.abs(rng.normal(size=SHAPE + (11,))) + 0.3).astype(np.float32)
    y = y * mask
    pred = (np.abs(rng.normal(size=SHAPE + (11,))) + 0.3).astype(np.float32)
    sig = rng.uniform(0.05, 0.2, size=SHAPE + (11,)).astype(np.float32)
    _both(lambda p, s: jl.fine_tune_nll(jcfg, SE_IDX, jnp.asarray(y), p, s,
                                        jnp.asarray(mask)),
          lambda p, s: tl.fine_tune_nll(tcfg, SE_IDX, torch.from_numpy(y), p,
                                        s, torch.from_numpy(mask)),
          pred, sig)


@pytest.mark.parametrize("branch", ["mvg", "mvg_pop", "mog", "diag",
                                    "diag_pop"])
def test_kl_loss(branch):
    rng = np.random.default_rng(2)
    mvg = branch.startswith("mvg")
    pop = branch.endswith("pop") or branch == "mog"
    kw = dict(use_mvg=mvg, use_population_prior=pop,
              mog_components=3 if branch == "mog" else 1)
    jcfg, tcfg = JModel(**kw), ModelConfig(**kw)
    k = 5 if mvg else 4
    mask = _mask(rng)
    q = (rng.normal(size=SHAPE + (k,)) * 0.6).astype(np.float32)
    kp = 12 if branch == "mog" else k
    if pop:
        prior = (rng.normal(size=(kp,)) * 0.5).astype(np.float32)
    else:
        prior = (rng.normal(size=SHAPE + (k,)) * 0.6).astype(np.float32)
    key = jax.random.PRNGKey(9)
    s_kl = 8
    if mvg:
        z = jax.vmap(lambda kk: jax.random.normal(kk, SHAPE + (2,)))(
            jax.random.split(key, s_kl))
    elif branch == "mog":
        z = jnp.stack([jax.random.normal(kk, SHAPE)
                       for kk in jax.random.split(key)])
    else:
        z = None
    zt = None if z is None else torch.from_numpy(np.array(z))

    def j(qq, pp):
        pb = jnp.broadcast_to(pp, SHAPE + (kp,)) if pop else pp
        return jl.kl_loss(key, JDist(), jcfg, pb, qq, jnp.asarray(mask),
                          no_samples=s_kl)

    def t(qq, pp):
        pb = pp.expand(SHAPE + (kp,)) if pop else pp
        return tl.kl_loss(LogitMVN(), tcfg, pb, qq, torch.from_numpy(mask),
                          z=zt)

    _both(j, t, q, prior)


def test_smoothness_and_mvg_kl_closed_form():
    rng = np.random.default_rng(4)
    mask = _mask(rng)
    q = (rng.normal(size=SHAPE + (5,)) * 0.6).astype(np.float32)
    _both(lambda qq: jl.smoothness_loss(JDist(), qq, jnp.asarray(mask)),
          lambda qq: tl.smoothness_loss(LogitMVN(), qq,
                                        torch.from_numpy(mask)), q)
    p = (rng.normal(size=SHAPE + (5,)) * 0.6).astype(np.float32)
    _both(lambda a, b: jnp.sum(JDist().mvg_kl_closed_form(a, b)),
          lambda a, b: torch.sum(LogitMVN().mvg_kl_closed_form(a, b)), q, p)


def test_safe_mask_sum_and_inv_gamma():
    zero = torch.zeros(3, 1)
    assert float(tl.safe_mask_sum(zero)) == 1.0
    x = np.linspace(0.1, 3.0, 7).astype(np.float32)
    np.testing.assert_allclose(
        tl.inv_gamma_log_prob(torch.from_numpy(x), 2.5, 0.7).numpy(),
        np.asarray(jl.inv_gamma_log_prob(jnp.asarray(x), 2.5, 0.7)), **VAL)
    assert dataclasses.asdict(ModelConfig()) == dataclasses.asdict(JModel())
