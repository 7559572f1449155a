"""The rest of the port's LogitMVN (dist/logit_mvn.py) against the JAX
package's: ``scale_uncertainty``, ``mvg_kl_analytic_marginals``,
``mvg_kl_samples_reference`` and the materialised ``posterior_means``.

Where the JAX method draws from a key, the port takes the normals that key
gives (``jax.vmap(jax.random.normal)`` over ``jax.random.split(key, S)``,
as ``sample_many`` draws them). Tolerances: values at rtol 1e-5 / atol
1e-6 (the JAX package's dist gates); gradients scaled by the reference's
largest entry at rtol 1e-5 / atol 1e-6; ``scale_uncertainty`` (one add and
one product) at rtol 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qbold_vi_tpu.dist.logit_mvn import LogitMVN as JLogitMVN  # noqa: E402
from qbold_vi_tpu_torch.dist.logit_mvn import LogitMVN  # noqa: E402

JD, TD = JLogitMVN(), LogitMVN()


def _heads(rng, shape, k=5, scale=0.4):
    return (rng.normal(size=shape + (k,)) * scale).astype(np.float32)


def _key_normals(key, shape, s):
    return np.array(jax.vmap(lambda k: jax.random.normal(k, shape + (2,)))(
        jax.random.split(key, s)))


def _close_grads(got, ref):
    scale = np.abs(ref).max() + 1e-12
    np.testing.assert_allclose(got / scale, ref / scale, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mvg", [True, False])
def test_scale_uncertainty_matches_jax(mvg):
    rng = np.random.default_rng(0)
    q = _heads(rng, (3, 4), 5 if mvg else 4)
    for f in (0.25, 2.0):
        ref = np.asarray(JD.scale_uncertainty(jnp.asarray(q), f, mvg))
        got = TD.scale_uncertainty(torch.from_numpy(q), f, mvg).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[..., [0, 2]], q[..., [0, 2]])


def test_scale_uncertainty_shrinks_the_spread():
    """The JAX package's gate (tests/test_dist.py:217): scaling by f
    shrinks the logit-space spread of the draws markedly toward f."""
    q = torch.tensor([[0.1, -0.3, -0.6, -0.2, 0.4]])
    z = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2000, 1, 2)).astype(np.float32))
    scaled = TD.scale_uncertainty(q, 0.25, mvg=True)
    lo = TD.backwards_transform(TD.sample_many(z, q, True), True)[:, 0]
    ls = TD.backwards_transform(TD.sample_many(z, scaled, True), True)[:, 0]
    assert torch.all(ls.std(0) / lo.std(0) < 0.55)


def test_mvg_kl_analytic_marginals_matches_jax():
    rng = np.random.default_rng(2)
    q, p = _heads(rng, (4, 6)), _heads(rng, (4, 6))
    ref, vjp = jax.vjp(lambda a: JD.mvg_kl_analytic_marginals(
        a, jnp.asarray(p)), jnp.asarray(q))
    qt = torch.from_numpy(q).requires_grad_()
    got = TD.mvg_kl_analytic_marginals(qt, torch.from_numpy(p))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    got.sum().backward()
    _close_grads(qt.grad.numpy(), np.asarray(vjp(jnp.ones_like(ref))[0]))


def test_mvg_kl_samples_reference_matches_jax_and_the_streamed_form():
    """Value and pathwise gradient (q detached inside log q) against the
    JAX transcription given its key's normals, and against the port's
    reduced streamed form, which it is the oracle of."""
    rng = np.random.default_rng(3)
    q, p = _heads(rng, (3, 5)), _heads(rng, (3, 5))
    key = jax.random.PRNGKey(4)
    s = 16
    z = torch.from_numpy(_key_normals(key, (3, 5), s))

    def jloss(a):
        return jnp.sum(JD.mvg_kl_samples_reference(key, a, jnp.asarray(p),
                                                   no_samples=s))

    ref_v = np.asarray(JD.mvg_kl_samples_reference(
        key, jnp.asarray(q), jnp.asarray(p), no_samples=s))
    ref_g = np.asarray(jax.grad(jloss)(jnp.asarray(q)))
    qt = torch.from_numpy(q).requires_grad_()
    got = TD.mvg_kl_samples_reference(z, qt, torch.from_numpy(p))
    np.testing.assert_allclose(got.detach().numpy(), ref_v, rtol=1e-5,
                               atol=1e-6)
    got.sum().backward()
    _close_grads(qt.grad.numpy(), ref_g)

    qs = torch.from_numpy(q).requires_grad_()
    streamed = TD.mvg_kl_samples(z, qs, torch.from_numpy(p))
    np.testing.assert_allclose(streamed.detach().numpy(),
                               got.detach().numpy(), rtol=1e-4, atol=1e-5)
    streamed.sum().backward()
    _close_grads(qs.grad.numpy(), qt.grad.numpy())


@pytest.mark.parametrize("mvg", [True, False])
def test_posterior_means_matches_jax(mvg):
    rng = np.random.default_rng(5 + mvg)
    params = _heads(rng, (4, 4), 5 if mvg else 4, scale=0.3)
    key = jax.random.PRNGKey(11)
    z = torch.from_numpy(_key_normals(key, (4, 4), 50))

    def r2p(oef, dbv):
        return 301.7 * oef * dbv

    jm, jv = JD.posterior_means(key, jnp.asarray(params), mvg=mvg,
                                no_samples=50, return_stds=True, r2p_fn=r2p)
    tm, tv = TD.posterior_means(z, torch.from_numpy(params), mvg,
                                return_stds=True, r2p_fn=r2p)
    assert tm.shape == tv.shape == (4, 4, 3)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)
    plain = TD.posterior_means(z, torch.from_numpy(params), mvg)
    assert plain.shape == (4, 4, 2)
    np.testing.assert_array_equal(plain.numpy(), tm[..., :2].numpy())
    assert torch.all(plain[..., 0] > TD.min_oef)
    assert torch.all(plain[..., 1] < TD.min_dbv + TD.dbv_range)
