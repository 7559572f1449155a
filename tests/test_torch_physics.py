"""The port's Bessel functions and ASE forward model (ops/bessel.py,
ops/physics.py) against the JAX package's, values and gradients.

Tolerances: values rtol 1e-5 / atol 1e-6 (float32 arithmetic in the same
order; torch's and XLA's exp/cos differ in the last bit); gradients
scale-normalised at rtol 1e-5 / atol 1e-6 for the Bessel functions and
rtol 5e-4 / atol 5e-5 for the signal, the gates the JAX package applies to
its own kernels (tests/test_pallas_elbo.py:88-97).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_parity_utils  # noqa: E402,F401  (thread cap)
from qbold_vi_tpu.config import ScanParams as JScan  # noqa: E402
from qbold_vi_tpu.ops import bessel as jb  # noqa: E402
from qbold_vi_tpu.ops import physics as jp  # noqa: E402
from qbold_vi_tpu_torch.config import ScanParams  # noqa: E402
from qbold_vi_tpu_torch.ops import bessel as tb  # noqa: E402
from qbold_vi_tpu_torch.ops import physics as tp  # noqa: E402

VAL = dict(rtol=1e-5, atol=1e-6)


def _grad_close(got, ref, rtol, atol):
    scale = np.abs(ref).max() + 1e-8
    np.testing.assert_allclose(got / scale, ref / scale, rtol=rtol, atol=atol)


def test_tables_are_the_same_words():
    for name in ("_GJ16_U", "_GJ16_WG", "_U", "_GW"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name))
    assert tp._CHEB_I32 == jp._CHEB_I32
    assert tp._CHEB_DI32 == jp._CHEB_DI32
    assert tp._CHEB_CMAX == jp._CHEB_CMAX


@pytest.mark.parametrize("name", ["bessel_j0", "bessel_j1", "one_minus_j0"])
def test_bessel_values_and_grads(name):
    x = np.concatenate([np.linspace(-40.0, 40.0, 2001),
                        np.array([0.0, 1e-4, -0.5, 1.0, 3.0, -3.0])]
                       ).astype(np.float32)
    jf, tf = getattr(jb, name), getattr(tb, name)
    ref = np.asarray(jf(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    got = tf(xt)
    np.testing.assert_allclose(got.detach().numpy(), ref, **VAL)
    if name == "bessel_j1":
        return                     # differentiated only through the others
    g_ref = np.asarray(jax.grad(lambda v: jnp.sum(jf(v)))(jnp.asarray(x)))
    (g,) = torch.autograd.grad(got.sum(), xt)
    _grad_close(g.numpy(), g_ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rule,blood,full", [
    ("cheb", True, True),           # OPTIMAL
    ("gj16", True, True),
    ("cheb", False, True),
    ("gj16", False, True),
    ("auto", True, False),          # asymptotic tissue model
])
def test_ase_signal_matches(rule, blood, full):
    rng = np.random.default_rng(3)
    oef = rng.uniform(0.04, 0.84, size=(3, 50)).astype(np.float32)
    dbv = rng.uniform(0.001, 0.201, size=(3, 50)).astype(np.float32)
    kw = dict(full_model=full, include_blood=blood, quad_rule=rule,
              max_oef=0.84)

    def jf(o, d):
        return jp.ase_signal(o, d, JScan(), **kw)

    ref = np.asarray(jf(jnp.asarray(oef), jnp.asarray(dbv)))
    to = torch.from_numpy(oef).requires_grad_()
    td = torch.from_numpy(dbv).requires_grad_()
    got = tp.ase_signal(to, td, ScanParams(), **kw)
    np.testing.assert_allclose(got.detach().numpy(), ref, **VAL)
    w = rng.normal(size=ref.shape).astype(np.float32)
    g_ref = jax.grad(lambda o, d: jnp.sum(jf(o, d) * w), argnums=(0, 1))(
        jnp.asarray(oef), jnp.asarray(dbv))
    g = torch.autograd.grad((got * torch.from_numpy(w)).sum(), (to, td))
    for a, b in zip(g, g_ref):
        _grad_close(a.numpy(), np.asarray(b), rtol=5e-4, atol=5e-5)


def test_reference_compat_lattice_and_rule_selection():
    rng = np.random.default_rng(5)
    oef = rng.uniform(0.04, 0.84, size=64).astype(np.float32)
    dbv = rng.uniform(0.001, 0.201, size=64).astype(np.float32)
    ref = jp.ase_signal(jnp.asarray(oef), jnp.asarray(dbv), JScan(),
                        reference_fp32_compat=True)
    got = tp.ase_signal(torch.from_numpy(oef), torch.from_numpy(dbv),
                        ScanParams(), reference_fp32_compat=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **VAL)
    for kw in (dict(), dict(tau_start=-0.028, tau_step=0.004, tau_end=0.2)):
        for max_oef in (0.84, 2.0):
            assert tp.select_quad_rule(ScanParams(**kw), max_oef=max_oef) == \
                jp.select_quad_rule(JScan(**kw), max_oef=max_oef)
    with pytest.raises(ValueError, match="quad_rule"):
        tp.ase_signal(torch.ones(2), torch.ones(2), ScanParams(),
                      quad_rule="simpson")
    assert dataclasses.asdict(ScanParams()) == dataclasses.asdict(JScan())
