"""The port's quadrature summaries (ops/quadrature.py, kernel A's plain
version and wrapper) against the JAX package's.

Tolerances: means rtol 1e-5 / atol 2e-6 (the same fp32 arithmetic, with
torch's exp/tanh in place of XLA's, which differ in the last bit);
variances rtol 1e-3 / atol 1e-6, because E[x^2] - E[x]^2 cancels and
amplifies last-bit differences. Those gates run at the functions'
default dw_coeff = 1; at the physical dw_coeff (~300) the R2' variance is
dw^2 E[(oef dbv)^2] - mean^2, whose rounding noise is a few ulps of the
second moment, not of the variance (see test_physical_dw_coeff).

Head mixes (torch_parity_utils.HEAD_MIXES): every 1-D moment problem
below the s = 1.5 split, every one above it, or straddling it; each
holds the plain version against the JAX one at the tolerances above.

Kernel A (csrc/quadrature.cu) sorts each routine's problems by side
across its block and takes the hardware's exponentials and reciprocals,
but sums every node in the plain version's order: the sort moves problems
between threads, not terms within a sum, so no replay of another order is
needed. What the card's float32 sums lose against exact arithmetic is
bounded by the plain version's own error against a float64 evaluation of
the same node words (the plain code run in double), at the physical dw_coeff:
means within 5e-5, the OEF and DBV variances within 2e-6 and the R2'
variance within 128 float32 ulps of its second moment (measured: 1.4e-5,
2.5e-7 and 59 ulps), the yardstick beside which chip_smoke.py prints the
kernel's float64 error.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from torch_parity_utils import (HEAD_MIXES, assert_vars_close,  # noqa: E402
                                head_mix, raw_head)
from qbold_vi_tpu.ops import quadrature as jq  # noqa: E402
from qbold_vi_tpu_torch.ops import quadrature as tq  # noqa: E402

RANGES = dict(oef_range=0.8, min_oef=0.04, dbv_range=0.2, min_dbv=0.001,
              dw_coeff=1.0)
DW_PHYS = dict(RANGES, dw_coeff=301.7)
MEAN_TOL = dict(rtol=1e-5, atol=2e-6)
VAR_TOL = dict(rtol=1e-3, atol=1e-6)
F64_MEAN_ATOL = 5e-5
F64_VAR_ATOL = 2e-6
F64_R2P_ULPS = 128


def test_node_constants_are_the_same_float32_words():
    for name in ("XH", "WH", "TL"):
        np.testing.assert_array_equal(getattr(tq, name), getattr(jq, name))
    for k in range(5):
        np.testing.assert_array_equal(tq.PK[k], getattr(jq, f"P{k + 1}"))
        np.testing.assert_array_equal(tq.MK[k], getattr(jq, f"M{k + 1}"))
    assert tq.QUAD_CONSTS.dtype == np.float32
    assert tq.QUAD_CONSTS.shape == (208,)


@pytest.mark.parametrize("mvg", [True, False])
def test_plain_matches_jax(mvg):
    rng = np.random.default_rng(1)
    q = raw_head(rng, 600)
    s = np.exp(np.tanh(q[:, 1]) * 3.0 - 1.0)
    assert (s < 1.5).any() and (s >= 1.5).any()     # both branches run
    m_ref, v_ref = jq.posterior_summaries_quadrature(
        jnp.asarray(q), mvg=mvg, **RANGES)
    m, v = tq.posterior_summaries_quadrature(torch.from_numpy(q), mvg=mvg,
                                             **RANGES)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), **MEAN_TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), **VAR_TOL)


def _routine_sides(q, mvg):
    """Per 1-D moment routine (omom on s0, mom on sqrt(od^2 + s1^2), gmom
    on s1): does any problem take the Gauss-Laguerre side, does any not."""
    ls0 = np.tanh(q[:, 1].astype(np.float64)) * 3.0 - 1.0
    ls1 = np.tanh(q[:, 3].astype(np.float64)) * 3.0 - 1.0
    od = np.tanh(q[:, 4]) * np.exp(-2.0) if mvg else 0.0
    s0, s1 = np.exp(ls0), np.exp(ls1)
    return [((s >= tq.SPLIT_THRESHOLD).any(), (s < tq.SPLIT_THRESHOLD).any())
            for s in (s0, np.sqrt(od * od + s1 * s1), s1)]


@pytest.mark.parametrize("mvg", [True, False])
@pytest.mark.parametrize("mix", HEAD_MIXES)
def test_plain_matches_jax_by_head_mix(mix, mvg):
    """Heads entirely below the split, entirely above it, and straddling
    it: each side of every routine against the JAX function."""
    rng = np.random.default_rng(11)
    q = head_mix(rng, 512, mix)
    want = {"below": (False, True), "above": (True, False),
            "straddling": (True, True)}[mix]
    assert _routine_sides(q, mvg) == [want] * 3
    m_ref, v_ref = jq.posterior_summaries_quadrature(
        jnp.asarray(q), mvg=mvg, **DW_PHYS)
    m, v = tq.posterior_summaries_quadrature(torch.from_numpy(q), mvg=mvg,
                                             **DW_PHYS)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), **MEAN_TOL)
    assert_vars_close(v.numpy(), np.asarray(v_ref), np.asarray(m_ref),
                      **VAR_TOL)


@pytest.mark.parametrize("mvg", [True, False])
@pytest.mark.parametrize("mix", HEAD_MIXES)
def test_plain_against_float64_node_words(mix, mvg):
    """The plain float32 version against the same code in double on the
    same float32 node words (QUAD_CONSTS): the float32 error that kernel A
    is held beside on the card."""
    rng = np.random.default_rng(12)
    q = torch.from_numpy(head_mix(rng, 512, mix))
    m, v = tq.posterior_summaries_quadrature(q, mvg=mvg, **DW_PHYS)
    m64, v64 = tq.posterior_summaries_quadrature(q.double(), mvg=mvg,
                                                 **DW_PHYS)
    assert m.dtype == torch.float32 and m64.dtype == torch.float64
    np.testing.assert_allclose(m.double().numpy(), m64.numpy(), rtol=0,
                               atol=F64_MEAN_ATOL)
    second = (v64[:, 2] + m64[:, 2] ** 2).numpy()
    err = (v.double() - v64).abs().numpy()
    assert (err[:, :2] <= F64_VAR_ATOL).all(), err[:, :2].max()
    assert (err[:, 2] <= F64_R2P_ULPS * np.finfo(np.float32).eps
            * second).all()


@pytest.mark.parametrize("mvg", [True, False])
def test_wrapper_matches_pallas_interpret(mvg):
    """The wrapper (plain version on a CPU tensor) against the Pallas
    kernel it replaces, run by the Mosaic interpreter; ragged N."""
    rng = np.random.default_rng(2)
    q = raw_head(rng, 203)
    m_ref, v_ref = jq.quad_posterior_summaries(
        jnp.asarray(q), mvg=mvg, interpret=True, lanes=8, **RANGES)
    before = tq.quad_posterior_summaries.launches
    m, v = tq.quad_posterior_summaries(torch.from_numpy(q), mvg=mvg,
                                       **RANGES)
    assert tq.quad_posterior_summaries.launches == before  # no kernel
    assert m.shape == v.shape == (203, 3)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), **MEAN_TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), **VAR_TOL)


@pytest.mark.parametrize("mvg", [True, False])
def test_physical_dw_coeff(mvg):
    """Means at the stated tolerance; the R2' variance with an absolute
    floor of 16 float32 ulps of its second moment dw^2 E[r^2]."""
    rng = np.random.default_rng(5)
    q = raw_head(rng, 600)
    m_ref, v_ref = (np.asarray(a) for a in jq.posterior_summaries_quadrature(
        jnp.asarray(q), mvg=mvg, **DW_PHYS))
    m, v = (a.numpy() for a in tq.posterior_summaries_quadrature(
        torch.from_numpy(q), mvg=mvg, **DW_PHYS))
    np.testing.assert_allclose(m, m_ref, **MEAN_TOL)
    assert_vars_close(v, v_ref, m_ref, **VAR_TOL)


def test_tile_summaries_raw_transforms():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(raw_head(rng, 50))
    _, _, (ls0, ls1, od) = tq.quad_tile_summaries(
        *q.unbind(-1), mvg=True, **RANGES)
    np.testing.assert_allclose(ls0, np.tanh(q[:, 1].numpy()) * 3 - 1,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(od, np.tanh(q[:, 4].numpy()) * np.exp(-2.0),
                               rtol=1e-6, atol=1e-7)
    _, _, (_, _, od0) = tq.quad_tile_summaries(*q.unbind(-1), mvg=False,
                                               **RANGES)
    assert (od0 == 0).all()


@pytest.mark.parametrize("shape,mvg,err", [
    ((10, 3), True, ValueError),
    ((4, 5, 2), True, ValueError),
    ((10, 4), True, ValueError),       # mvg needs the off-diagonal channel
])
def test_wrapper_rejects_bad_shapes(shape, mvg, err):
    with pytest.raises(err):
        tq.quad_posterior_summaries(torch.zeros(shape), mvg=mvg)
