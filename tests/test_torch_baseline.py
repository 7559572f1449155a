"""The port's WLS baseline (qbold_vi_tpu_torch/baseline.py) against the JAX
package's (qbold_vi_tpu/baseline.py), on the CPU.

Signals: random positive magnitudes, physics-generated ones (the forward
model at OEF / DBV across their ranges, x 800, with and without noise),
and rows with zeros, negatives, NaN and inf, whose logs are not finite
(zeroed by both) and whose fits are degenerate (sanitised by both).

Tolerance (torch_parity_utils.assert_wls_close): each map at rtol 1e-5
plus 8 float32 ulps of the voxel's
largest |ln S| carried through the fit: u = 8 eps |ln S| for DBV, u / sd
for R2' (sd the weighted spread of the fitted taus, ~0.015 s), and OEF =
R2' / (DBV k) the sum of the two relative terms. Looser than 1e-5
relative because the fit cancels twice in float32, and the packages sum
the taus in different orders: the weighted covariance sums (tau - mean
tau) ln S where ln S is nearly constant (ln 800 ~ 6.7 against a slope
of a few per 0.01 s), and DBV is the intercept minus ln S(0), two
numbers near ln S0 whose difference is ~1% of either (measured: 2-7e-4
relative at most, within ~2 ulps of ln S).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from torch_parity_utils import assert_wls_close  # noqa: E402

from qbold_vi_tpu import baseline as jbase  # noqa: E402
from qbold_vi_tpu import config as jcfg  # noqa: E402
from qbold_vi_tpu.ops import physics as jphys  # noqa: E402
from qbold_vi_tpu_torch import baseline as tbase  # noqa: E402
from qbold_vi_tpu_torch import config as tcfg  # noqa: E402


def _scan(**kw):
    scan = jcfg.ScanParams(**kw)
    return scan, tcfg.ScanParams(**{f.name: getattr(scan, f.name)
                                    for f in dataclasses.fields(scan)})


def _signals(kind, scan, rng):
    if kind == "random":
        return (rng.uniform(0.3, 1.0, size=(40, 37, scan.n_taus)) * 800.0
                ).astype(np.float32)
    n = 4096
    oef = rng.uniform(0.05, 0.8, n).astype(np.float32)
    dbv = rng.uniform(0.003, 0.195, n).astype(np.float32)
    sig = np.asarray(jphys.ase_signal(jnp.asarray(oef), jnp.asarray(dbv),
                                      scan)) * 800.0
    if kind == "physics+noise":
        sig = sig + rng.normal(size=sig.shape) * sig.mean() / 80.0
    return sig.astype(np.float32)


def _degenerate(scan):
    """Rows whose logs are not finite somewhere, and an all-zero row (every
    log -inf, zeroed: R2' = DBV = 0, OEF 0 / 0 -> NaN -> 0 -> 0.01)."""
    t = scan.n_taus
    rows = np.tile(np.linspace(900.0, 300.0, t, dtype=np.float32), (6, 1))
    rows[1] = 0.0
    rows[2, ::2] = -1.0                            # log of negatives: NaN
    rows[3, 6] = np.inf
    rows[4, 5] = np.nan
    rows[5, 2] = 0.0                               # ln S(0) = -inf
    return rows


@pytest.mark.parametrize("kind", ["random", "physics", "physics+noise",
                                  "degenerate"])
def test_wls_maps_match_jax(kind):
    scan, tscan = _scan()
    rng = np.random.default_rng(3)
    x = _degenerate(scan) if kind == "degenerate" else _signals(kind, scan,
                                                                rng)
    ref = jbase.wls_maps(x, scan)
    got = tbase.wls_maps(x, tscan, device="cpu")
    assert got.shape == x.shape[:-1] + (3,) and got.dtype == np.float32
    assert_wls_close(got, ref, x, scan)
    oef, dbv, r2p = tbase.fit_wls(torch.from_numpy(x), tscan)
    np.testing.assert_array_equal(torch.cat([oef, dbv, r2p], -1).numpy(),
                                  got)
    assert got[..., 0].min() >= 0.01 and got[..., 0].max() <= 0.8
    assert got[..., 1].min() >= 0.002 and got[..., 1].max() <= 0.25
    assert got[..., 2].min() >= 0.01 and got[..., 2].max() <= 100.0


def test_wls_on_the_24_tau_protocol():
    scan, tscan = _scan(tau_start=-0.028, tau_step=0.004)
    x = _signals("physics+noise", scan, np.random.default_rng(4))
    assert_wls_close(tbase.wls_maps(x, tscan, device="cpu"),
                     jbase.wls_maps(x, scan), x, scan)


def test_wls_maps_fits_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbase.wls_maps(np.ones((2, 11), np.float32), tcfg.ScanParams())
