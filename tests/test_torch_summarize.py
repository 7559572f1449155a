"""The port's sampled summaries (kernel D), sampled KL map (kernel E) and
stream-1 encode (kernel C) -- ops/summarize.py and ops/fused_infer.py,
plain versions -- against the JAX package on the same numpy inputs.

The JAX kernels D and E run in the Mosaic interpreter, whose PRNG returns
zero bits: every Box-Muller draw is then z = (r, 0) with
r = sqrt(-2 log(float32(1e-12))) ~ 7.434, whatever the seed, so the
port's plain versions are fed those normals; the premise is asserted with a second seed wherever it is relied
on. The JAX jnp estimators (LogitMVN.posterior_means_streamed,
mvg_kl_samples) are compared with their own key's normals regenerated.

Tolerances: means rtol 1e-4 / atol 3e-5; variances rtol 1e-3 / atol 3e-5
with the R2' floor of torch_parity_utils.assert_vars_close (E[x^2] - E[x]^2
cancels); the KL rows rtol 1e-5 / atol 1e-5; q rtol 1e-5 / atol 2e-5 (the
same float32 chain in another summation order).

Kernel E sums a voxel's draws on KL_LANES lanes (lane j the draws of
Philox blocks k = j mod lanes) and meets the lanes' sums in a fixed tree:
another order than the plain version's. Its replay
(torch_parity_utils.kl_lanes_replay) is held against the plain version at
every lane count, and at the kernel's lane count against the JAX kernel E
(interpreter) and the jnp estimator, at S = 2, 7 and 100 on a ragged N:
the KL rows' tolerance plus 16 float32 ulps of the parts each row cancels
from (torch_parity_utils.assert_kl_close: the mean of 0.5 (swr_p + swr_q)
over its draws and the magnitudes of its four log-stds), since a sum in
another order, or XLA's exp and tanh in place of torch's, move a row by
ulps of those parts; a row can be 1e-2 of them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity_utils import (assert_kl_close,  # noqa: E402
                                assert_vars_close, kl_lanes_replay, kl_scale,
                                port_params, port_tuner, raw_head, volume)
from qbold_vi_tpu.config import ModelConfig, ScanParams  # noqa: E402
from qbold_vi_tpu.dist.logit_mvn import LogitMVN as JLogitMVN  # noqa: E402
from qbold_vi_tpu.ops import pallas_infer as jpi  # noqa: E402
from qbold_vi_tpu.ops import pallas_summarize as jps  # noqa: E402
from qbold_vi_tpu_torch import infer as tinfer  # noqa: E402
from qbold_vi_tpu_torch.ops import fused_infer as tfi  # noqa: E402
from qbold_vi_tpu_torch.ops import summarize as tsm  # noqa: E402

SCAN = ScanParams(simulate_noise=False)
MEAN_TOL = dict(rtol=1e-4, atol=3e-5)
VAR_TOL = dict(rtol=1e-3, atol=3e-5)
KL_TOL = dict(rtol=1e-5, atol=1e-5)
Q_TOL = dict(rtol=1e-5, atol=2e-5)
DW = float(SCAN.dw_coeff * SCAN.hct)
RANGES = dict(oef_range=0.8, min_oef=0.04, dbv_range=0.2, min_dbv=0.001,
              dw_coeff=DW)
# the interpreter's every Box-Muller draw
R_INTERP = float(np.sqrt(np.float32(-2.0) * np.log(np.float32(1e-12))))


def _interp_normals(draws: int, n: int) -> torch.Tensor:
    z = np.zeros((draws, n, 2), np.float32)
    z[..., 0] = R_INTERP
    return torch.from_numpy(z)


def _key_normals(key, draws: int, shape: tuple) -> torch.Tensor:
    """The normals of ``jax.random.split(key, draws)``, one draw each, as
    the JAX estimators draw them."""
    keys = jax.random.split(key, draws)
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(
        keys[s], shape + (2,), jnp.float32)) for s in range(draws)]))


def _close(got, ref):
    got, ref = [np.asarray(a) for a in got], [np.asarray(a) for a in ref]
    np.testing.assert_allclose(got[0], ref[0], err_msg="means", **MEAN_TOL)
    assert_vars_close(got[1], ref[1], ref[0], **VAR_TOL)


def _seed_free(fn, *args, **kw):
    """The JAX kernel's output at seed 5, after asserting the premise that
    another seed gives the same (the seed is traced: no second compile)."""
    a, b = fn(*args, 5, **kw), fn(*args, 99, **kw)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    return a


# (a) the plain estimator against the JAX kernel D; S = 1 and odd S fall
# back to iid draws; 105 voxels are a ragged count of (8, 8) tiles
@pytest.mark.parametrize("mvg,antithetic,s,n", [
    (True, True, 8, 105), (True, False, 3, 105), (False, True, 1, 64),
    (False, False, 3, 105), (False, True, 8, 64)])
def test_summaries_match_jax_kernel(mvg, antithetic, s, n):
    k = 5 if mvg else 4
    q = raw_head(np.random.default_rng(1), n, k)
    ref = _seed_free(jps.mc_posterior_summaries, jnp.asarray(q),
                     no_samples=s, mvg=mvg, interpret=True, lanes=8,
                     antithetic=antithetic, **RANGES)
    got = tsm.mc_posterior_summaries(
        torch.from_numpy(q), z=_interp_normals(tsm.mc_draws(s, antithetic),
                                               n),
        no_samples=s, mvg=mvg, antithetic=antithetic, **RANGES)
    _close(got, ref)


# (b) the iid estimator against the JAX jnp estimator with its own draws
@pytest.mark.parametrize("mvg", [True, False])
def test_iid_summaries_match_jax_streamed(mvg):
    n, s, k = 97, 16, 5 if mvg else 4
    q = raw_head(np.random.default_rng(2), n, k)
    key = jax.random.PRNGKey(7)
    ref = JLogitMVN().posterior_means_streamed(
        key, jnp.asarray(q), mvg, no_samples=s,
        r2p_fn=lambda oef, dbv: DW * oef * dbv)
    got = tsm.mc_posterior_summaries_plain(
        torch.from_numpy(q), _key_normals(key, s, (n,)), no_samples=s,
        mvg=mvg, antithetic=False, **RANGES)
    _close(got, ref)


# (c) the packed entry is the (N, K) entry
@pytest.mark.parametrize("mvg", [True, False])
def test_packed_entry_equals_row_entry(mvg):
    n, k = 77, 5 if mvg else 4
    q = torch.from_numpy(raw_head(np.random.default_rng(3), n, k))
    q_t = torch.cat([q.T, q.new_zeros((5 - k, n))]).contiguous()
    kw = dict(no_samples=10, mvg=mvg, offset=11, **RANGES)
    rows = tsm.mc_posterior_summaries(q, 4, **kw)
    packed = tsm.mc_posterior_summaries_packed(q_t, 4, **kw)
    for a, b in zip(rows, packed):
        assert torch.equal(a, b.T)


# (d) the sampled KL map against the JAX kernel E and jnp estimator
def test_kl_map_matches_jax():
    n, s = 105, 6
    rng = np.random.default_rng(4)
    q = raw_head(rng, n)
    p = (rng.normal(size=(n, 5)) * 0.7).astype(np.float32)
    ref = _seed_free(jps.mc_kl_map, jnp.asarray(q), jnp.asarray(p),
                     no_samples=s, interpret=True, lanes=8)
    got = tsm.mc_kl_map(torch.from_numpy(q), torch.from_numpy(p),
                        z=_interp_normals(s, n), no_samples=s)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **KL_TOL)
    key = jax.random.PRNGKey(8)
    ref = JLogitMVN().mvg_kl_samples(key, jnp.asarray(q), jnp.asarray(p),
                                     no_samples=s)
    got = tsm.mc_kl_map_plain(torch.from_numpy(q), torch.from_numpy(p),
                              _key_normals(key, s, (n,)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **KL_TOL)
    qt = torch.from_numpy(q)
    assert (tsm.mc_kl_map(qt, qt, 9, no_samples=s) == 0).all()


# (d') kernel E's lane order against the plain version and the JAX kernel E
# and jnp estimator; 105 voxels are a ragged count of (8, 8) tiles
@pytest.mark.parametrize("s", [2, 7, 100])
def test_kl_lane_order_matches_jax(s):
    n = 105
    rng = np.random.default_rng(40 + s)
    q = raw_head(rng, n)
    p = (rng.normal(size=(n, 5)) * 0.7).astype(np.float32)
    qt, pt = torch.from_numpy(q), torch.from_numpy(p)
    z = torch.from_numpy(rng.normal(size=(s, n, 2)).astype(np.float32))
    plain = tsm.mc_kl_map_plain(qt, pt, z)
    for lanes in (1, 2, 4, 8):
        assert_kl_close(kl_lanes_replay(qt, pt, z, lanes), plain,
                        kl_scale(qt, pt, z), **KL_TOL)
    ref = _seed_free(jps.mc_kl_map, jnp.asarray(q), jnp.asarray(p),
                     no_samples=s, interpret=True, lanes=8)
    z = _interp_normals(s, n)
    assert_kl_close(kl_lanes_replay(qt, pt, z, tsm.KL_LANES), ref,
                    kl_scale(qt, pt, z), **KL_TOL)
    key = jax.random.PRNGKey(s)
    ref = JLogitMVN().mvg_kl_samples(key, jnp.asarray(q), jnp.asarray(p),
                                     no_samples=s)
    z = _key_normals(key, s, (n,))
    assert_kl_close(kl_lanes_replay(qt, pt, z, tsm.KL_LANES), ref,
                    kl_scale(qt, pt, z), **KL_TOL)


# (e) the plain stream-1 encode against the JAX kernel C
@pytest.mark.parametrize("layout,mvg", [("voxel", True), ("channel", False)])
def test_encode_matches_jax_kernel(layout, mvg):
    cfg = ModelConfig(use_mvg=mvg, no_units=16, no_intermediate_layers=2,
                      multi_image_normalisation=not mvg,
                      compute_dtype="float32")
    rng = np.random.default_rng(5)
    shape = (1, 7, 5, 3)
    x = np.concatenate([volume(rng, shape, SCAN.n_taus),
                        (rng.uniform(size=shape + (1,)) > 0.3
                         ).astype(np.float32)], -1)
    n = int(np.prod(shape))
    if layout == "channel":
        x = np.ascontiguousarray(x.reshape(n, -1).T)
    _, params = port_params(cfg, SCAN, seed=2)
    kw = dict(se_idx=SCAN.se_idx, multi_image=cfg.multi_image_normalisation,
              activation=cfg.activation,
              n_blocks=cfg.no_intermediate_layers, trunk="float32",
              mask_channel=True, input_layout=layout)
    ref = jpi.encode_q1_packed(jnp.asarray(x), params["encoder"], rows=64,
                               interpret=True, **kw)
    tuner = port_tuner(cfg, SCAN, params)
    got = tfi.encode_q1_packed(torch.from_numpy(x), tuner.encoder, **kw)
    assert got.shape == (5, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:, :n], **Q_TOL)
    if not mvg:
        assert (got[4] == 0).all()


# (f) the maps do not depend on the chunk; S < 1 raises
@pytest.mark.parametrize("use_first_op", [True, False],
                         ids=["stream1", "stream2"])
def test_mc_maps_do_not_depend_on_chunk(use_first_op):
    cfg = ModelConfig(use_mvg=True, no_units=16, compute_dtype="float32",
                      fused_infer="on")
    _, params = port_params(cfg, SCAN, seed=3)
    tuner = port_tuner(cfg, SCAN, params)
    rng = np.random.default_rng(6)
    data = volume(rng, (3, 7, 5, 3), SCAN.n_taus + 1)
    data[..., -1] = rng.uniform(size=data.shape[:-1]) > 0.3
    kw = dict(method="mc", seed=5, no_samples=10, use_first_op=use_first_op)
    a = tinfer.posterior_maps(tuner, data, chunk=1, **kw)
    b = tinfer.posterior_maps(tuner, data, chunk=2, **kw)
    c = tinfer.posterior_maps(tuner, data, chunk=2, **dict(kw, seed=6))

    def means(d):
        return np.concatenate([d["oef"], d["dbv"], d["r2p"]], -1)

    # the same draws at either chunk; the encoder's float32 rounding may
    # follow the batch shape, but the Monte-Carlo spread of another seed
    # lies far outside the tolerances
    _close((means(b), b["stds"]), (means(a), a["stds"]))
    with pytest.raises(AssertionError):
        _close((means(c), c["stds"]), (means(a), a["stds"]))
    with pytest.raises(ValueError, match="no_samples"):
        tinfer.posterior_maps(tuner, data, **dict(kw, no_samples=0))
    q = torch.zeros((4, 5))
    with pytest.raises(ValueError, match="no_samples"):
        tsm.mc_posterior_summaries(q, 1, no_samples=0)
    with pytest.raises(ValueError, match="no_samples"):
        tsm.mc_kl_map(q, q, 1, no_samples=0)
    with pytest.raises(ValueError, match="seed"):
        tsm.mc_posterior_summaries(q, no_samples=4)


# (g) device noise of D and E: one Philox4x32-10 block for two draw pairs,
# replayed on the host by mc_philox_normals; against an independent Philox
# written here with Python integers (its known answers are Random123's)
_M0, _M1, _W0, _W1, _MASK = (0xD2511F53, 0xCD9E8D57, 0x9E3779B9,
                             0xBB67AE85, 0xFFFFFFFF)


def _philox(c, k):
    c, (k0, k1) = list(c), k
    for _ in range(10):
        p0, p1 = _M0 * c[0], _M1 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & _MASK, (p0 >> 32) ^ c[3] ^ k1,
             p0 & _MASK]
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return c


def _normals(a, b):
    """Box-Muller on the top 24 bits of two words, in float64."""
    u1 = ((a >> 8) + 1) * 2.0 ** -24
    u2 = (b >> 8) * 2.0 ** -24
    r = np.sqrt(-2.0 * np.log(u1))
    return r * np.cos(2 * np.pi * u2), r * np.sin(2 * np.pi * u2)


def test_philox_reference_known_answers():
    assert _philox([0, 0, 0, 0], [0, 0]) == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert _philox([_MASK] * 4, [_MASK, _MASK]) == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]


@pytest.mark.parametrize("seed,offset,draws", [(7, 0, 4), (2**40 + 3, 5, 7),
                                               (123, 2**33, 1)])
def test_mc_philox_normals_replays_the_counters(seed, offset, draws):
    """Pairs 2k and 2k + 1 of voxel v: words (0, 1) and (2, 3) of the block
    with counter (v lo, v hi, k, 0) and key (seed lo, seed hi)."""
    n = 6
    z = tsm.mc_philox_normals(seed, n, draws, offset)
    assert z.shape == (draws, n, 2) and z.dtype == np.float32
    key = [seed & _MASK, (seed >> 32) & _MASK]
    for v in range(n):
        g = offset + v
        for d in range(draws):
            w = _philox([g & _MASK, g >> 32, d // 2, 0], key)
            ref = _normals(w[2 * (d % 2)], w[2 * (d % 2) + 1])
            np.testing.assert_allclose(z[d, v], ref, rtol=1e-5, atol=1e-6)


def test_mc_normals_cut_at_an_offset_draw_what_the_whole_does():
    whole = tsm.mc_philox_normals(11, 40, 8)
    np.testing.assert_array_equal(tsm.mc_philox_normals(11, 17, 8, 23),
                                  whole[:, 23:])
    # an odd count ends on the first pair of a block
    np.testing.assert_array_equal(tsm.mc_philox_normals(11, 40, 7),
                                  whole[:7])
    got = tsm.mc_normals(None, 11, 23, 17, 8, torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), whole[:, 23:])
    # the plain path of a seed: a request cut at a voxel offset summarises
    # what the whole one does
    rng = np.random.default_rng(3)
    q = torch.from_numpy(raw_head(rng, 40))
    kw = dict(no_samples=16, dw_coeff=DW)
    full = tsm.mc_posterior_summaries(q, 11, **kw)
    cut = [tsm.mc_posterior_summaries(q[:23], 11, **kw),
           tsm.mc_posterior_summaries(q[23:], 11, offset=23, **kw)]
    for i in range(2):
        torch.testing.assert_close(torch.cat([cut[0][i], cut[1][i]]),
                                   full[i], rtol=0, atol=0)
    kl = tsm.mc_kl_map(q, q.flip(0), 11, no_samples=5)
    kl_cut = torch.cat([tsm.mc_kl_map(q[:23], q.flip(0)[:23], 11,
                                      no_samples=5),
                        tsm.mc_kl_map(q[23:], q.flip(0)[23:], 11, offset=23,
                                      no_samples=5)])
    torch.testing.assert_close(kl_cut, kl, rtol=0, atol=0)
