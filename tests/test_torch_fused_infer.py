"""The port's fused stream-1 encode + quadrature (ops/fused_infer.py,
kernel B's plain version and wrapper) against the JAX package's Pallas
kernel, run by the Mosaic interpreter (the way the JAX package's own
CPU tests run it), with the same bridged weights and numpy inputs.

Tolerances: q and raw rtol 1e-5 / atol 2e-5 (the same float32 chain in
another summation order); means rtol 1e-4 / atol 3e-5; variances
rtol 1e-3 / atol 3e-5, since E[x^2] - E[x]^2 cancels -- for R2' at
dw ~ 300 with an absolute floor of 16 float32 ulps of its second moment
(torch_parity_utils.assert_vars_close).

The bf16 trunk (trunk="bfloat16") rounds where the JAX kernel's
``_encode_body`` rounds, so for relu, softplus and elu its q equals the
interpreted JAX kernel's to within BF16_ULPS bf16 ulps of q's largest
magnitude (the float32 sums of a layer in another order can move a
rounding by one ulp), and the summaries then follow at the float32
tolerances above. Under the Mosaic interpreter the JAX kernel's tanh,
logistic and leaky slope round in XLA's CPU lowering, not as jax.nn's
bf16 steps, so those activations are held at the JAX package's own bf16
gate, rtol 0.05 / atol 0.03 (tests/test_pallas_infer.py:217).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from torch_parity_utils import (assert_vars_close, bf16_ulp,  # noqa: E402
                                port_params, port_tuner, volume)
from qbold_vi_tpu.config import OPTIMAL, ModelConfig, ScanParams  # noqa: E402
from qbold_vi_tpu.infer import _encode_q  # noqa: E402
from qbold_vi_tpu.ops import pallas_infer as jpi  # noqa: E402
from qbold_vi_tpu_torch.models.encoder import (activation_fn,  # noqa: E402
                                               normalise_data)
from qbold_vi_tpu_torch.ops import _cuda  # noqa: E402
from qbold_vi_tpu_torch.ops import fused_infer as tfi  # noqa: E402

SCAN = ScanParams(simulate_noise=False)
BF16_ULPS = 4
Q_TOL = dict(rtol=1e-5, atol=2e-5)
MEAN_TOL = dict(rtol=1e-4, atol=3e-5)
VAR_TOL = dict(rtol=1e-3, atol=3e-5)


def _ranges(cfg, scan):
    return dict(mvg=cfg.use_mvg, oef_range=cfg.oef_range,
                min_oef=cfg.min_oef, dbv_range=cfg.dbv_range,
                min_dbv=cfg.min_dbv,
                dw_coeff=float(scan.dw_coeff * scan.hct))


def _enc_kw(cfg, scan):
    return dict(se_idx=scan.se_idx, multi_image=cfg.multi_image_normalisation,
                activation=cfg.activation,
                n_blocks=cfg.no_intermediate_layers, trunk="float32")


def _run(cfg, scan, vol_shape, seed, *, mask_channel, layout,
         trunk="float32"):
    """JAX's kernel (interpreted) and the port's wrapper on one input.
    Returns (jax (3, N) triple, port (3, N) triple, extras)."""
    rng = np.random.default_rng(seed)
    images = volume(rng, vol_shape, scan.n_taus)
    jt, params = port_params(cfg, scan, seed)
    x = images
    if mask_channel:
        mask = (rng.uniform(size=vol_shape + (1,)) > 0.3).astype(np.float32)
        x = np.concatenate([images, mask], -1)
    if layout == "channel":
        x = np.ascontiguousarray(x.reshape(-1, x.shape[-1]).T)
    n = int(np.prod(vol_shape))
    kw = dict(**_enc_kw(cfg, scan), **_ranges(cfg, scan),
              mask_channel=mask_channel, input_layout=layout)
    kw["trunk"] = trunk
    ref = jpi.encode_quad_fused(jnp.asarray(x), params["encoder"], rows=64,
                                interpret=True, **kw)
    ref = [np.asarray(a)[:, :n] for a in ref]
    tuner = port_tuner(cfg, scan, params)
    got = tfi.encode_quad_fused(torch.from_numpy(x), tuner.encoder, **kw)
    return ref, [a.numpy() for a in got], (jt, params, tuner, images)


SCAN24 = ScanParams(tau_start=-0.028, tau_end=0.065, tau_step=0.004,
                    simulate_noise=False)
SCAN_SE0 = ScanParams(tau_start=0.0, simulate_noise=False)
OPT = dataclasses.replace(OPTIMAL.model, compute_dtype="float32")


def _small(act, **kw):
    base = dict(use_mvg=True, activation=act, no_units=16,
                no_intermediate_layers=2, multi_image_normalisation=False,
                compute_dtype="float32")
    return ModelConfig(**{**base, **kw})


# One case per activation; the published OPTIMAL shape in both layouts;
# masks, ragged N (105 voxels over 64-row tiles), diagonal heads, the
# 24-tau protocol and the se_idx = 0 grid edge folded into the others.
CASES = [
    ("relu-optimal-channel", OPT, SCAN, "channel", True),
    ("relu-optimal-voxel", OPT, SCAN, "voxel", True),
    ("gelu-24tau", _small("gelu", multi_image_normalisation=True), SCAN24,
     "voxel", True),
    ("tanh-diag", _small("tanh", use_mvg=False), SCAN, "channel", False),
    ("sigmoid", _small("sigmoid"), SCAN, "voxel", False),
    ("softplus", _small("softplus", no_units=13), SCAN, "channel", True),
    ("elu-se0", _small("elu", multi_image_normalisation=True), SCAN_SE0,
     "channel", True),
    ("silu", _small("silu", no_intermediate_layers=1), SCAN, "voxel", True),
    ("swish", _small("swish"), SCAN, "voxel", False),
    ("leaky_relu", _small("leaky_relu", no_intermediate_layers=3), SCAN,
     "channel", False),
    ("relu6-diag", _small("relu6", use_mvg=False), SCAN, "voxel", True),
    ("linear", _small("linear"), SCAN, "channel", True),
]


def test_cases_cover_every_activation():
    assert ({c[1].activation for c in CASES} == set(tfi.SUPPORTED_ACTS))


@pytest.mark.parametrize("name,cfg,scan,layout,mask", CASES,
                         ids=[c[0] for c in CASES])
def test_matches_jax_kernel(name, cfg, scan, layout, mask):
    ref, got, (jt, params, tuner, images) = _run(
        cfg, scan, (1, 7, 5, 3), 1, mask_channel=mask, layout=layout)
    np.testing.assert_allclose(got[0], ref[0], err_msg="means", **MEAN_TOL)
    assert_vars_close(got[1].T, ref[1].T, ref[0].T, **VAR_TOL)
    np.testing.assert_allclose(got[2], ref[2], err_msg="raw", **Q_TOL)
    # the encode half alone: q against the flax encoder's stream 1
    q_ref, _ = _encode_q(jt, params, jnp.asarray(images))
    q = tfi.encode_q_plain(torch.from_numpy(images), tuner.encoder,
                           **_enc_kw(cfg, scan))
    k = q_ref.shape[-1]
    np.testing.assert_allclose(q.numpy()[:k].T,
                               np.asarray(q_ref).reshape(-1, k), **Q_TOL)
    if k == 4:
        assert (q.numpy()[4] == 0).all()


OPT16 = dataclasses.replace(OPTIMAL.model, compute_dtype="bfloat16")
BF16_CASES = [
    ("relu-optimal-channel", OPT16, SCAN, "channel", True),
    ("softplus-diag-voxel", _small("softplus", no_units=13, use_mvg=False,
                                   compute_dtype="bfloat16"), SCAN,
     "voxel", False),
    ("elu-se0", _small("elu", multi_image_normalisation=True,
                       compute_dtype="bfloat16"), SCAN_SE0, "channel", True),
]


@pytest.mark.parametrize("name,cfg,scan,layout,mask", BF16_CASES,
                         ids=[c[0] for c in BF16_CASES])
def test_bf16_trunk_matches_jax_kernel(name, cfg, scan, layout, mask):
    """Kernel B's plain version at trunk="bfloat16" against the JAX kernel
    at the same trunk (interpreted), and its encode half against JAX's
    kernel C (encode_q1_packed)."""
    ref, got, (jt, params, tuner, images) = _run(
        cfg, scan, (1, 7, 5, 3), 1, mask_channel=mask, layout=layout,
        trunk="bfloat16")
    np.testing.assert_allclose(got[0], ref[0], err_msg="means", **MEAN_TOL)
    assert_vars_close(got[1].T, ref[1].T, ref[0].T, **VAR_TOL)
    np.testing.assert_allclose(got[2], ref[2], err_msg="raw", **Q_TOL)
    x = images.reshape(-1, scan.n_taus)
    kw = dict(_enc_kw(cfg, scan), trunk="bfloat16")
    q_ref = np.asarray(jpi.encode_q1_packed(
        jnp.asarray(x), params["encoder"], rows=64, pad_multiple=64,
        interpret=True, **kw))[:, :x.shape[0]]
    q = tfi.encode_q_plain(torch.from_numpy(x), tuner.encoder, **kw).numpy()
    np.testing.assert_allclose(q, q_ref, rtol=0,
                               atol=BF16_ULPS * bf16_ulp(q_ref))
    # a bf16 trunk rounds: its q is not the float32 trunk's
    q32 = tfi.encode_q_plain(torch.from_numpy(x), tuner.encoder,
                             **dict(kw, trunk="float32")).numpy()
    assert np.abs(q32 - q).max() > 0


def test_bf16_trunk_other_activations_at_the_jax_gate():
    """gelu, tanh, sigmoid, silu (swish's function), leaky_relu and relu6
    at the JAX package's bf16 gate (rtol 0.05 / atol 0.03), one
    interpreted JAX kernel C each: the interpreter's transcendental ops
    round elsewhere than jax.nn's bf16 steps (module docstring)."""
    rng = np.random.default_rng(4)
    x = volume(rng, (40,), SCAN.n_taus)
    for act in ("gelu", "tanh", "sigmoid", "silu", "leaky_relu", "relu6"):
        cfg = _small(act, compute_dtype="bfloat16")
        _, params = port_params(cfg, SCAN, 2)
        tuner = port_tuner(cfg, SCAN, params)
        kw = dict(_enc_kw(cfg, SCAN), trunk="bfloat16")
        q_ref = np.asarray(jpi.encode_q1_packed(
            jnp.asarray(x), params["encoder"], rows=64, pad_multiple=64,
            interpret=True, **kw))[:, :x.shape[0]]
        q = tfi.encode_q_plain(torch.from_numpy(x), tuner.encoder, **kw)
        np.testing.assert_allclose(q.numpy(), q_ref, rtol=0.05, atol=0.03,
                                   err_msg=act)


def test_masked_voxels_are_neutral():
    """A masked voxel clips to 1e-2 everywhere: log-ratio 0, so its
    summaries are those of the all-zero normalised input."""
    cfg = ModelConfig(use_mvg=True, no_units=8, compute_dtype="float32")
    scan = SCAN
    rng = np.random.default_rng(6)
    images = volume(rng, (1, 4, 4, 1), scan.n_taus)
    _, params = port_params(cfg, scan)
    tuner = port_tuner(cfg, scan, params)
    x = np.concatenate([images, np.zeros(images.shape[:-1] + (1,),
                                         np.float32)], -1)
    kw = dict(**_enc_kw(cfg, scan), **_ranges(cfg, scan))
    m, _, _ = tfi.encode_quad_fused(torch.from_numpy(x), tuner.encoder,
                                    mask_channel=True, **kw)
    m0, _, _ = tfi.encode_quad_fused(
        torch.ones((1, scan.n_taus)), tuner.encoder, **kw)
    torch.testing.assert_close(m, m0.expand_as(m), rtol=0, atol=0)


def test_wrapper_rejects_what_it_does_not_take():
    cfg = ModelConfig(use_mvg=True, no_units=8, compute_dtype="float32")
    _, params = port_params(cfg, SCAN)
    enc = port_tuner(cfg, SCAN, params).encoder
    kw = dict(**_enc_kw(cfg, SCAN), **_ranges(cfg, SCAN))
    x = torch.ones((10, SCAN.n_taus))
    with pytest.raises(ValueError, match="trunk"):
        tfi.encode_quad_fused(x, enc, **dict(kw, trunk="float16"))
    with pytest.raises(ValueError, match="input_layout"):
        tfi.encode_quad_fused(x, enc, input_layout="rows", **kw)
    with pytest.raises(ValueError, match="tau channels"):
        tfi.encode_quad_fused(torch.ones((10, 5)), enc, **kw)
    before = tfi.encode_quad_fused.launches
    tfi.encode_quad_fused(x, enc, **kw)
    assert tfi.encode_quad_fused.launches == before    # plain on the CPU


# ---- the kernel's weight blob and its fragment-order chain -------------------
# Kernels B and C (csrc/encode_quad.cu) run the chain as 3xTF32 mma.sync
# m16n8k8 products on weights packed by _weight_blob: hi / lo TF32 splits in
# fragment order, widths zero-padded, with a layer's sums handed to the next
# layer's A fragment in place. These tests unpack the blob and replay that
# data flow lane by lane in torch (float64 products of the TF32 splits).

def _lane_maps():
    """PTX fragment positions of mma.m16n8k8 (TF32), lane = 4 g + t:
    A a0..a3 at (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B b0, b1 at
    (t, g), (t + 4, g); C c0..c3 at (g, 2t), (g, 2t + 1), (g + 8, 2t),
    (g + 8, 2t + 1)."""
    g, t = torch.arange(32) // 4, torch.arange(32) % 4
    a = (torch.stack([g, g + 8, g, g + 8], 1), torch.stack([t, t, t + 4,
                                                             t + 4], 1))
    b = (torch.stack([t, t + 4], 1), torch.stack([g, g], 1))
    c = (torch.stack([g, g, g + 8, g + 8], 1),
         torch.stack([2 * t, 2 * t + 1, 2 * t, 2 * t + 1], 1))
    return a, b, c


def _mma(af, bf):
    """D fragments (tiles, 32, 4) = A (tiles, 32, 4) x B (32, 2), float64."""
    (ar, ac), (br, bc), (cr, cc) = _lane_maps()
    am = torch.zeros(af.shape[0], 16, 8, dtype=torch.float64)
    am[:, ar, ac] = af.double()
    bm = torch.zeros(8, 8, dtype=torch.float64)
    bm[br, bc] = bf.double()
    return (am @ bm)[:, cr, cc]


def _blob_parts(blob, t, up, nb):
    """(W0, [Wb], Wf) fragment arrays [k-step][n-tile][lane][4] and the
    padded biases, in csrc/encode_quad.cu's blob order."""
    ks0, nt = -(-t // 8), up // 8
    sizes = ([ks0 * nt * 128] + [nt * nt * 128] * nb + [nt * 128, up]
             + [up] * nb + [8])
    parts = list(torch.split(blob[:sum(sizes)], sizes))
    w0 = parts[0].reshape(ks0, nt, 32, 4)
    wb = [w.reshape(nt, nt, 32, 4) for w in parts[1:1 + nb]]
    wf = parts[1 + nb].reshape(nt, 1, 32, 4)
    return w0, wb, wf, parts[2 + nb], parts[3 + nb:3 + 2 * nb], parts[-1]


def _chain_in_fragments(x, encoder, *, se_idx, multi_image, activation,
                        n_blocks):
    """The raw head q (5, N) by the kernel's data flow: rows of 16 voxels,
    A fragments of the normalised taus (k = 8s + 2t and + 1 in slots t and
    t + 4), then each layer's C fragments turned into the next A fragment
    as (c0, c2, c1, c3) after bias and activation."""
    act = activation_fn(activation)
    blob, u, up, t = tfi._weight_blob(encoder, n_blocks, x.device)
    w0, wb, wf, b0, bb, bf = _blob_parts(blob, t, up, n_blocks)
    h = normalise_data(x, se_idx, multi_image)          # (N, T)
    n = h.shape[0]
    rows = torch.zeros(-(-n // 16) * 16, 8 * w0.shape[0])
    rows[:n, :t] = h
    r16 = rows.reshape(-1, 16, rows.shape[1])
    lane = torch.arange(32)
    g, tt = lane // 4, lane % 4

    def layer(a, w):
        acc = [0.0] * w.shape[1]
        for s in range(w.shape[0]):
            hi = tfi._tf32(a[s].float())
            lo = tfi._tf32(a[s].float() - hi)
            for j in range(w.shape[1]):
                b = w[s, j]
                acc[j] = acc[j] + (_mma(lo, b[:, :2]) + _mma(hi, b[:, 2:])
                                   + _mma(hi, b[:, :2]))
        return acc

    def epilogue(acc, b):
        out = []
        for j, c in enumerate(acc):
            c = c.float()
            b0_, b1_ = b[8 * j + 2 * tt], b[8 * j + 2 * tt + 1]
            out.append(act(torch.stack([c[..., 0] + b0_, c[..., 2] + b0_,
                                        c[..., 1] + b1_, c[..., 3] + b1_],
                                       -1)))
        return out

    a = [torch.stack([r16[:, g, 8 * s + 2 * tt], r16[:, g + 8, 8 * s + 2 * tt],
                      r16[:, g, 8 * s + 2 * tt + 1],
                      r16[:, g + 8, 8 * s + 2 * tt + 1]], -1)
         for s in range(w0.shape[0])]
    a = epilogue(layer(a, w0), b0)
    for i in range(n_blocks):
        a = epilogue(layer(a, wb[i]), bb[i])
    c = layer(a, wf)[0].float()                          # (tiles, 32, 4)
    q = torch.zeros(r16.shape[0], 16, 8)
    q[:, g, 2 * tt] = c[..., 0] + bf[2 * tt]
    q[:, g, 2 * tt + 1] = c[..., 1] + bf[2 * tt + 1]
    q[:, g + 8, 2 * tt] = c[..., 2] + bf[2 * tt]
    q[:, g + 8, 2 * tt + 1] = c[..., 3] + bf[2 * tt + 1]
    return q.reshape(-1, 8)[:n, :5].T


def _width_tuner(units, activation="relu"):
    cfg = dataclasses.replace(OPT, no_units=units, activation=activation)
    _, params = port_params(cfg, SCAN, units)
    return cfg, port_tuner(cfg, SCAN, params)


@pytest.mark.parametrize("units", [13, 30, 60])
def test_weight_blob_unpacks_to_the_encoder(units):
    """Each layer's fragments hold hi = tf32(w) and lo = tf32(w - hi) of
    the encoder's weight at (n, k) = (8j + g, 8s + 2t [+ 1]), zeros past U
    and T; the biases follow, zero-padded, then the quadrature table."""
    cfg, tuner = _width_tuner(units)
    nb = cfg.no_intermediate_layers
    blob, u, up, t = tfi._weight_blob(tuner.encoder, nb, torch.device("cpu"))
    assert (u, up, t) == (units, {13: 16, 30: 32, 60: 64}[units], 11)
    w0, wb, wf, b0, bb, bf = _blob_parts(blob, t, up, nb)
    wfc, bfc, wbs, bbs, wft, bft = tfi._stream1_weights(tuner.encoder, nb)

    def unpack(frags, np_, kp):
        f = frags.reshape(kp // 8, np_ // 8, 8, 4, 2, 2)  # s j g t hl pair
        hi, lo = f.permute(4, 1, 2, 0, 3, 5).reshape(2, np_, kp)
        return hi, lo

    for frags, w in ([(w0, wfc)] + list(zip(wb, wbs)) + [(wf, wft)]):
        np_, kp = frags.shape[1] * 8, frags.shape[0] * 8
        hi, lo = unpack(frags, np_, kp)
        wp = torch.zeros((np_, kp))
        wp[:w.shape[0], :w.shape[1]] = w
        bits = hi.view(torch.int32)
        assert ((bits & 0x1FFF) == 0).all()              # 10 mantissa bits
        assert torch.equal(hi, tfi._tf32(wp))
        assert torch.equal(lo, tfi._tf32(wp - hi))
        assert (hi[w.shape[0]:] == 0).all() and (hi[:, w.shape[1]:] == 0).all()
        assert (lo[w.shape[0]:] == 0).all() and (lo[:, w.shape[1]:] == 0).all()
        # the dropped lo * lo: hi + lo within 2^-21 of w
        assert ((hi + lo - wp).abs() <= 2.0 ** -21 * wp.abs()).all()
    for got, ref in [(b0, bfc[:, 0])] + list(zip(bb, bbs[..., 0])) \
            + [(bf, bft[:, 0])]:
        assert torch.equal(got[:ref.numel()], ref)
        assert (got[ref.numel():] == 0).all()
    consts = _cuda.quad_consts(torch.device("cpu"))
    assert torch.equal(blob[-consts.numel():], consts)


@pytest.mark.parametrize("units", [13, 30, 60])
@pytest.mark.parametrize("activation", tfi.SUPPORTED_ACTS)
def test_fragment_chain_matches_plain(units, activation):
    """The chain replayed in the kernel's fragment order, padded channels
    and all (act(0) != 0 for sigmoid, softplus), equals encode_q_plain:
    rtol 1e-6, atol 2e-6 (the dropped lo * lo terms, ~2^-22 a product)."""
    cfg, tuner = _width_tuner(units, activation)
    rng = np.random.default_rng(units)
    x = torch.from_numpy(volume(rng, (37,), SCAN.n_taus))
    kw = dict(se_idx=SCAN.se_idx, multi_image=False, activation=activation,
              n_blocks=cfg.no_intermediate_layers)
    got = _chain_in_fragments(x, tuner.encoder, **kw)
    ref = tfi.encode_q_plain(x, tuner.encoder, trunk="float32", **kw)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                               atol=2e-6)


# ---- the bf16 trunk's fragments (m16n8k16) ---------------------------------

def _lane_maps16():
    """PTX fragment positions of mma.m16n8k16 (bf16), lane = 4 g + t, a
    register's two bf16 the lower k first: A a0..a7 at (g, 2t), (g, 2t + 1),
    (g + 8, 2t), (g + 8, 2t + 1), then the same at k + 8; B b0..b3 at
    (2t, g), (2t + 1, g), (2t + 8, g), (2t + 9, g); C as m16n8k8's."""
    g, t = torch.arange(32) // 4, torch.arange(32) % 4
    k = torch.stack([2 * t, 2 * t + 1], 1)
    ar = torch.stack([g, g, g + 8, g + 8, g, g, g + 8, g + 8], 1)
    ac = torch.cat([k, k, k + 8, k + 8], 1)
    b = (torch.cat([k, k + 8], 1), torch.stack([g] * 4, 1))
    return (ar, ac), b, _lane_maps()[2]


def _mma16(af, bf):
    """D fragments (tiles, 32, 4) = A (tiles, 32, 8) x B (32, 4), float64
    (bf16 products are exact)."""
    (ar, ac), (br, bc), (cr, cc) = _lane_maps16()
    am = torch.zeros(af.shape[0], 16, 16, dtype=torch.float64)
    am[:, ar, ac] = af.double()
    bm = torch.zeros(16, 8, dtype=torch.float64)
    bm[br, bc] = bf.double()
    return (am @ bm)[:, cr, cc]


def _blob_parts_bf16(blob, t, up, nb):
    """The bf16 blob's (W0, [Wb]) bf16 fragments [k-step][n-tile][lane][4],
    the 3xTF32 head's Wf and the biases."""
    ks0, nt = -(-t // 16), up // 8
    sizes = ([ks0 * nt * 64] + [up // 16 * nt * 64] * nb + [nt * 128, up]
             + [up] * nb + [8])
    parts = list(torch.split(blob[:sum(sizes)], sizes))
    w0 = parts[0].view(torch.bfloat16).reshape(ks0, nt, 32, 4)
    wb = [w.view(torch.bfloat16).reshape(up // 16, nt, 32, 4)
          for w in parts[1:1 + nb]]
    wf = parts[1 + nb].reshape(nt, 1, 32, 4)
    return w0, wb, wf, parts[2 + nb], parts[3 + nb:3 + 2 * nb], parts[-1]


def _chain_in_fragments_bf16(x, encoder, *, se_idx, multi_image, activation,
                             n_blocks):
    """The raw head q (5, N) by the bf16 kernel's data flow: A fragments of
    the normalised taus rounded to bf16; each layer's sums rounded to bf16,
    the bf16 bias added and the activation taken in bf16, and the C
    fragments of n-tiles 2s, 2s + 1 packed into the next layer's A fragment
    of k-step s; the float32 head by 3xTF32 on those bf16 activations."""
    dt = torch.bfloat16
    act = activation_fn(activation, dt)
    blob, u, up, t = tfi._weight_blob(encoder, n_blocks, x.device,
                                      "bfloat16")
    w0, wb, wf, b0, bb, bf = _blob_parts_bf16(blob, t, up, n_blocks)
    h = normalise_data(x, se_idx, multi_image)
    n = h.shape[0]
    rows = torch.zeros(-(-n // 16) * 16, 16 * w0.shape[0])
    rows[:n, :t] = h
    r16 = rows.to(dt).reshape(-1, 16, rows.shape[1])
    lane = torch.arange(32)
    g, tt = lane // 4, lane % 4

    def layer16(a, w):
        acc = [0.0] * w.shape[1]
        for s in range(w.shape[0]):
            for j in range(w.shape[1]):
                acc[j] = acc[j] + _mma16(a[s], w[s, j])
        return acc

    def epilogue(acc, b):
        out = []
        for j, c in enumerate(acc):
            c = c.float().to(dt)
            b0_, b1_ = (b[8 * j + 2 * tt].to(dt),
                        b[8 * j + 2 * tt + 1].to(dt))
            out.append(act(torch.stack([c[..., 0] + b0_, c[..., 2] + b0_,
                                        c[..., 1] + b1_, c[..., 3] + b1_],
                                       -1)))
        return out

    def a_of(a):
        return [torch.cat([a[2 * s][..., [0, 2, 1, 3]],
                           a[2 * s + 1][..., [0, 2, 1, 3]]], -1)
                for s in range(len(a) // 2)]

    k = torch.stack([2 * tt, 2 * tt + 1], 1)
    a = [torch.cat([r16[:, g[:, None], 16 * s + k],
                    r16[:, g[:, None] + 8, 16 * s + k],
                    r16[:, g[:, None], 16 * s + 8 + k],
                    r16[:, g[:, None] + 8, 16 * s + 8 + k]], -1)
         for s in range(w0.shape[0])]
    a = epilogue(layer16(a, w0), b0)
    for i in range(n_blocks):
        a = epilogue(layer16(a_of(a), wb[i]), bb[i])
    acc = 0.0
    for s in range(wf.shape[0]):     # the head: a bf16 value is its own hi
        acc = acc + _mma(a[s].float(), wf[s, 0, :, :2]) + _mma(
            a[s].float(), wf[s, 0, :, 2:])
    c = acc.float()
    q = torch.zeros(r16.shape[0], 16, 8)
    q[:, g, 2 * tt] = c[..., 0] + bf[2 * tt]
    q[:, g, 2 * tt + 1] = c[..., 1] + bf[2 * tt + 1]
    q[:, g + 8, 2 * tt] = c[..., 2] + bf[2 * tt]
    q[:, g + 8, 2 * tt + 1] = c[..., 3] + bf[2 * tt + 1]
    return q.reshape(-1, 8)[:n, :5].T


@pytest.mark.parametrize("units", [13, 60])
@pytest.mark.parametrize("activation", ["relu", "softplus", "gelu",
                                        "sigmoid"])
def test_bf16_fragment_chain_matches_plain(units, activation):
    """The bf16 blob holds bf16(w) at (n, k) = (8j + g, 16s + 2t [+ 1],
    + 8), zeros past U and T, and bf16 biases; the chain replayed in the
    bf16 kernel's fragment order equals encode_q_plain at trunk="bfloat16"
    to BF16_ULPS bf16 ulps of q's largest magnitude (a layer's float32 sums
    in another order can move a rounding by one ulp)."""
    cfg, tuner = _width_tuner(units, activation)
    nb = cfg.no_intermediate_layers
    blob, u, up, t = tfi._weight_blob(tuner.encoder, nb, torch.device("cpu"),
                                      "bfloat16")
    w0, wb, wf, b0, bb, bf = _blob_parts_bf16(blob, t, up, nb)
    wfc, bfc, wbs, bbs, _, bft = tfi._stream1_weights(tuner.encoder, nb)
    for frags, w in [(w0, wfc)] + list(zip(wb, wbs)):
        np_, kp = frags.shape[1] * 8, frags.shape[0] * 16
        f = frags.reshape(kp // 16, np_ // 8, 8, 4, 2, 2)  # s j g t half pair
        got = f.permute(1, 2, 0, 4, 3, 5).reshape(np_, kp)
        wp = torch.zeros((np_, kp), dtype=torch.bfloat16)
        wp[:w.shape[0], :w.shape[1]] = w.to(torch.bfloat16)
        assert torch.equal(got, wp)
    for got, ref in [(b0, bfc[:, 0])] + list(zip(bb, bbs[..., 0])):
        assert torch.equal(got[:ref.numel()],
                           ref.to(torch.bfloat16).float())
        assert (got[ref.numel():] == 0).all()
    assert torch.equal(bf[:bft.numel()], bft[:, 0])
    rng = np.random.default_rng(units)
    x = torch.from_numpy(volume(rng, (37,), SCAN.n_taus))
    kw = dict(se_idx=SCAN.se_idx, multi_image=False, activation=activation,
              n_blocks=nb)
    got = _chain_in_fragments_bf16(x, tuner.encoder, **kw)
    ref = tfi.encode_q_plain(x, tuner.encoder, trunk="bfloat16", **kw)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=BF16_ULPS * bf16_ulp(ref.numpy()))
