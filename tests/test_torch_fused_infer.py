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


# Widths and depths past the resident blob (65-128 units x 2 in float32)
# and past 128 units, where the card runs the wgmma, chunked wgmma, split
# wgmma, cluster wgmma or streamed kernels: the port's plain versions
# against the JAX
# kernel in the interpreter, relu and a smooth activation, both layouts,
# with the mask.
WIDE_CASES = [
    ("100x2-relu-channel", 100, 2, "relu", "float32", "channel"),
    ("256x2-gelu-voxel", 256, 2, "gelu", "float32", "voxel"),
    ("320x2-softplus-channel", 320, 2, "softplus", "float32", "channel"),
    ("448x1-softplus-channel", 448, 1, "softplus", "float32", "channel"),
    ("520x1-relu-voxel", 520, 1, "relu", "float32", "voxel"),
    ("896x1-relu-voxel", 896, 1, "relu", "float32", "voxel"),
    ("1344x1-softplus-channel", 1344, 1, "softplus", "float32", "channel"),
    ("100x2-softplus-voxel-bf16", 100, 2, "softplus", "bfloat16", "voxel"),
    ("256x2-relu-channel-bf16", 256, 2, "relu", "bfloat16", "channel"),
    ("520x1-softplus-channel-bf16", 520, 1, "softplus", "bfloat16",
     "channel"),
]


@pytest.mark.parametrize("name,units,nb,act,trunk,layout", WIDE_CASES,
                         ids=[c[0] for c in WIDE_CASES])
def test_wide_and_deep_match_jax_kernel(name, units, nb, act, trunk, layout):
    """Kernel C's plain version (encode_q_plain) against the JAX kernel C
    at Q_TOL in float32 and within BF16_ULPS bf16 ulps of q's largest
    magnitude in bf16 (test_bf16_trunk_matches_jax_kernel's gate), and
    kernel B's plain version against the JAX kernel B (interpreted): in
    float32 at test_matches_jax_kernel's tolerances; in bf16 at the JAX
    package's bf16 gate, rtol 0.05 / atol 0.03 -- at 256 units a feature
    whose float32 sum rounds to the other bf16 neighbour moves q by ~1e-4,
    inside q's ulp gate but past the float32 summaries' tolerance."""
    cfg = dataclasses.replace(
        OPT, no_units=units, no_intermediate_layers=nb, activation=act,
        compute_dtype=trunk)
    ref, got, (jt, params, tuner, images) = _run(
        cfg, SCAN, (1, 7, 5, 3), 2, mask_channel=True, layout=layout,
        trunk=trunk)
    if trunk == "float32":
        np.testing.assert_allclose(got[0], ref[0], err_msg="means",
                                   **MEAN_TOL)
        assert_vars_close(got[1].T, ref[1].T, ref[0].T, **VAR_TOL)
        np.testing.assert_allclose(got[2], ref[2], err_msg="raw", **Q_TOL)
    else:
        for name, g, r in zip(("means", "vars", "raw"), got, ref):
            np.testing.assert_allclose(g, r, rtol=0.05, atol=0.03,
                                       err_msg=name)
    x = images.reshape(-1, SCAN.n_taus)
    kw = dict(_enc_kw(cfg, SCAN), trunk=trunk)
    q_ref = np.asarray(jpi.encode_q1_packed(
        jnp.asarray(x), params["encoder"], rows=64, pad_multiple=64,
        interpret=True, **kw))[:, :x.shape[0]]
    q = tfi.encode_q_plain(torch.from_numpy(x), tuner.encoder, **kw).numpy()
    if trunk == "float32":
        np.testing.assert_allclose(q, q_ref, **Q_TOL)
    else:
        np.testing.assert_allclose(q, q_ref, rtol=0,
                                   atol=BF16_ULPS * bf16_ulp(q_ref))


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


def _width_tuner(units, activation="relu", scan=SCAN):
    cfg = dataclasses.replace(OPT, no_units=units, activation=activation)
    _, params = port_params(cfg, scan, units)
    return cfg, port_tuner(cfg, scan, params)


@pytest.mark.parametrize("units", [13, 30, 60, 256])
def test_weight_blob_unpacks_to_the_encoder(units):
    """Each layer's fragments hold hi = tf32(w) and lo = tf32(w - hi) of
    the encoder's weight at (n, k) = (8j + g, 8s + 2t [+ 1]), zeros past U
    and T; the biases follow, zero-padded, then the quadrature table."""
    cfg, tuner = _width_tuner(units)
    nb = cfg.no_intermediate_layers
    blob, u, up, t = tfi._weight_blob(tuner.encoder, nb, torch.device("cpu"))
    assert (u, up, t) == (units, {13: 16, 30: 32, 60: 64, 256: 256}[units],
                          11)
    assert blob.numel() == tfi._blob_floats(up, nb, t, "float32")
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


# ---- the bf16 trunk's wgmma data flow ---------------------------------------
# Kernels B and C at bf16 (csrc/encode_quad_bf16.cu) run each layer as
# wgmma.m64nUpk16 products: A, 64 voxels x 16 channels, from the registers of
# a warpgroup's 128 threads, B by descriptor from shared memory. The blob
# holds each layer as 8 x 8 core matrices (K-major: a k-step's two halves
# LBO = 128 B apart, 8-row groups SBO = 256 B apart), which the kernel
# stages into the 32-byte swizzle its descriptors read (qv_e16_swz32). A
# layer's sums become the next layer's A registers pair by pair after the
# packed epilogue. These tests unpack the blob by the core-matrix rule and
# by the staging's swizzle, and replay that data flow thread by thread in
# torch (float64 products of bf16 values, which are exact).

_LBO, _SBO = 64, 128        # the descriptors' offsets in bf16 elements


def _wg_maps(n):
    """Thread th = 32 w + 4 g + t of a warpgroup: (rows, columns) of its A
    registers for one k-step, (128, 4) each -- register r holds the pair at
    (row, col) and (row, col + 1): (g, 2t), (g + 8, 2t), (g, 2t + 8),
    (g + 8, 2t + 8), rows + 16 w -- and of its n / 2 sums, d[4j + 2hh + i]
    at (16 w + g + 8 hh, 8 j + 2 t + i)."""
    th = torch.arange(128)
    w, g, t = th // 32, th % 32 // 4, th % 4
    r0 = 16 * w + g
    a = (torch.stack([r0, r0 + 8, r0, r0 + 8], 1),
         torch.stack([2 * t, 2 * t, 2 * t + 8, 2 * t + 8], 1))
    m = torch.arange(n // 2)
    j, hh, i = m // 4, m % 4 // 2, m % 2
    d = (r0[:, None] + 8 * hh[None], 8 * j[None] + 2 * t[:, None] + i[None])
    return a, d


def _desc_tile(elems, start, n):
    """The 16 x n B operand (k, n) that a descriptor at bf16 element
    ``start`` of ``elems`` addresses: core matrix (n // 8, k // 8) at
    start + (n // 8) SBO + (k // 8) LBO, row n % 8 at 8 elements, column
    k % 8 at 1."""
    k = torch.arange(16)[:, None]
    nn = torch.arange(n)[None, :]
    idx = start + nn // 8 * _SBO + k // 8 * _LBO + nn % 8 * 8 + k % 8
    return elems[idx]


def _wgmma(a_regs, b):
    """D (tiles, 128, n / 2) = A x B, float64: A (64 x 16) assembled from
    a_regs (tiles, 128, 4, 2) at _wg_maps' positions, b (16, n)."""
    n = b.shape[1]
    (ar, ac), (dr, dc) = _wg_maps(n)
    am = torch.zeros(a_regs.shape[0], 64, 16, dtype=torch.float64)
    for p in range(2):
        am[:, ar, ac + p] = a_regs[..., p].double()
    return (am @ b.double())[:, dr, dc]


def _blob_parts_bf16(blob, t, up, nb):
    """The bf16 blob's tag, its images as flat bf16 element arrays (W0,
    [Wb], the head's three pieces), the bf16 biases and the float32 head
    bias, in csrc/encode_quad_bf16.cu's order."""
    ks0 = -(-t // 16)
    sizes = ([4, ks0 * up * 8] + [up * up // 2] * nb + [up * 4] * 3
             + [up // 2] * (1 + nb) + [8])
    parts = list(torch.split(blob[:sum(sizes)], sizes))
    imgs = [q.view(torch.bfloat16) for q in parts[1:5 + nb]]
    biases = [q.view(torch.bfloat16) for q in parts[5 + nb:6 + 2 * nb]]
    return (parts[0].view(torch.int32), imgs[0], imgs[1:1 + nb],
            imgs[1 + nb:], biases[0], biases[1:], parts[-1])


def _unpack_image(elems, kp, np_):
    """A layer's (np_, kp) bf16 weights as the descriptors of its kp / 16
    k-steps read them (k-step s at element s * np_ * 16)."""
    return torch.cat([_desc_tile(elems, s * np_ * 16, np_).T
                      for s in range(kp // 16)], 1)


def _swizzled(elems, n):
    """A blob image of n-row k-steps as the kernel stages it: 16-byte piece
    q (8 bf16) at qv_e16_swz32(q, n) -- row r of k-step s at bytes
    s * 32 n + 32 r, its half kh at 16 (kh ^ (r >> 2 & 1))."""
    q = torch.arange(elems.numel() // 8)
    s, rem = q // (2 * n), q % (2 * n)
    row, kh = rem // 16 * 8 + rem % 8, rem // 8 % 2
    dst = (s * n * 32 + row * 32 + (kh ^ (row >> 2 & 1)) * 16) // 2
    out = torch.empty_like(elems)
    out[(dst[:, None] + torch.arange(8)).reshape(-1)] = elems
    return out


def _swz32_tile(elems, start, n):
    """The 16 x n B operand (k, n) that a 32-byte-swizzled descriptor at
    bf16 element ``start`` addresses: row n at 16 n, half k // 8 at
    8 (k // 8 ^ (n >> 2 & 1)), column k % 8."""
    k = torch.arange(16)[:, None]
    nn = torch.arange(n)[None, :]
    return elems[start + nn * 16 + (k // 8 ^ (nn >> 2 & 1)) * 8 + k % 8]


def _chain_in_fragments_bf16(x, encoder, *, se_idx, multi_image, activation,
                             n_blocks):
    """The raw head q (5, N) by the bf16 kernel's data flow: tiles of 64
    voxels; A registers of the normalised taus rounded to bf16; each
    layer's wgmma sums (float32) rounded to bf16, the bf16 bias pair added
    in bf16 and the activation taken in bf16, the pairs becoming the next
    layer's A registers in order (pair 4s + r is register r of k-step s);
    the head as three bf16 pieces' products, w1's summed apart from w2's
    and w3's, q = (w1 sums + the rest) + bias in float32."""
    dt = torch.bfloat16
    act = activation_fn(activation, dt)
    blob, u, up, t = tfi._weight_blob(encoder, n_blocks, x.device,
                                      "bfloat16")
    tag, w0, wb, wf, b0, bb, bf = _blob_parts_bf16(blob, t, up, n_blocks)
    h = normalise_data(x, se_idx, multi_image)
    n = h.shape[0]
    ks0 = -(-t // 16)
    rows = torch.zeros(-(-n // 64) * 64, 16 * ks0)
    rows[:n, :t] = h
    r64 = rows.to(dt).reshape(-1, 64, rows.shape[1])
    (ar, ac), _ = _wg_maps(up)
    tt = torch.arange(128) % 4

    def layer(a_steps, elems, n_out):
        acc = 0.0
        for s, a in enumerate(a_steps):
            acc = acc + _wgmma(a, _desc_tile(elems, s * n_out * 16, n_out))
        return acc.float()

    def epilogue(acc, b):
        pairs = acc.reshape(acc.shape[0], 128, -1, 2).to(dt)
        p = torch.arange(pairs.shape[2])
        ch = 8 * (p[None, :] // 2) + 2 * tt[:, None]          # (128, pairs)
        bias = torch.stack([b[ch], b[ch + 1]], -1)
        return act(pairs + bias)                # (tiles, 128, P, 2)

    def a_steps_of(pairs):
        return [pairs[:, :, 4 * s:4 * s + 4]
                for s in range(pairs.shape[2] // 4)]

    a0 = [torch.stack([r64[:, ar, 16 * s + ac], r64[:, ar, 16 * s + ac + 1]],
                      -1) for s in range(ks0)]
    a = epilogue(layer(a0, w0, up), b0)
    for i in range(n_blocks):
        a = epilogue(layer(a_steps_of(a), wb[i], up), bb[i])
    steps = a_steps_of(a)
    h1 = layer(steps, wf[0], 8)
    h23 = (sum(_wgmma(a_s, _desc_tile(wf[2], s * 128, 8))
               for s, a_s in enumerate(steps))
           + sum(_wgmma(a_s, _desc_tile(wf[1], s * 128, 8))
                 for s, a_s in enumerate(steps))).float()
    _, (dr, dc) = _wg_maps(8)
    q = torch.zeros(r64.shape[0], 64, 8)
    q[:, dr, dc] = (h1 + h23) + bf[dc]
    return q.reshape(-1, 8)[:n, :5].T


@pytest.mark.parametrize("units", [13, 30, 60, 128, 256])
def test_bf16_weight_blob_unpacks_to_the_encoder(units):
    """The bf16 blob starts with its layout tag; each layer's image, read
    as the kernel's descriptors address it, holds bf16(w) at (n, k), zeros
    past U and T; the head's three pieces sum exactly to the float32 head;
    the biases follow in bf16, the head's in float32, then the quadrature
    table."""
    cfg, tuner = _width_tuner(units)
    nb = cfg.no_intermediate_layers
    blob, u, up, t = tfi._weight_blob(tuner.encoder, nb, torch.device("cpu"),
                                      "bfloat16")
    assert (u, up, t) == (units, tfi._padded_width(units), 11)
    assert blob.numel() == tfi._blob_floats(up, nb, t, "bfloat16")
    tag, w0, wb, wf, b0, bb, bf = _blob_parts_bf16(blob, t, up, nb)
    assert tuple(tag.tolist()) == tfi._BF16_TAG
    wfc, bfc, wbs, bbs, wft, bft = tfi._stream1_weights(tuner.encoder, nb)
    for elems, w, kp, np_ in ([(w0, wfc, 16, up)]
                              + [(e, w, up, up) for e, w in zip(wb, wbs)]):
        wp = torch.zeros((np_, kp), dtype=torch.bfloat16)
        wp[:w.shape[0], :w.shape[1]] = w.to(torch.bfloat16)
        assert torch.equal(_unpack_image(elems, kp, np_), wp)
    head = sum(_unpack_image(e, up, 8).double() for e in wf)
    wp = torch.zeros((8, up), dtype=torch.float64)
    wp[:5, :units] = wft.double()
    assert torch.equal(head, wp)
    # the staged, swizzled images hold the same weights at the addresses
    # the kernel's 32-byte-swizzle descriptors read
    for elems, kp, np_ in ([(w0, 16, up)] + [(e, up, up) for e in wb]
                           + [(e, up, 8) for e in wf]):
        sw = _swizzled(elems, np_)
        got = torch.cat([_swz32_tile(sw, s * np_ * 16, np_).T
                         for s in range(kp // 16)], 1)
        assert torch.equal(got, _unpack_image(elems, kp, np_))
    for got, ref in [(b0, bfc[:, 0])] + list(zip(bb, bbs[..., 0])):
        assert torch.equal(got[:ref.numel()], ref.to(torch.bfloat16))
        assert (got[ref.numel():] == 0).all()
    assert torch.equal(bf[:bft.numel()], bft[:, 0])
    consts = _cuda.quad_consts(torch.device("cpu"))
    assert torch.equal(blob[-consts.numel():], consts)
    assert (blob.numel() - 4) % 4 == 0          # 16-byte shared staging


@pytest.mark.parametrize("units", [13, 30, 60, 128])
@pytest.mark.parametrize("activation", ["relu", "softplus", "gelu",
                                        "sigmoid"])
def test_bf16_fragment_chain_matches_plain(units, activation):
    """The chain replayed in the bf16 kernel's wgmma data flow (registers,
    descriptors, the packed epilogue, the three-piece head) equals
    encode_q_plain at trunk="bfloat16" to BF16_ULPS bf16 ulps of q's
    largest magnitude (a layer's float32 sums in another order can move a
    rounding by one ulp)."""
    cfg, tuner = _width_tuner(units, activation)
    nb = cfg.no_intermediate_layers
    rng = np.random.default_rng(units)
    x = torch.from_numpy(volume(rng, (37,), SCAN.n_taus))
    kw = dict(se_idx=SCAN.se_idx, multi_image=False, activation=activation,
              n_blocks=nb)
    got = _chain_in_fragments_bf16(x, tuner.encoder, **kw)
    ref = tfi.encode_q_plain(x, tuner.encoder, trunk="bfloat16", **kw)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=BF16_ULPS * bf16_ulp(ref.numpy()))


def _bf16_rne(v):
    """float64 v rounded once to bf16 (8 significant bits, ties to even),
    as float64: the add.rn.bf16x2 of the kernel's epilogue on the exact
    sum (a float64 sum of two bf16 values is exact up to exponent gaps of
    45 bits, and beyond them no tie can be reached)."""
    m, e = np.frexp(v)
    return np.ldexp(np.rint(m * 256.0), e - 8)


def _as_bf16(v):
    return torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)


def test_bf16_packed_epilogue_is_the_per_element_chain():
    """The kernel's packed epilogue -- cvt.rn.bf16x2 of the float32 sums,
    add.rn.bf16x2 of the bf16 bias (one rounding of the exact sum), max
    with 0 -- equals the plain chain relu(bf16(float32(bf16(acc) + b)))
    bit for bit: on random values, on sums at a tie between two bf16
    values, and across exponent gaps of 0-60 bits."""
    rng = np.random.default_rng(17)
    n = 20_000
    acc = (rng.normal(size=n) * 2.0 ** rng.uniform(-30, 30, n)).astype(
        np.float32)
    b = _as_bf16(rng.normal(size=n) * 2.0 ** rng.uniform(-30, 30, n))
    # ties: x in [1, 2) with 8 significant bits, b half an ulp of x
    x_tie = 1.0 + rng.integers(0, 128, 4_000) / 128.0
    sign = rng.choice([-1.0, 1.0], 4_000)
    scale = 2.0 ** rng.integers(-20, 20, 4_000)
    acc_tie = (x_tie * sign * scale).astype(np.float32)
    b_tie = _as_bf16(sign * scale * 2.0 ** -8
                     * rng.choice([1.0, 3.0, -1.0], 4_000))
    # wide exponent gaps
    gap = rng.integers(0, 61, 4_000)
    acc_gap = rng.normal(size=4_000).astype(np.float32)
    b_gap = _as_bf16(rng.normal(size=4_000) * 2.0 ** -gap.astype(float))
    acc = np.concatenate([acc, acc_tie, acc_gap])
    b = torch.cat([b, b_tie, b_gap])
    a16 = torch.from_numpy(acc).to(torch.bfloat16)
    chain = torch.relu((a16.float() + b.float()).to(torch.bfloat16))
    packed = np.maximum(_bf16_rne(a16.double().numpy() + b.double().numpy()),
                        0.0)
    assert torch.equal(chain.double(), torch.from_numpy(packed))
    # the ties did land on ties, and some rounded down, some up
    exact = a16.double()[-8_000:-4_000] + b.double()[-8_000:-4_000]
    assert not torch.equal(exact, exact.to(torch.bfloat16).double())


def test_bf16_head_pieces_sum_to_the_float32_weights():
    """_bf16_pieces cuts float32 weights into three bf16 tensors whose sum
    is the weight exactly: random weights, tiny, huge and negative ones,
    and float32's largest; no piece overflows."""
    rng = np.random.default_rng(5)
    big = float(np.finfo(np.float32).max)
    w = np.concatenate([rng.normal(size=500) * 0.3,
                        rng.normal(size=200) * 2.0 ** rng.uniform(-100, 120,
                                                                  200),
                        [1e-30, -2.5e-30, 7e-31, 3.3e38, -3.4e38, big, -big,
                         1.0, -1.0, 0.0, 2.0 ** -100, 1.0 + 2.0 ** -23]])
    w = torch.from_numpy(w.astype(np.float32)).reshape(2, -1)
    pieces = tfi._bf16_pieces(w)
    assert all(p.dtype == torch.bfloat16 and torch.isfinite(p).all()
               for p in pieces)
    total = sum(p.double() for p in pieces)
    assert torch.equal(total, w.double())
    # w1 carries the top bits: the rest is under 2^-7 of |w|
    assert ((w.double() - pieces[0].double()).abs()
            <= 2.0 ** -7 * w.double().abs()).all()


def test_fused_op_refuses_a_bf16_blob_of_another_layout():
    """A bf16 blob carries _BF16_TAG: the op's check passes the blob
    _weight_blob makes (marked, no read) and an unmarked copy (by its
    tag), and refuses a blob without the tag -- as a fused bf16 .pt2
    exported before the wgmma encode holds -- asking for a new export; a
    float32 blob is not checked."""
    cfg, tuner = _width_tuner(60)
    nb = cfg.no_intermediate_layers
    blob, *_ = tfi._weight_blob(tuner.encoder, nb, torch.device("cpu"),
                                "bfloat16")
    tfi._check_blob_layout(blob, "bfloat16")
    copy = blob.clone()
    assert getattr(copy, "_qv_layout", None) is None
    tfi._check_blob_layout(copy, "bfloat16")
    assert copy._qv_layout == tfi._BF16_TAG
    old = blob[4:].clone()        # a blob of the earlier layout: no tag
    with pytest.raises(ValueError, match="exported again"):
        tfi._check_blob_layout(old, "bfloat16")
    with pytest.raises(ValueError, match="exported again"):
        tfi._check_blob_layout(torch.zeros(2), "bfloat16")
    f32, *_ = tfi._weight_blob(tuner.encoder, nb, torch.device("cpu"))
    tfi._check_blob_layout(f32, "float32")



# ---- the launch plan and the streamed kernels' slab walk --------------------

H100_SMEM = 232_448       # shared memory a block can take on the H100


@pytest.mark.parametrize("quad", [True, False], ids=["B", "C"])
@pytest.mark.parametrize("trunk", ["float32", "bfloat16"])
def test_launch_plan_takes_every_width_and_depth(trunk, quad):
    """launch_plan has a launch for every width and depth of the grid
    within the H100's shared memory, and keeps the resident design at
    OPTIMAL (60 units x 2 blocks). Where the resident blob does not fit
    (at 100 x 2 in float32 it is 72,280 floats; 60 x 7; past 128 units)
    the float32 trunk takes the wgmma design up to a padded width of 256,
    the chunked wgmma design at 320 and 384 (257-384 units, whose pass of
    128 voxels fits), the split wgmma design at 448-768 (385-768 units,
    where it does not) and the cluster wgmma design at 832-1472 (769-1472
    units: a cluster of blocks shares a pass of 128 voxels; past 1280 a
    block's columns in two output chunks), at any tau count
    (tests/test_torch_many_taus.py); the bf16 trunk (half the blob)
    streams past 128 units."""
    for units in (1, 13, 60, 64, 65, 100, 128, 129, 192, 200, 256, 257,
                  300, 320, 321, 384, 385, 448, 449, 520, 640, 700, 768,
                  769, 832, 833, 1024, 1200, 1280, 1281, 1350, 1408,
                  1472):
        up = tfi._padded_width(units)
        assert up >= units
        for nb in (1, 2, 3, 7, 12):
            plan = tfi.launch_plan(up, nb, 11, 12, trunk, quad, H100_SMEM)
            assert 0 < plan.smem <= H100_SMEM, (units, nb, plan)
            if plan.design == "resident":
                assert up in tfi._RESIDENT_WIDTHS
            elif trunk == "float32" and up <= 256:
                assert plan.design == "wgmma", (units, nb, plan)
                assert plan.threads == tfi._WG_THREADS == 384
                assert (plan.ks, plan.stages) == (tfi._WG_SLABS[up][0], 2)
                assert plan.smem == tfi._wg_smem(up, 11, quad, plan.stages,
                                                 plan.ks)
                assert tfi._ST_ROUND % tfi._WG_PASS == 0
            elif trunk == "float32" and up <= 384:
                assert plan.design == "chunked", (units, nb, plan)
                assert plan.threads == tfi._WG_THREADS
                assert (plan.cn, plan.ks) == tfi._WGC_SLABS[up]
                assert plan.stages == 2 and up % plan.cn == 0
                assert plan.cn % 8 == 0 and plan.cn <= 256
                assert plan.smem == tfi._wg_smem(up, 11, quad, plan.stages,
                                                 plan.ks, plan.cn)
            elif trunk == "float32" and 832 <= up <= 1472:
                assert plan.design == "cluster", (units, nb, plan)
                assert plan.threads == tfi._WG_THREADS
                # the width's first plan fits at 11 taus
                cluster, stages, seg, chunk = tfi._WGK_PLANS[up][0]
                assert (plan.cluster, plan.stages, plan.seg, plan.chunk) == (
                    cluster, stages, seg, chunk)
                assert plan.cn * plan.cluster == up and plan.ks == 1
                assert plan.cn in tfi._WGK_COLUMNS and plan.cn % 8 == 0
                assert 2 <= plan.cluster <= 8 and seg >= 1
                # past 160 columns a block: two output chunks, each a
                # wgmma width (a multiple of 8), whose segment's slabs
                # the ring holds at once
                assert (chunk > 0) == (plan.cn > 160)
                if chunk:
                    assert chunk % 8 == 0 and 0 < chunk < plan.cn
                    assert max(chunk, plan.cn - chunk) <= 120
                    assert seg <= plan.stages
                # the ring's slots: at most QV_WG_MAX_STAGES
                assert 2 <= plan.stages <= 8
                assert plan.smem == tfi._wgk_smem(up, 11, quad, plan.stages,
                                                  plan.cluster)
                assert (2 * plan.cluster * tfi._ST_ROUND) % tfi._WGK_PASS == 0
            elif trunk == "float32" and up <= 768:
                assert plan.design == "split", (units, nb, plan)
                assert plan.threads == tfi._WG_THREADS
                assert (plan.cn, plan.stages) == tfi._WGX_SLABS[up]
                assert plan.ks == 1 and plan.stages in tfi._WG_STAGES
                assert (up // 2) % plan.cn == 0 and plan.cn % 8 == 0
                assert plan.cn <= 256
                assert plan.smem == tfi._wgx_smem(up, 11, quad, plan.stages,
                                                  plan.cn)
                assert tfi._ST_ROUND % tfi._WGX_PASS == 0
            else:
                assert plan.design == "streamed", (units, nb, plan)
                assert (plan.mt, plan.ncw) in {
                    (mt, ncw) for ncw, mts in tfi._ST_TILES.items()
                    for mt in mts}
                assert plan.threads == 256 and plan.ks >= 1
                assert tfi._ST_ROUND % (16 * plan.mt) == 0
    opt = tfi.launch_plan(64, 2, 11, 12, trunk, quad, H100_SMEM)
    assert opt.design == "resident"
    assert opt.threads == (384 if trunk == "float32" else 256)
    designs = {shape: tfi.launch_plan(tfi._padded_width(shape[0]), shape[1],
                                      11, 12, trunk, quad, H100_SMEM).design
               for shape in ((100, 2), (128, 2), (60, 7), (192, 2),
                             (256, 2), (320, 2), (520, 1), (320, 1),
                             (320, 3), (384, 1), (384, 2), (384, 3),
                             (448, 1), (448, 2), (768, 1), (769, 1),
                             (832, 1), (833, 1), (1024, 2), (1280, 1),
                             (1281, 1), (1350, 1), (1472, 1))}
    if trunk == "float32":
        assert tfi._blob_floats(128, 2, 11, trunk) == 72_280
        assert designs == {(100, 2): "wgmma", (128, 2): "wgmma",
                           (60, 7): "wgmma", (192, 2): "wgmma",
                           (256, 2): "wgmma", (320, 2): "chunked",
                           (520, 1): "split", (320, 1): "chunked",
                           (320, 3): "chunked", (384, 1): "chunked",
                           (384, 2): "chunked", (384, 3): "chunked",
                           (448, 1): "split", (448, 2): "split",
                           (768, 1): "split", (769, 1): "cluster",
                           (832, 1): "cluster", (833, 1): "cluster",
                           (1024, 2): "cluster", (1280, 1): "cluster",
                           (1281, 1): "cluster", (1350, 1): "cluster",
                           (1472, 1): "cluster"}
        # at 256 x 2: two warpgroups' activation rows (132 KB) beside a
        # ring of two 16 KB slabs
        plan = tfi.launch_plan(256, 2, 11, 12, trunk, quad, H100_SMEM)
        assert (plan.ks, plan.stages) == (1, 2)
        assert tfi._WG_PASS * (256 + 8) * 4 == 135_168
        # at 320 x 2: 160-column chunks, the staged rows in the activation
        # rows (168 KB), two 10 KB slabs: below 196 KB; at 384 the
        # activation rows alone take 200,704 B
        plan = tfi.launch_plan(320, 2, 11, 12, trunk, quad, H100_SMEM)
        assert (plan.cn, plan.ks, plan.stages) == (160, 1, 2)
        assert plan.smem == (194_496 if quad else 193_664) < 196 * 1024
        assert tfi._WG_PASS * (384 + 8) * 4 == 200_704
        # a staged row of more taus than an activation row holds is staged
        # a window of k-steps at a time, in the same block
        plan = tfi.launch_plan(320, 2, 330, 331, trunk, quad, H100_SMEM)
        assert (plan.design, plan.rows) == ("chunked", "windowed")
        assert plan.smem == (194_496 if quad else 193_664)
        # at 448 a pass of 128 voxels does not fit (its activation rows
        # alone take 233,472 B); the split design's 64 voxels a pass take
        # 116,736 B of them beside two 28 KB slabs: below 196 KB
        assert 128 * (448 + 8) * 4 == 233_472 > H100_SMEM
        plan = tfi.launch_plan(448, 1, 11, 12, trunk, quad, H100_SMEM)
        assert (plan.cn, plan.stages) == (224, 2)
        assert tfi._WGX_PASS * (448 + 8) * 4 == 116_736
        assert plan.smem == (186_304 if quad else 185_472) < 196 * 1024
        # past the split block's reach (at 896 its activation rows alone
        # would take 231,424 B) a cluster of 8 blocks shares a pass of 128
        # voxels, each block the rows of its 112 columns (61,440 B), every
        # staged row, the partial heads of 8 blocks for a round
        assert tfi._WGX_PASS * (896 + 8) * 4 == 231_424
        plan = tfi.launch_plan(896, 1, 11, 12, trunk, quad, H100_SMEM)
        assert (plan.design, plan.cluster, plan.cn) == ("cluster", 8, 112)
        assert tfi._WGK_PASS * (112 + 8) * 4 == 61_440
        assert plan.smem == 256 + plan.stages * 64 * 112 + 4 * (
            128 * (120 + 24) + 8 * 5 * 256 + (tfi._NCONST if quad else 0))
        # at 1280 each block's 160 columns: 80 sums and 80 fragment
        # registers a thread
        plan = tfi.launch_plan(1280, 1, 11, 12, trunk, quad, H100_SMEM)
        assert (plan.design, plan.cn, plan.chunk) == ("cluster", 160, 0)
        # past it (1344-1472: 168-184 columns a block) the columns are two
        # output chunks: 84-92 sums a thread and one chunk's fragment of
        # at most 60 registers; the shared memory is the unchunked
        # layout's, 170-180 KB at 11 taus
        for up, smem in ((1344, 170_048), (1408, 171_072), (1472, 180_288)):
            plan = tfi.launch_plan(up, 1, 11, 12, trunk, quad, H100_SMEM)
            assert (plan.design, plan.cn) == ("cluster", up // 8)
            assert plan.chunk == tfi._WGK_PLANS[up][0][3] > 0
            assert plan.smem == tfi._wgk_smem(up, 11, quad, plan.stages, 8)
            assert plan.smem == smem - (0 if quad else 4 * tfi._NCONST) + (
                plan.stages - 2) * 64 * up // 8
        # where a width's first ring does not fit beside the staged rows
        # of more taus, its next one does: at 1472 on 40 taus the ring of
        # 6 slots takes 235,584 B, the ring of 4 212,032 B
        first, then = tfi._WGK_PLANS[1472]
        plan = tfi.launch_plan(1472, 1, 40, 41, trunk, True, H100_SMEM)
        assert tfi._wgk_smem(1472, 40, True, first[1], 8) == 235_584
        assert (plan.design, plan.stages, plan.seg, plan.chunk,
                plan.smem) == ("cluster", *then[1:], 212_032)
        # where the staged rows of many taus do not fit beside a block
        # they share its activation rows: at 448 x 1 on 330 taus and at
        # 768 x 1 on 48 or 51 taus the split block with shared rows; where
        # a staged row is wider than a block's activation row (896 x 1 on
        # 330 taus: 112 columns a block) they are staged there a window at
        # a time
        plan = tfi.launch_plan(896, 1, 330, 331, trunk, quad, H100_SMEM)
        assert (plan.design, plan.rows) == ("cluster", "windowed")
        plan = tfi.launch_plan(448, 1, 330, 331, trunk, quad, H100_SMEM)
        assert (plan.design, plan.rows) == ("split", "shared")
        for t in (48, 51):
            plan = tfi.launch_plan(768, 1, t, t + 1, trunk, quad, H100_SMEM)
            assert (plan.design, plan.rows) == ("split", "shared")
            assert plan.smem == tfi._wgx_smem(768, t, quad, 2, 64, True)
        # past 1472 no block of any design fits, nor any streamed one
        with pytest.raises(ValueError, match="no launch fits"):
            tfi.launch_plan(1536, 1, 11, 12, trunk, quad, H100_SMEM)
    else:
        assert designs == {(100, 2): "resident", (128, 2): "resident",
                           (60, 7): "resident", (192, 2): "streamed",
                           (256, 2): "streamed", (320, 2): "streamed",
                           (520, 1): "streamed", (320, 1): "streamed",
                           (320, 3): "streamed", (384, 1): "streamed",
                           (384, 2): "streamed", (384, 3): "streamed",
                           (448, 1): "streamed", (448, 2): "streamed",
                           (768, 1): "streamed", (769, 1): "streamed",
                           (832, 1): "streamed", (833, 1): "streamed",
                           (1024, 2): "streamed", (1280, 1): "streamed",
                           (1281, 1): "streamed", (1350, 1): "streamed",
                           (1472, 1): "streamed"}
    with pytest.raises(ValueError, match="no launch fits"):
        tfi.launch_plan(1024, 2, 11, 12, trunk, quad, 64 * 1024)


def _stream_walk(up, nb, t, trunk, plan):
    """The slabs a pass of csrc/encode_stream.cuh walks, in its order
    (qv_st_body's issue): (layer, first k-step, k-steps, first n-tile,
    n-tiles) -- the first layer's k-slabs chunk by chunk, then each
    block's."""
    k = tfi._k_step(trunk)
    nt, ks0, ksh, cn = up // 8, -(-t // k), up // k, 8 * plan.ncw
    nch = -(-nt // cn)
    for layer in range(nb + 1):
        kl = ks0 if layer == 0 else ksh
        for c in range(nch):
            for k0 in range(0, kl, plan.ks):
                yield (layer, k0, min(plan.ks, kl - k0), c * cn,
                       min(cn, nt - c * cn))


@pytest.mark.parametrize("trunk", ["bfloat16"])
def test_streamed_slabs_unpack_to_the_encoder(trunk):
    """At 256 units x 2 blocks in bf16 (the streamed design's shape: the
    float32 trunk takes the wgmma designs at every width and tau count),
    the streamed kernels' slabs -- the blob's bytes copied as qv_st_body
    copies them into a slot, then read as each warp reads its B fragments
    (lane 4g + t) -- hold every layer's weight at (n, k) exactly once:
    bf16 values, zeros past U and T. The head's fragments and the biases,
    read where qv_st_blob points, hold the head and the biases."""
    up = 256
    cfg, tuner = _width_tuner(up)
    nb = cfg.no_intermediate_layers
    blob, u, _, t = tfi._weight_blob(tuner.encoder, nb, torch.device("cpu"),
                                     trunk)
    plan = tfi.launch_plan(up, nb, t, t + 1, trunk, True, H100_SMEM)
    assert plan.design == "streamed"
    k, fb = 16, 256
    nt, ks0, cn = up // 8, -(-t // k), 8 * plan.ncw
    raw = blob.numpy().view(np.uint8)[16:]
    layer_off = [0] + [ks0 * nt * fb + i * (up // k) * nt * fb
                       for i in range(nb)]
    wfc, bfc, wbs, bbs, wft, bft = tfi._stream1_weights(tuner.encoder, nb)
    lane = np.arange(32)
    g, tt = lane // 4, lane % 4
    got = [np.full((2, up, k * (ks0 if i == 0 else up // k)), np.nan,
                   np.float32) for i in range(nb + 1)]
    for layer, k0, nk, j0, nj in _stream_walk(up, nb, t, trunk, plan):
        slot = np.zeros(plan.ks * cn * fb, np.uint8)
        for kk in range(nk):
            src = layer_off[layer] + ((k0 + kk) * nt + j0) * fb
            slot[kk * cn * fb:kk * cn * fb + nj * fb] = raw[src:src + nj * fb]
        for w in range(8):
            jw = j0 + w * plan.ncw
            if jw >= nt:
                continue
            for s_ in range(nk):
                for j in range(plan.ncw):
                    grp = slot[(s_ * cn + w * plan.ncw + j) * fb:][:fb]
                    n_ = (jw + j) * 8 + g
                    kb = (k0 + s_) * k
                    words = grp.view(np.uint32)
                    for half, word in enumerate((words[:32], words[32:])):
                        b = torch.from_numpy(word.view(np.int32).copy())
                        pairs = b.view(torch.bfloat16).float().numpy()
                        for pair in range(2):
                            col = kb + 8 * half + 2 * tt + pair
                            assert np.isnan(got[layer][0, n_, col]).all()
                            got[layer][0, n_, col] = pairs[pair::2]
    for layer, w in enumerate([wfc] + list(wbs)):
        wp = torch.zeros((up, got[layer].shape[2]))
        wp[:w.shape[0], :w.shape[1]] = w
        assert np.array_equal(got[layer][0],
                              wp.to(torch.bfloat16).float().numpy())
    # the head, read from global memory at qv_st_blob's wf, k-step by
    # k-step: three bf16 pieces
    wf_off = layer_off[-1] + (up // k) * nt * fb
    head = np.zeros((8, up))
    for piece in range(3):
        for ks in range(up // k):
            grp = raw[wf_off + piece * (up // k) * fb + ks * fb:][:fb]
            words = grp.view(np.uint32)
            for half, word in enumerate((words[:32], words[32:])):
                b = torch.from_numpy(word.view(np.int32).copy())
                pairs = b.view(torch.bfloat16).double().numpy()
                for pair in range(2):
                    head[g, ks * 16 + 8 * half + 2 * tt + pair] += \
                        pairs[pair::2]
    ref = np.zeros((8, up))
    ref[:5, :u] = wft.double().numpy()
    assert (head == ref).all()
    # the biases (layer l's at wf + head pieces + l x its bytes), the
    # head's float32 bias, then the node table
    bias_off = wf_off + 3 * (up // k) * fb
    bb = 2 * up
    for layer, b in enumerate([bfc[:, 0]] + list(bbs[..., 0])):
        cut = raw[bias_off + layer * bb:][:bb]
        got_b = torch.from_numpy(cut.view(np.int16).copy()).view(
            torch.bfloat16).float().numpy()
        want = torch.zeros(up)
        want[:u] = b.to(torch.bfloat16).float()
        assert np.array_equal(got_b, want.numpy()), layer
    bf_off = bias_off + (nb + 1) * bb
    assert np.array_equal(raw[bf_off:bf_off + 32].view(np.float32)[:5],
                          bft[:, 0].numpy())
    assert raw.size == bf_off + 4 * (8 + tfi._NCONST)


# ---- the float32 trunk's wgmma design -----------------------------------------
# Kernels B and C in float32 at padded widths up to 256 where the resident
# blob does not fit (csrc/encode_stream_wg.cu) run each layer as
# wgmma.m64nUpk8 TF32 products, three a k-step (3xTF32): A, 64 voxels x 8
# channels, from the registers of a warpgroup's 128 threads (mma.m16n8k8's
# A fragment per warp), B by descriptor from a slab of the wgmma image that
# ops/fused_infer.py::_wg_image derives from the fragment blob: K-major core
# matrices, no swizzle, hi then lo a k-step, channel 8s + 2c + kh of k-step s
# in k-slot 4kh + c. At 320 and 384 (csrc/encode_stream_wgc.cu) each layer
# is Up / CN output chunks of CN columns, a wgmma.m64nCNk8 product each from
# the same A registers, and the image holds a layer chunk by chunk. These
# tests read the image as the descriptors read it and replay that data flow
# thread by thread in torch (float64 products of the TF32 splits).

_WG_LBO, _WG_SBO = 128, 256        # the descriptors' byte offsets


def _wg_slot_channel(slot):
    """The channel (within its k-step) that k-slot `slot` carries."""
    return 2 * (slot % 4) + slot // 4


def _wg_read_b(words, step, half, up, cn=None, kl=1, layer_step=0):
    """B (8 k-slots x up) of k-step `step` of a layer whose kl k-steps
    start at the trunk's k-step `layer_step`, hi (half 0) or lo (1), read
    as the kernel's descriptors read the slabs that hold it, chunk by
    chunk of cn columns (up: one chunk): the layer's image at 64 up bytes a
    k-step, chunk c's k-step `step` 64 cn (c kl + step) bytes into it, lo
    32 cn bytes past hi; element (k-slot kk, row n) in core matrix (n // 8,
    kk // 4) at SBO and LBO strides, its 16-byte row n % 8, 4 bytes a
    k-slot. With one chunk, `step` may count from the trunk's first
    k-step."""
    cn = up if cn is None else cn
    kk = torch.arange(8)[:, None]
    chunks = []
    for c in range(up // cn):
        n = torch.arange(cn)[None]
        off = (layer_step * 64 * up + (c * kl + step) * 64 * cn
               + half * 32 * cn + n // 8 * _WG_SBO + kk // 4 * _WG_LBO
               + n % 8 * 16 + kk % 4 * 4)
        chunks.append(words[off // 4])
    return torch.cat(chunks, 1)


def _wg_thread_maps():
    """Thread th = 32 w + 4 g + t of a warpgroup: (rows, k-slots) of its A
    registers a0..a3 -- (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of
    warp w's 16 rows -- and (rows, columns) of accumulator d[4 j + 2 hh +
    i] = D(16 w + g + 8 hh, 8 j + 2 t + i), j = 0 (later j add 8 j)."""
    th = torch.arange(128)
    w, g, t = th // 32, th % 32 // 4, th % 4
    rows = torch.stack([16 * w + g, 16 * w + g + 8] * 2, 1)
    slots = torch.stack([t, t, t + 4, t + 4], 1)
    d_rows = torch.stack([16 * w + g, 16 * w + g, 16 * w + g + 8,
                          16 * w + g + 8], 1)
    d_cols = torch.stack([2 * t, 2 * t + 1, 2 * t, 2 * t + 1], 1)
    return rows, slots, d_rows, d_cols


@pytest.mark.parametrize("units,nb", [(100, 2), (256, 2), (60, 7), (13, 3),
                                      (320, 2), (384, 1), (448, 1),
                                      (1000, 1)])
def test_wgmma_image_unpacks_to_the_encoder(units, nb):
    """The wgmma image, read by the kernel's descriptors k-step by k-step
    (the first layer's, then each block's) and, at 320 and 384, chunk by
    chunk in the chunk width the chunked kernels take there
    (fused_infer._WGC_SLABS), at 448 in the split kernels'
    (fused_infer._WGX_SLABS: each warpgroup's half one chunk), at 1024 in
    the cluster kernels' (fused_infer._WGK_PLANS: a block's columns one
    chunk), holds every
    trunk weight w[n, 8s + channel(slot)] exactly once: hi = tf32(w) in
    the hi half, lo = tf32(w - hi) in the lo half (hi + lo within 2^-21 of
    w), zeros past U and T; it is a permutation of the blob's trunk
    fragments, which stay as they were; with one chunk (up <= 256) the
    image is the one chunk width's."""
    cfg = dataclasses.replace(OPT, no_units=units, no_intermediate_layers=nb)
    _, params = port_params(cfg, SCAN, units)
    tuner = port_tuner(cfg, SCAN, params)
    blob, u, up, t = tfi._weight_blob(tuner.encoder, nb, torch.device("cpu"))
    ks0 = -(-t // 8)
    trunk = (ks0 + nb * up // 8) * up * 16
    wfc, _, wbs, _, _, _ = tfi._stream1_weights(tuner.encoder, nb)
    chan = _wg_slot_channel(torch.arange(8))
    cn = (tfi._WGC_SLABS[up][0] if up in tfi._WGC_SLABS
          else up // tfi._WGK_PLANS[up][0][0] if up in tfi._WGK_PLANS
          else tfi._WGX_SLABS.get(up, (None,))[0])
    if up <= 256:
        assert torch.equal(tfi._wg_image(blob, up, nb, t, up),
                           tfi._wg_image(blob, up, nb, t))
    words = tfi._wg_image(blob, up, nb, t, cn)
    assert words.numel() == trunk
    assert torch.equal(words.sort().values, blob[:trunk].sort().values)
    step = 0
    for w in [wfc] + list(wbs):
        kp = 8 * ks0 if step == 0 else up
        wp = torch.zeros((up, kp))
        wp[:w.shape[0], :w.shape[1]] = w
        hi_ref = tfi._tf32(wp)
        lo_ref = tfi._tf32(wp - hi_ref)
        got = torch.full((2, up, kp), float("nan"))
        for s in range(kp // 8):
            for half in range(2):
                got[half][:, 8 * s + chan] = _wg_read_b(
                    words, s, half, up, cn, kp // 8, step).T
        assert torch.equal(got[0], hi_ref) and torch.equal(got[1], lo_ref)
        assert ((got[0] + got[1] - wp).abs() <= 2.0 ** -21 * wp.abs()).all()
        step += kp // 8
    # the blob's head, biases and node table follow its trunk unchanged
    assert blob.numel() == tfi._blob_floats(up, nb, t, "float32")


def _chain_in_wgmma(x, encoder, *, se_idx, multi_image, activation,
                    n_blocks, cn=None, split=False):
    """The raw head q (5, N) by the wgmma kernels' data flow: tiles of 64
    voxels a warpgroup; a layer's k-steps as three TF32 products into one
    sum per thread and output chunk of cn columns (up: one chunk; A
    registers of the activations a thread wrote itself, B read from the
    image by descriptor); the epilogue's bias and activation on each
    thread's own accumulators, after every chunk's last k-step; the head
    on mma.sync from the blob's fragments, 16 rows a warp (as
    _chain_in_fragments). With chunks the rows are staged in the
    activation rows' first 8 ks0 columns, as csrc/encode_stream_wgc.cu
    stages them. ``split``: csrc/encode_stream_wgx.cu's flow, both
    warpgroups on the same 64 voxels, warpgroup wg writing the chunks of
    the columns wg up / 2 .. (wg + 1) up / 2 - 1, the rows staged apart."""
    act = activation_fn(activation)
    blob, u, up, t = tfi._weight_blob(encoder, n_blocks, x.device)
    cn = up if cn is None else cn
    words = tfi._wg_image(blob, up, n_blocks, t, cn)
    _, _, wf, b0, bb, bf = _blob_parts(blob, t, up, n_blocks)
    ks0 = -(-t // 8)
    h = normalise_data(x, se_idx, multi_image)          # (N, T)
    n = h.shape[0]
    apart = cn == up or split               # the rows in their own buffer
    rows = torch.zeros(-(-n // 64) * 64, 8 * ks0 if apart else up + 8)
    rows[:n, :t] = h
    tiles = rows.reshape(-1, 64, rows.shape[1])
    a_rows, a_slots, d_rows, d_cols = _wg_thread_maps()
    th = torch.arange(128)[:, None].expand(128, 4)
    # who writes each (row, column) of a layer's output -- chunk c's sum
    # d[4 j + 2 hh + i] to column c cn + 8 j + 2 t + i, by thread th of the
    # chunk's warpgroup (split: wg c // (up / 2 cn), as 128 wg + th) -- and
    # who reads it: each column once, read back by its writer alone; split,
    # by thread th of both warpgroups, half of it written by the other
    writer = torch.full((64, up), -1)
    for c in range(up // cn):
        owner = th + 128 * (c // (up // (2 * cn)) if split else 0)
        for j in range(cn // 8):
            assert (writer[d_rows, c * cn + 8 * j + d_cols] == -1).all()
            writer[d_rows, c * cn + 8 * j + d_cols] = owner
    for s in range(up // 8):
        wg = 8 * s // (up // 2) if split else 0
        assert torch.equal(writer[a_rows, 8 * s + _wg_slot_channel(a_slots)],
                           th + 128 * wg)
    # the staged rows: row 16 w + lane by lane < 16 of warp w, so every
    # thread's first-layer A registers come from its own warp
    assert torch.equal(a_rows // 16, th // 32)

    def layer(buf, first, steps, bias):
        """buf (tiles, 64, columns): the layer's inputs; returns the
        buffer after the epilogue (with chunks, the same rows written)."""
        before = buf.clone()
        d = torch.zeros(buf.shape[0], 64, up, dtype=torch.float64)
        for s in range(steps):
            regs = buf[:, a_rows, 8 * s + _wg_slot_channel(a_slots)]
            hi = tfi._tf32(regs)
            lo = tfi._tf32(regs - hi)
            a_hi = torch.zeros(buf.shape[0], 64, 8, dtype=torch.float64)
            a_lo = torch.zeros_like(a_hi)
            a_hi[:, a_rows, a_slots] = hi.double()
            a_lo[:, a_rows, a_slots] = lo.double()
            b_hi, b_lo = (_wg_read_b(words, s, half, up, cn, steps,
                                     first).double() for half in range(2))
            for c in range(up // cn):       # chunk c from its own slab
                cols = slice(c * cn, (c + 1) * cn)
                d[..., cols] += (a_lo @ b_hi[:, cols] + a_hi @ b_lo[:, cols]
                                 + a_hi @ b_hi[:, cols])
        # no output is written before the last chunk's last k-step
        assert torch.equal(buf, before)
        out = act(d.float() + bias)
        if apart:
            return out
        buf = buf.clone()
        buf[..., :up] = out
        return buf

    a = layer(tiles, 0, ks0, b0)
    for i in range(n_blocks):
        a = layer(a, ks0 + i * (up // 8), up // 8, bb[i])
    r16 = a[..., :up].reshape(-1, 16, up)
    lane = torch.arange(32)
    g, tt = lane // 4, lane % 4
    frags = [torch.stack([r16[:, g, 8 * s + 2 * tt], r16[:, g + 8, 8 * s + 2 * tt],
                          r16[:, g, 8 * s + 2 * tt + 1],
                          r16[:, g + 8, 8 * s + 2 * tt + 1]], -1)
             for s in range(up // 8)]
    c = 0.0
    for s, af in enumerate(frags):
        hi = tfi._tf32(af.float())
        lo = tfi._tf32(af.float() - hi)
        b = wf[s, 0]
        c = c + (_mma(lo, b[:, :2]) + _mma(hi, b[:, 2:]) + _mma(hi, b[:, :2]))
    c = c.float()
    q = torch.zeros(r16.shape[0], 16, 8)
    q[:, g, 2 * tt] = c[..., 0] + bf[2 * tt]
    q[:, g, 2 * tt + 1] = c[..., 1] + bf[2 * tt + 1]
    q[:, g + 8, 2 * tt] = c[..., 2] + bf[2 * tt]
    q[:, g + 8, 2 * tt + 1] = c[..., 3] + bf[2 * tt + 1]
    return q.reshape(-1, 8)[:n, :5].T


def _chain_in_cluster(x, encoder, *, se_idx, multi_image, activation,
                      n_blocks, cluster, seg, chunk=0):
    """The raw head q (5, N) by csrc/encode_stream_wgk.cu's data flow:
    a pass of 128 voxels (two warpgroups' tiles of 64, each as
    _chain_in_wgmma's) on a cluster of ``cluster`` blocks, block r
    computing the columns r NL .. (r + 1) NL - 1 of every layer (NL = up /
    cluster) from chunk r of the image in chunks of NL and keeping only
    those; past the first layer a thread's A registers of k-step s read
    from the block that holds its channels (rank s // (NL / 8), its
    columns 8 (s mod NL / 8) + channel), block r taking a block layer's
    k-steps in turn from its own, r NL / 8; a k-step's three TF32 products
    summed exactly into a fresh fragment, added to the float32 sums every
    ``seg`` k-steps of that order and at the layer's end -- with ``chunk``,
    a block's columns as two output chunks, 0 .. chunk - 1 and chunk .. NL
    - 1, each read by a descriptor 32 chunk-offset bytes into the block's
    slab and its own fragment promoted a segment at a time, chunk 0's
    first; the head's partial sums a block over its own columns from its
    own activated sums, each rounded to float32, added in rank order, then
    the bias."""
    act = activation_fn(activation)
    blob, u, up, t = tfi._weight_blob(encoder, n_blocks, x.device)
    nl = up // cluster
    nt = nl // 8
    words = tfi._wg_image(blob, up, n_blocks, t, nl)
    _, _, wf, b0, bb, bf = _blob_parts(blob, t, up, n_blocks)
    ks0 = -(-t // 8)
    h = normalise_data(x, se_idx, multi_image)          # (N, T)
    n = h.shape[0]
    rows = torch.zeros(-(-n // 128) * 128, 8 * ks0)     # every block's
    rows[:n, :t] = h
    tiles = rows.reshape(-1, 64, 8 * ks0)
    a_rows, a_slots, _, _ = _wg_thread_maps()
    chan = _wg_slot_channel(a_slots)
    # the chunks' columns of a block (one chunk: all NL) and the bytes
    # their descriptors start past the block's slab, hi or lo: 32 bytes a
    # column, 8-column core-matrix groups SBO apart
    chunks = [(0, nl)] if not chunk else [(0, chunk), (chunk, nl)]
    assert all(32 * c0 == c0 // 8 * _WG_SBO and c0 % 8 == 0
               for c0, _ in chunks)
    # every (block, k-step of its columns) is read by exactly one k-step
    owners = [(s // nt, s % nt) for s in range(up // 8)]
    assert sorted(owners) == [(r, j) for r in range(cluster)
                              for j in range(nt)]

    def layer(regs_of, steps, first, bias, rotate):
        """Each block's activations (tiles, 64, NL) after the layer."""
        b_hi, b_lo = ([_wg_read_b(words, s, half, up, nl, steps,
                                  first).double() for s in range(steps)]
                      for half in range(2))
        outs = []
        for r in range(cluster):
            acc = torch.zeros(tiles.shape[0], 64, nl)
            order = [(i + r * nt * rotate) % steps for i in range(steps)]
            for seg0 in range(0, steps, seg):
                for c0, c1 in chunks:       # chunk 0's segment first
                    cols = slice(r * nl + c0, r * nl + c1)
                    for i, s in enumerate(order[seg0:seg0 + seg]):
                        regs = regs_of(s)
                        hi = tfi._tf32(regs)
                        lo = tfi._tf32(regs - hi)
                        a_hi = torch.zeros(tiles.shape[0], 64, 8,
                                           dtype=torch.float64)
                        a_lo = torch.zeros_like(a_hi)
                        a_hi[:, a_rows, a_slots] = hi.double()
                        a_lo[:, a_rows, a_slots] = lo.double()
                        prod = (a_lo @ b_hi[s][:, cols]
                                + a_hi @ b_lo[s][:, cols]
                                + a_hi @ b_hi[s][:, cols])
                        frag = prod if i == 0 else frag + prod
                    # promoted on the CUDA cores
                    acc[..., c0:c1] = acc[..., c0:c1] + frag.float()
            outs.append(act(acc + bias[r * nl:(r + 1) * nl]))
        return outs

    bufs = layer(lambda s: tiles[:, a_rows, 8 * s + chan], ks0, 0, b0,
                 False)
    for i in range(n_blocks):
        held = bufs
        bufs = layer(
            lambda s: held[s // nt][:, a_rows, 8 * (s % nt) + chan],
            up // 8, ks0 + i * (up // 8), bb[i], True)
    lane = torch.arange(32)
    g, tt = lane // 4, lane % 4
    q = torch.zeros(tiles.shape[0] * 4, 16, 8)
    for r in range(cluster):
        r16 = bufs[r].reshape(-1, 16, nl)
        part = 0.0
        for j in range(nt):
            af = torch.stack([r16[:, g, 8 * j + 2 * tt],
                              r16[:, g + 8, 8 * j + 2 * tt],
                              r16[:, g, 8 * j + 2 * tt + 1],
                              r16[:, g + 8, 8 * j + 2 * tt + 1]], -1)
            hi = tfi._tf32(af.float())
            lo = tfi._tf32(af.float() - hi)
            b = wf[r * nt + j, 0]
            part = part + (_mma(lo, b[:, :2]) + _mma(hi, b[:, 2:])
                           + _mma(hi, b[:, :2]))
        part = part.float()
        q[:, g, 2 * tt] += part[..., 0]
        q[:, g, 2 * tt + 1] += part[..., 1]
        q[:, g + 8, 2 * tt] += part[..., 2]
        q[:, g + 8, 2 * tt + 1] += part[..., 3]
    q = q + bf[:8]
    return q.reshape(-1, 8)[:n, :5].T


@pytest.mark.parametrize("units,nb,activation", [
    (100, 2, "relu"), (100, 2, "softplus"), (60, 7, "gelu"),
    (13, 3, "sigmoid"), (192, 1, "relu"), (320, 2, "relu"),
    (384, 1, "gelu"), (448, 2, "softplus"), (833, 1, "relu"),
    (1024, 2, "softplus"), (1281, 1, "relu"), (1472, 1, "softplus")])
def test_wgmma_chain_matches_plain(units, nb, activation):
    """The chain replayed in the wgmma kernels' data flow -- padded
    channels and all, each thread reading back only the activations it
    wrote (asserted), at 320 and 384 in the chunk width taken there
    (fused_infer._WGC_SLABS) with own-read across the chunks and the rows
    staged in the activation rows, at 448 in the split kernels' flow (a
    layer's columns halved between the warpgroups, each reading the
    other's half), at 896, 1024, 1344 and 1472 in the cluster kernels'
    flow (_chain_in_cluster: each block's column share, the other blocks'
    shares read from them, the sums promoted every _WGK_PLANS segment; at
    1344 and 1472 a block's columns in the plan's two output chunks) --
    equals encode_q_plain: rtol 1e-6, atol 2e-6 (the dropped lo * lo
    terms, ~2^-22 a product), as the fragment chain."""
    cfg = dataclasses.replace(OPT, no_units=units, no_intermediate_layers=nb,
                              activation=activation)
    _, params = port_params(cfg, SCAN, units)
    tuner = port_tuner(cfg, SCAN, params)
    rng = np.random.default_rng(units + nb)
    x = torch.from_numpy(volume(rng, (70,), SCAN.n_taus))
    kw = dict(se_idx=SCAN.se_idx, multi_image=False, activation=activation,
              n_blocks=nb)
    ref = tfi.encode_q_plain(x, tuner.encoder, trunk="float32", **kw)
    up = tfi._padded_width(units)
    if up in tfi._WGK_PLANS:
        cluster, _, seg, chunk = tfi._WGK_PLANS[up][0]
        assert (chunk > 0) == (units > 1280)
        got = _chain_in_cluster(x, tuner.encoder, cluster=cluster, seg=seg,
                                chunk=chunk, **kw)
    else:
        cn = (tfi._WGC_SLABS.get(up) or tfi._WGX_SLABS.get(up)
              or (None,))[0]
        got = _chain_in_wgmma(x, tuner.encoder, cn=cn,
                              split=up in tfi._WGX_SLABS, **kw)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                               atol=2e-6)
