"""Kernel H's plain version (qbold_vi_tpu_torch/ops/conv3x3.py) and the
encoder's ``fused_conv`` routing against the JAX package.

* The plain conv and its closed-form VJP against the JAX kernel
  ``make_conv3x3(..., interpret=True)`` run as tests/test_pallas_conv.py
  runs it, at that file's tolerances: 1e-5 on the value, rtol 1e-4 /
  atol 1e-5 on dx, dw and db (the two sum the nine taps in other orders).
* The plain conv against ``F.conv2d`` in float64 at ragged planes.
* The routing: "on" / "interpret" reach the plain H on the CPU, "auto" /
  "off" the library conv, a bad mode raises, and a plane smaller than the
  window takes the library conv under "on" and raises under "interpret".
* The port's encoder under "interpret" against the JAX FineTuner under
  "interpret" on bridged weights: outputs at 2e-5, and the gradients of one
  fine-tune loss scale-normalised at rtol 5e-4 (ROADMAP gate (a)).
* The card kernel's arithmetic, modelled in torch: TF32 rounding as
  ``cvt.rna`` does it, the hi/lo split and the three TF32 products a
  float32 product becomes (3xTF32), accumulated in float32, against a
  float64 ``F.conv2d`` at the trunk's 60 channels within chip_smoke.py's
  CONV_TOL (1e-5 of the largest output and dx, 1e-4 of dw and db); one
  TF32 product fails the same gate.

Three jitted programs run the Mosaic interpreter in this file.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from torch_parity_utils import port_params, port_tuner  # noqa: E402
from qbold_vi_tpu.config import (ModelConfig, QBoldConfig,  # noqa: E402
                                 ScanParams, TrainConfig)
from qbold_vi_tpu.ops.pallas_conv import make_conv3x3  # noqa: E402
from qbold_vi_tpu_torch import config as tcfg  # noqa: E402
from qbold_vi_tpu_torch.io import from_jax  # noqa: E402
from qbold_vi_tpu_torch.models import encoder as tenc  # noqa: E402
from qbold_vi_tpu_torch.models.vi import FineTuner, init_params  # noqa: E402
from qbold_vi_tpu_torch.ops.conv3x3 import (_dw_chunk,  # noqa: E402
                                            conv3x3, conv3x3_available,
                                            conv3x3_grads_plain,
                                            conv3x3_plain)
from qbold_vi_tpu_torch.train import steps as tsteps  # noqa: E402

SCAN = ScanParams(simulate_noise=False)


def _data(rng, n, h, w, ci, co):
    x = rng.normal(size=(n, h, w, ci)).astype(np.float32)
    k = (rng.normal(size=(3, 3, ci, co)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(co,)) * 0.1).astype(np.float32)
    ct = rng.normal(size=(n, h, w, co)).astype(np.float32)
    return x, k, b, ct


@pytest.mark.parametrize("shape", [(5, 7, 6, 4, 3), (3, 9, 10, 60, 60)])
def test_plain_matches_the_jax_kernel(shape):
    n, h, w, ci, co = shape
    x, k, b, ct = _data(np.random.default_rng(sum(shape)), *shape)
    conv = make_conv3x3(h, w, ci, co, interpret=True)

    @jax.jit
    def run(x, k, b, ct):
        y, vjp = jax.vjp(conv, x, k, b)
        return (y,) + vjp(ct)

    ref = [np.asarray(a) for a in run(x, k, b, ct)]
    args = [torch.from_numpy(a).requires_grad_() for a in (x, k, b)]
    y = conv3x3(*args)
    grads = torch.autograd.grad(y, args, torch.from_numpy(ct))
    np.testing.assert_allclose(y.detach().numpy(), ref[0], rtol=1e-5,
                               atol=1e-5)
    for g, r, name in zip(grads, ref[1:], ("dx", "dw", "db")):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("shape", [(2, 3, 3, 5, 2), (1, 3, 11, 4, 6),
                                   (3, 8, 3, 3, 7), (2, 5, 9, 17, 1)])
def test_plain_matches_conv2d_in_float64(shape):
    n, h, w, ci, co = shape
    x, k, b, ct = (torch.from_numpy(a).double() for a in
                   _data(np.random.default_rng(7), *shape))
    ref = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), b,
                   padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(conv3x3_plain(x, k, b), ref, rtol=1e-12,
                               atol=1e-12)
    args = [t.clone().requires_grad_() for t in (x, k, b)]
    out = F.conv2d(args[0].permute(0, 3, 1, 2),
                   args[1].permute(3, 2, 0, 1).contiguous(),
                   args[2], padding=1).permute(0, 2, 3, 1)
    g_ref = torch.autograd.grad(out, args, ct)
    for g, r in zip(conv3x3_grads_plain(x, k, ct), g_ref):
        torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-12)
    _, dw, db = conv3x3_grads_plain(x, k, ct, need_dx=False)
    torch.testing.assert_close(dw, g_ref[1], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mode,kernel", [("auto", False), ("off", False),
                                         ("on", True), ("interpret", True),
                                         (True, True), ("False", False)])
def test_fused_conv_routes_to_kernel_h(monkeypatch, mode, kernel):
    calls = []

    def counting(*a):
        calls.append(a[0].shape)
        return conv3x3(*a)

    monkeypatch.setattr(tenc, "conv3x3", counting)
    conv = tenc.ConvXY(4, fused=mode, device="cpu")
    with torch.no_grad():
        conv.Conv_0.weight.normal_(generator=torch.Generator().manual_seed(0))
        conv.Conv_0.bias.normal_(generator=torch.Generator().manual_seed(1))
    x = torch.randn((2, 5, 4, 3, 4), generator=torch.Generator().manual_seed(2))
    y = conv(x)
    assert len(calls) == (1 if kernel else 0)
    folded = x.permute(0, 3, 1, 2, 4).reshape(6, 5, 4, 4)
    ref = F.conv2d(folded.permute(0, 3, 1, 2), conv.Conv_0.weight,
                   conv.Conv_0.bias, padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(
        y, ref.reshape(2, 3, 5, 4, 4).permute(0, 2, 3, 1, 4),
        rtol=1e-5, atol=1e-5)


def test_bad_modes_and_small_planes():
    assert conv3x3_available(3, 3) and conv3x3_available(25, 25)
    assert not conv3x3_available(2, 5) and not conv3x3_available(5, 2)
    with pytest.raises(ValueError, match="fused_conv"):
        tenc.ConvXY(4, fused="bogus", device="cpu")
    with pytest.raises(ValueError, match="fused_conv"):
        FineTuner(tcfg.ModelConfig(no_units=4, fused_conv="bogus"),
                  tcfg.ScanParams(), device="cpu")
    x = torch.randn((3, 2, 2, 4), generator=torch.Generator().manual_seed(0))
    forced = tenc.ConvXY(4, fused="interpret", device="cpu")
    with pytest.raises(ValueError, match="smaller than the 3x3 window"):
        forced(x)
    on = tenc.ConvXY(4, fused="on", device="cpu")
    with torch.no_grad():
        on.Conv_0.weight.normal_(generator=torch.Generator().manual_seed(1))
        on.Conv_0.bias.zero_()
        ref = F.conv2d(x.permute(0, 3, 1, 2), on.Conv_0.weight,
                       on.Conv_0.bias, padding=1).permute(0, 2, 3, 1)
        torch.testing.assert_close(on(x), ref)
    with pytest.raises(ValueError, match="at least 3 x 3"):
        conv3x3(x, torch.zeros(3, 3, 4, 4), torch.zeros(4))


@pytest.mark.parametrize("np_,ci,co,slots", [
    (190_000, 60, 60, 396), (147_456, 60, 60, 396), (297, 5, 7, 8),
    (1, 65, 65, 2), (4_000_000, 60, 60, 264)])
def test_dw_chunks_make_one_wave(np_, ci, co, slots):
    """Kernel H's dw pass: chunks of whole 128-pixel tiles that cover the
    pixels, and no more blocks (3 tap rows x channel tiles a chunk) than
    the card runs at once, unless one chunk's blocks already exceed it."""
    chunk = _dw_chunk(np_, ci, co, slots)
    nb = -(-np_ // chunk)
    blocks = 3 * -(-ci // 64) * -(-co // 64)
    assert chunk % 128 == 0 and nb * chunk >= np_
    assert nb * blocks <= max(slots, blocks)
    if np_ == 190_000:
        assert (chunk, nb) == (1536, 124)


def test_parameter_names_do_not_depend_on_the_mode():
    base = tcfg.ModelConfig(no_units=4, no_intermediate_layers=2)
    names = {mode: set(init_params(dataclasses.replace(base, fused_conv=mode),
                                   tcfg.ScanParams(),
                                   torch.Generator().manual_seed(0)))
             for mode in ("off", "on")}
    assert names["off"] == names["on"]
    assert "encoder.block_1.ConvXY_0.Conv_0.weight" in names["on"]


def test_encoder_under_interpret_matches_jax():
    from qbold_vi_tpu.train.steps import _finetune_terms

    model = ModelConfig(no_units=8, no_intermediate_layers=1, use_mvg=True,
                        student_t_df=200.0, predict_log_data=False,
                        multi_image_normalisation=False, gate_offset=-3.0,
                        fused_conv="interpret")
    train = TrainConfig(fused_elbo="off", fused_decode_nll="off")
    cfg = QBoldConfig(scan=SCAN, model=model, train=train)
    jt, params = port_params(model, SCAN, seed=3)
    rng = np.random.default_rng(11)
    shape = (2, 9, 10, 2)
    mask = (rng.uniform(size=shape + (1,)) > 0.2).astype(np.float32)
    batch = {"images": (np.abs(rng.normal(size=shape + (11,))) * 50 + 100
                        ).astype(np.float32) * mask,
             "mask": mask,
             "priors": (rng.normal(size=shape + (5,)) * 0.3
                        ).astype(np.float32)}
    key = jax.random.PRNGKey(5)

    @jax.jit
    def run(p):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss(q):
            return _finetune_terms(q, key, jb, jt, cfg)[0]

        value, grads = jax.value_and_grad(loss)(p)
        return jt.encode(p, jb["images"]), value, grads

    outs_ref, value_ref, grads_ref = run(jax.tree_util.tree_map(jnp.asarray,
                                                                params))
    k_sample, k_kl = jax.random.split(key)
    k_draw = jax.random.split(k_sample)[0]

    def draws(k, s):
        return np.array(jax.vmap(lambda kk: jax.random.normal(
            kk, shape + (2,)))(jax.random.split(k, s)))

    noise = {"z_nll": draws(k_draw, model.no_samples), "z_kl": draws(k_kl, 70)}
    tuner = port_tuner(model, SCAN, params)
    tc = tcfg.QBoldConfig(scan=tuner.scan, model=tuner.cfg,
                          train=tcfg.TrainConfig(fused_elbo="off",
                                                 fused_decode_nll="off"))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        outs = tuner.encode(tb["images"])
    for got, ref in zip(outs, outs_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                                   atol=2e-5)
    total, _ = tsteps.finetune_terms(tuner, tc, tb, noise=noise)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(value_ref),
                               rtol=1e-5)
    ref = from_jax.state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              grads_ref))
    for name, p in tuner.named_parameters():
        r = ref[name].numpy()
        g = p.grad.numpy() if p.grad is not None else np.zeros_like(r)
        scale = np.abs(r).max() + 1e-12
        np.testing.assert_allclose(g / scale, r / scale, rtol=5e-4,
                                   atol=5e-4, err_msg=name)


# ---- the 3xTF32 arithmetic of the card kernel (csrc/conv3x3.cu) -------------

CONV_TOL = dict(y=1e-5, dx=1e-5, dw=1e-4, db=1e-4)     # chip_smoke.py's


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 a rounded to TF32 as ``cvt.rna.tf32.f32`` does: to the
    nearest value with a 10-bit mantissa, ties away from zero (half of the
    13 dropped bits added to the sign-magnitude pattern, then dropped)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(a: torch.Tensor):
    hi = _tf32(a)
    return hi, _tf32(a - hi)


def _mm(a, b, products):
    """a @ b as the kernel takes it: a_lo b_hi + a_hi b_lo + a_hi b_hi
    (3xTF32), or a_hi b_hi alone (one TF32 product); TF32 products are
    exact in float32, and the sums are float32."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    if products == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def _conv_tf32(x, w, b, products):
    n, h, wd, ci = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(n * h * wd, w.shape[-1])
    for dy in range(3):
        for dx in range(3):
            acc = acc + _mm(xp[:, dy:dy + h, dx:dx + wd].reshape(-1, ci),
                            w[dy, dx], products)
    return (acc + b).reshape(n, h, wd, -1)


def _grads_tf32(x, w, ct, products):
    n, h, wd, ci = x.shape
    co = ct.shape[-1]
    dx = _conv_tf32(ct, torch.flip(w, (0, 1)).transpose(2, 3).contiguous(),
                    torch.zeros(ci), products)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    c2 = ct.reshape(-1, co)
    dw = torch.stack([_mm(xp[:, dy:dy + h, dx_:dx_ + wd].reshape(-1, ci).T
                          .contiguous(), c2, products)
                      for dy in range(3) for dx_ in range(3)])
    return dx, dw.reshape(3, 3, ci, co), c2.sum(0)


def test_tf32_rounding_is_nearest_ties_away():
    one_ulp = 2.0 ** -10                       # TF32's ulp at 1
    a = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2),
                      1.0 + one_ulp / 2 - 2.0 ** -23, 3.0, 0.0, -0.0])
    want = torch.tensor([1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 3.0, 0.0, 0.0])
    assert torch.equal(_tf32(a), want)
    hi, lo = _split(torch.zeros(5))
    assert torch.equal(hi, torch.zeros(5)) and torch.equal(lo, torch.zeros(5))
    v = torch.from_numpy(np.random.default_rng(1).normal(size=1000)
                         .astype(np.float32))
    hi, lo = _split(v)
    assert torch.equal(_tf32(hi), hi) and torch.equal(_tf32(lo), lo)
    assert float(((hi - v).abs() / v.abs()).max()) <= 2.0 ** -11
    assert torch.equal(_split(hi)[1], torch.zeros(1000))   # lo of a TF32 is 0


@pytest.mark.parametrize("products,within", [(3, True), (1, False)],
                         ids=["3xTF32", "one_TF32"])
def test_tf32_split_conv_meets_the_card_gate(products, within):
    n, h, w, ci, co = 2, 25, 25, 60, 60
    rng = np.random.default_rng(23)
    x, k, b, ct = (torch.from_numpy(a) for a in _data(rng, n, h, w, ci, co))
    args = [t.double().requires_grad_() for t in (x, k, b)]
    ref = F.conv2d(args[0].permute(0, 3, 1, 2),
                   args[1].permute(3, 2, 0, 1).contiguous(), args[2],
                   padding=1).permute(0, 2, 3, 1)
    refs = (ref.detach(),) + torch.autograd.grad(ref, args, ct.double())
    got = (_conv_tf32(x, k, b, products),) + _grads_tf32(x, k, ct, products)
    rel = {key: float((g.double() - r).abs().max() / r.abs().max())
           for key, g, r in zip(("y", "dx", "dw", "db"), got, refs)}
    fits = all(rel[key] <= CONV_TOL[key] for key in rel)
    assert fits == within, rel
    if not within:                      # the products miss, not the sums
        assert rel["y"] > CONV_TOL["y"] and rel["dx"] > CONV_TOL["dx"], rel
