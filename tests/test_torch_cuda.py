"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA card and skips without one (marker
``cuda``). This file imports no jax, so it runs on the machine with the
card, where jax is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: means and raw rtol 1e-4 / atol 3e-5; variances rtol 1e-3 /
atol 3e-5, with the R2' floor of torch_parity_utils.assert_vars_close.
The fine-tune kernels F and G: rows at rtol 1e-5 / atol 1e-5, gradients
scale-normalised at rtol 5e-4 / atol 5e-5 (the JAX package's own gates,
tests/test_pallas_elbo.py:88-97). The sampled kernels D and E with host
normals at the means/variances tolerances above and rtol 1e-5 for the KL
rows; with device noise against the plain versions fed philox_normals at
rtol 1e-4 (numpy's log/sin/cos on the host against the card's).
The 3x3 conv kernel H (3xTF32 tensor-core products): the output and dx
within 1e-5 of their largest magnitude, dw and db within 1e-4 of theirs
(sums of every pixel's terms in another order than the plain version's).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity_utils import (assert_vars_close, cuda_device,  # noqa: E402,F401
                                raw_head, volume)
from qbold_vi_tpu_torch import config as tcfg  # noqa: E402
from qbold_vi_tpu_torch import infer  # noqa: E402
from qbold_vi_tpu_torch.models.vi import FineTuner, init_params  # noqa: E402
from qbold_vi_tpu_torch.ops import conv3x3 as tcv  # noqa: E402
from qbold_vi_tpu_torch.ops import decode_nll as tdn  # noqa: E402
from qbold_vi_tpu_torch.ops import fused_elbo as tfe  # noqa: E402
from qbold_vi_tpu_torch.ops import fused_infer as tfi  # noqa: E402
from qbold_vi_tpu_torch.ops import quadrature as tq  # noqa: E402
from qbold_vi_tpu_torch.ops import summarize as tsm  # noqa: E402
from qbold_vi_tpu_torch.train import optim as toptim  # noqa: E402
from qbold_vi_tpu_torch.train import steps as tsteps  # noqa: E402

pytestmark = pytest.mark.cuda

SCAN = tcfg.ScanParams(simulate_noise=False)
MEAN_TOL = dict(rtol=1e-4, atol=3e-5)
VAR_TOL = dict(rtol=1e-3, atol=3e-5)
DW = float(SCAN.dw_coeff * SCAN.hct)
RANGES = dict(oef_range=0.8, min_oef=0.04, dbv_range=0.2, min_dbv=0.001,
              dw_coeff=DW)


def _tuner(cfg, device):
    tuner = FineTuner(cfg, SCAN, device=device)
    tuner.load_state_dict(init_params(cfg, SCAN,
                                      torch.Generator().manual_seed(0)))
    return tuner


def _close(got, ref):
    """(means, vars[, raw]) channel-last numpy triples."""
    np.testing.assert_allclose(got[0], ref[0], err_msg="means", **MEAN_TOL)
    assert_vars_close(got[1], ref[1], ref[0], **VAR_TOL)
    if len(got) > 2:
        np.testing.assert_allclose(got[2], ref[2], err_msg="raw", **MEAN_TOL)


@pytest.mark.parametrize("mvg", [True, False])
def test_quadrature_kernel_matches_plain(cuda_device, mvg):
    rng = np.random.default_rng(4)
    q = torch.from_numpy(raw_head(rng, 100_003)).to(cuda_device)
    before = tq.quad_posterior_summaries.launches
    got = tq.quad_posterior_summaries(q, mvg=mvg, **RANGES)
    torch.cuda.synchronize()
    assert tq.quad_posterior_summaries.launches == before + 1
    ref = tq.posterior_summaries_quadrature(q, mvg=mvg, **RANGES)
    _close([a.cpu().numpy() for a in got], [a.cpu().numpy() for a in ref])


@pytest.mark.parametrize("layout", ["voxel", "channel"])
@pytest.mark.parametrize("act,units,mvg,multi", [
    ("relu", 60, True, False),          # OPTIMAL
    ("gelu", 30, False, True),
    ("softplus", 13, True, False),      # width not a multiple of 4
])
def test_fused_kernel_matches_plain(cuda_device, layout, act, units, mvg,
                                    multi):
    cfg = dataclasses.replace(tcfg.OPTIMAL.model, activation=act,
                              no_units=units, use_mvg=mvg,
                              multi_image_normalisation=multi)
    tuner = _tuner(cfg, cuda_device)
    rng = np.random.default_rng(7)
    x = volume(rng, (50_001,), SCAN.n_taus + 1)
    x[:, -1] = rng.uniform(size=50_001) > 0.2
    xt = torch.from_numpy(x).to(cuda_device)
    if layout == "channel":
        xt = xt.T.contiguous()
    kw = dict(se_idx=SCAN.se_idx, multi_image=multi, activation=act,
              n_blocks=cfg.no_intermediate_layers, trunk="float32",
              mask_channel=True, input_layout=layout, mvg=mvg,
              **{k: v for k, v in RANGES.items()})
    before = tfi.encode_quad_fused.launches
    got = tfi.encode_quad_fused(xt, tuner.encoder, **kw)
    torch.cuda.synchronize()
    assert tfi.encode_quad_fused.launches == before + 1
    ref = tfi.encode_quad_fused_plain(xt, tuner.encoder, **kw)
    _close([a.T.cpu().numpy() for a in got], [a.T.cpu().numpy() for a in ref])


@pytest.mark.parametrize("layout", ["voxel", "channel"])
@pytest.mark.parametrize("units,mvg,multi", [(60, True, False),
                                             (13, False, True)])
def test_encode_kernel_matches_plain(cuda_device, layout, units, mvg, multi):
    """Kernel C: the raw head q (5, N) of the stream-1 encode."""
    cfg = dataclasses.replace(tcfg.OPTIMAL.model, no_units=units,
                              use_mvg=mvg, multi_image_normalisation=multi)
    tuner = _tuner(cfg, cuda_device)
    rng = np.random.default_rng(5)
    x = volume(rng, (50_003,), SCAN.n_taus + 1)
    x[:, -1] = rng.uniform(size=50_003) > 0.2
    xt = torch.from_numpy(x).to(cuda_device)
    if layout == "channel":
        xt = xt.T.contiguous()
    kw = dict(se_idx=SCAN.se_idx, multi_image=multi, activation="relu",
              n_blocks=cfg.no_intermediate_layers, trunk="float32",
              mask_channel=True, input_layout=layout)
    before = tfi.encode_q1_packed.launches
    got = tfi.encode_q1_packed(xt, tuner.encoder, **kw)
    torch.cuda.synchronize()
    assert tfi.encode_q1_packed.launches == before + 1
    ref = tfi.encode_q_plain(xt, tuner.encoder, **kw)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               **MEAN_TOL)
    if not mvg:
        assert (got[4] == 0).all()


@pytest.mark.parametrize("device_noise", [False, True],
                         ids=["host", "philox"])
@pytest.mark.parametrize("mvg,antithetic,s", [(True, True, 200),
                                              (True, False, 7),
                                              (False, True, 9)])
def test_mc_summaries_kernel_matches_plain(cuda_device, mvg, antithetic, s,
                                           device_noise):
    """Kernel D in both layouts against its plain version."""
    n, k = 50_001, 5 if mvg else 4
    rng = np.random.default_rng(6)
    q = torch.from_numpy(raw_head(rng, n, k)).to(cuda_device)
    draws = tsm.mc_draws(s, antithetic)
    kw = dict(no_samples=s, mvg=mvg, antithetic=antithetic, **RANGES)
    if device_noise:
        noise = dict(seed=9, offset=1234)
        z = torch.from_numpy(tfe.philox_normals(9, n, draws, offset=1234)
                             ).to(cuda_device)
    else:
        z = torch.from_numpy(rng.normal(size=(draws, n, 2)).astype(np.float32)
                             ).to(cuda_device)
        noise = dict(z=z)
    q_t = torch.cat([q.T, q.new_zeros((5 - k, n))]).contiguous()
    counts = (tsm.mc_posterior_summaries.launches,
              tsm.mc_posterior_summaries_packed.launches)
    got = tsm.mc_posterior_summaries(q, **noise, **kw)
    got_t = tsm.mc_posterior_summaries_packed(q_t, **noise, **kw)
    torch.cuda.synchronize()
    assert (tsm.mc_posterior_summaries.launches - counts[0],
            tsm.mc_posterior_summaries_packed.launches - counts[1]) == (1, 1)
    for a, b in zip(got, got_t):
        assert torch.equal(a, b.T)
    ref = tsm.mc_posterior_summaries_plain(q, z, **kw)
    _close([a.cpu().numpy() for a in got], [a.cpu().numpy() for a in ref])


@pytest.mark.parametrize("device_noise", [False, True],
                         ids=["host", "philox"])
@pytest.mark.parametrize("mvg", [True, False])
def test_mc_kl_kernel_matches_plain(cuda_device, mvg, device_noise):
    """Kernel E against its plain version; KL(q || q) is 0."""
    n, k, s = 50_001, 5 if mvg else 4, 100
    rng = np.random.default_rng(7)
    q = torch.from_numpy(raw_head(rng, n, k)).to(cuda_device)
    p = torch.from_numpy((rng.normal(size=(n, k)) * 0.7).astype(np.float32)
                         ).to(cuda_device)
    if device_noise:
        noise = dict(seed=3, offset=77)
        z = torch.from_numpy(tfe.philox_normals(3, n, s, offset=77)
                             ).to(cuda_device)
    else:
        z = torch.from_numpy(rng.normal(size=(s, n, 2)).astype(np.float32)
                             ).to(cuda_device)
        noise = dict(z=z)
    before = tsm.mc_kl_map.launches
    got = tsm.mc_kl_map(q, p, no_samples=s, mvg=mvg, **noise)
    self_kl = tsm.mc_kl_map(q, q, no_samples=s, mvg=mvg, **noise)
    torch.cuda.synchronize()
    assert tsm.mc_kl_map.launches == before + 2
    assert (self_kl == 0).all()
    ref = tsm.mc_kl_map_plain(q, p, z, mvg)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-4 if device_noise else 1e-5,
                               atol=1e-4)


def test_fused_kernel_raises_for_bf16_trunk(cuda_device):
    tuner = _tuner(tcfg.ModelConfig(no_units=8), cuda_device)
    x = torch.ones((10, SCAN.n_taus), device=cuda_device)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfi.encode_quad_fused(
            x, tuner.encoder, se_idx=SCAN.se_idx, multi_image=False,
            activation="relu", n_blocks=1, trunk="bfloat16", mvg=False,
            **RANGES)


@pytest.mark.parametrize("use_first_op", [True, False],
                         ids=["stream1", "stream2"])
def test_posterior_maps_on_card(cuda_device, use_first_op):
    """The slice goes through the kernels on the card (launch counts
    move) and agrees with the plain versions on the CPU."""
    cfg = tcfg.OPTIMAL.model
    gpu = _tuner(cfg, cuda_device)
    cpu = _tuner(cfg, "cpu")
    rng = np.random.default_rng(2)
    data = volume(rng, (3, 16, 16, 4), SCAN.n_taus + 1)
    data[..., -1] = rng.uniform(size=data.shape[:-1]) > 0.3
    counts = (tfi.encode_quad_fused.launches,
              tq.quad_posterior_summaries.launches)
    got = infer.posterior_maps(gpu, data, use_first_op=use_first_op)
    moved = (tfi.encode_quad_fused.launches - counts[0],
             tq.quad_posterior_summaries.launches - counts[1])
    assert moved == ((2, 0) if use_first_op else (0, 2))
    ref = infer.posterior_maps(cpu, data, use_first_op=use_first_op)
    means = [np.concatenate([d["oef"], d["dbv"], d["r2p"]], -1)
             for d in (got, ref)]
    _close([means[0], got["stds"], got["raw_log_stds"]],
           [means[1], ref["stds"], ref["raw_log_stds"]])


@pytest.mark.parametrize("use_first_op", [True, False],
                         ids=["stream1", "stream2"])
def test_mc_posterior_maps_on_card(cuda_device, use_first_op):
    """method="mc" goes through kernels C and D (stream 1) or D (stream 2)
    and, with the same Philox draws, agrees with the CPU plain path."""
    cfg = tcfg.OPTIMAL.model
    gpu = _tuner(cfg, cuda_device)
    cpu = _tuner(cfg, "cpu")
    rng = np.random.default_rng(3)
    data = volume(rng, (3, 16, 16, 4), SCAN.n_taus + 1)
    data[..., -1] = rng.uniform(size=data.shape[:-1]) > 0.3
    counters = (tfi.encode_q1_packed, tsm.mc_posterior_summaries_packed,
                tsm.mc_posterior_summaries)
    counts = [f.launches for f in counters]
    got = infer.posterior_maps(gpu, data, use_first_op=use_first_op,
                               method="mc", seed=4)
    moved = tuple(f.launches - c for f, c in zip(counters, counts))
    assert moved == ((2, 2, 0) if use_first_op else (0, 0, 2))
    # at chunk 1 the same draws (cuDNN's rounding may follow the batch
    # shape; another seed's Monte-Carlo spread is ~1e-2)
    again = infer.posterior_maps(gpu, data, use_first_op=use_first_op,
                                 method="mc", seed=4, chunk=1)
    ref = infer.posterior_maps(cpu, data, use_first_op=use_first_op,
                               method="mc", seed=4)
    for other in (again, ref):
        means = [np.concatenate([d["oef"], d["dbv"], d["r2p"]], -1)
                 for d in (got, other)]
        _close([means[0], got["stds"], got["raw_log_stds"]],
               [means[1], other["stds"], other["raw_log_stds"]])


def test_elbo_maps_on_card(cuda_device):
    """elbo_maps launches kernel E once a chunk for an MVG head and gives
    the maps of the CPU path when both draw the same normals."""
    cfg = tcfg.OPTIMAL
    gpu = _tuner(cfg.model, cuda_device)
    cpu = _tuner(cfg.model, "cpu")
    rng = np.random.default_rng(4)
    data = volume(rng, (2, 12, 12, 3), SCAN.n_taus + 1)
    data[..., -1] = rng.uniform(size=data.shape[:-1]) > 0.3
    priors = (rng.normal(size=data.shape[:-1] + (5,)) * 0.5
              ).astype(np.float32)

    def host_noise(stream, seed, start, shape, draws, device, index=None):
        g = np.random.default_rng([seed, start,
                                   ("summaries", "kl", "decode").index(stream),
                                   0 if index is None else index + 1])
        lead = () if index is not None else (draws,)
        z = g.normal(size=lead + tuple(shape) + (2,)).astype(np.float32)
        return {"z": torch.from_numpy(z).to(device)}

    before = tsm.mc_kl_map.launches
    got = infer.elbo_maps(gpu, cfg, data, priors, seed=1, no_samples=5)
    assert tsm.mc_kl_map.launches == before + 2
    assert set(got) == {"likelihood", "kl", "residual"}
    assert all(np.isfinite(v).all() for v in got.values())
    draw = infer.draw_noise
    infer.draw_noise = host_noise
    try:
        a = infer.elbo_maps(gpu, cfg, data, priors, seed=1, no_samples=5)
        b = infer.elbo_maps(cpu, cfg, data, priors, seed=1, no_samples=5)
    finally:
        infer.draw_noise = draw
    for key in a:
        np.testing.assert_allclose(a[key], b[key], rtol=1e-4, atol=1e-4,
                                   err_msg=key)


# ---- the fine-tune kernels F and G ------------------------------------------

ROW_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
FT_CASES = {
    "optimal": dict(),
    "student_multi": dict(student_t_df=2.0, multi_image_normalisation=True),
    "log_data": dict(predict_log_data=True),
    "gj16": dict(quad_rule="gj16"),
    "diag": dict(use_mvg=False),
}


def _grad_close(got, ref, name):
    got, ref = got.double().cpu(), ref.double().cpu()
    scale = ref.abs().max() + 1e-8
    np.testing.assert_allclose((got / scale).numpy(), (ref / scale).numpy(),
                               err_msg=name, **GRAD_TOL)


def _ft_inputs(rng, n, k, device, s_nll=1, s_kl=70):
    f = np.float32
    mask = (rng.uniform(size=n) > 0.2).astype(f)
    y = (np.abs(rng.normal(size=(n, SCAN.n_taus))) * 50 + 100).astype(f)
    arrays = dict(
        q=(rng.normal(size=(n, k)) * 0.7).astype(f),
        p=(rng.normal(size=(n, k)) * 0.7).astype(f),
        y=y * mask[:, None], sigma=rng.uniform(0.03, 0.2, (n, SCAN.n_taus)
                                               ).astype(f),
        mask=mask, z_nll=rng.normal(size=(s_nll, n, 2)).astype(f),
        z_kl=rng.normal(size=(s_kl, n, 2)).astype(f),
        ct_n=rng.normal(size=n).astype(f), ct_k=rng.normal(size=n).astype(f))
    return {k_: torch.from_numpy(v).to(device) for k_, v in arrays.items()}


@pytest.mark.parametrize("case", list(FT_CASES))
def test_decode_nll_kernel_matches_plain(cuda_device, case):
    cfg = dataclasses.replace(tcfg.OPTIMAL.model, **FT_CASES[case])
    C = tdn.decode_consts(cfg, SCAN)
    rng = np.random.default_rng(8)
    n = 50_001
    a = _ft_inputs(rng, n, 5, cuda_device)
    oef = torch.from_numpy(rng.uniform(0.04, 0.84, n).astype(np.float32)
                           ).to(cuda_device)
    dbv = torch.from_numpy(rng.uniform(0.001, 0.201, n).astype(np.float32)
                           ).to(cuda_device)
    args = (oef, dbv, a["y"], a["sigma"], a["mask"])
    counts = (tdn.decode_nll_forward.launches,
              tdn.decode_nll_backward.launches)
    rows = tdn.decode_nll_forward(*args, C)
    grads = tdn.decode_nll_backward(*args, a["ct_n"], C)
    torch.cuda.synchronize()
    assert (tdn.decode_nll_forward.launches - counts[0],
            tdn.decode_nll_backward.launches - counts[1]) == (1, 1)
    np.testing.assert_allclose(
        rows.cpu().numpy(),
        (tdn.nll_row_plain(*args, C) * a["mask"]).cpu().numpy(), **ROW_TOL)
    ct = a["ct_n"] * a["mask"]
    ref = tdn.nll_row_grads_plain(*args, C)
    for name, g, r in zip(("doef", "ddbv", "dsig", "dy"), grads, ref):
        r = r * (ct if r.ndim == 1 else ct[:, None])
        _grad_close(g, r, name)


@pytest.mark.parametrize("s_nll", [1, 2])
@pytest.mark.parametrize("case", list(FT_CASES))
def test_fused_elbo_kernel_matches_plain(cuda_device, case, s_nll):
    cfg = dataclasses.replace(tcfg.OPTIMAL.model, **FT_CASES[case])
    C = tdn.decode_consts(cfg, SCAN)
    mvg = cfg.use_mvg
    a = _ft_inputs(np.random.default_rng(9), 40_003, 5 if mvg else 4,
                   cuda_device, s_nll=s_nll)
    main = (a["q"], a["p"], a["y"], a["sigma"], a["mask"])
    kw = dict(mvg=mvg, s_nll=s_nll, s_kl=70, z_nll=a["z_nll"],
              z_kl=a["z_kl"])
    got = tfe.fused_elbo_forward(*main, C, **kw)
    gg = tfe.fused_elbo_backward(*main, a["ct_n"], a["ct_k"], C, **kw)
    torch.cuda.synchronize()
    ref = tfe.elbo_rows_plain(*main, a["z_nll"], a["z_kl"], C, mvg)
    gr = tfe.elbo_grads_plain(*main, a["z_nll"], a["z_kl"], a["ct_n"],
                              a["ct_k"], C, mvg)
    for name, x, y in zip(("nll", "kl"), got, ref):
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(),
                                   err_msg=name, **ROW_TOL)
    for name, x, y in zip(("dq", "dp", "dy", "dsig"), gg, gr):
        _grad_close(x, y, name)


def test_fused_elbo_device_noise(cuda_device):
    """Device noise: the kernel's Philox draws are philox_normals' (the
    plain version fed them agrees), a seed replays bit for bit, another
    seed differs, and the KL rows are unbiased for the closed form."""
    cfg = tcfg.OPTIMAL.model
    C = tdn.decode_consts(cfg, SCAN)
    n = 30_000
    a = _ft_inputs(np.random.default_rng(10), n, 5, cuda_device)
    a["q"][:, [1, 3]] *= 0.3
    a["p"][:, [1, 3]] *= 0.3
    main = (a["q"], a["p"], a["y"], a["sigma"], a["mask"])
    kw = dict(mvg=True, s_nll=1, s_kl=70)
    r1 = tfe.fused_elbo_forward(*main, C, seed=5, **kw)
    r2 = tfe.fused_elbo_forward(*main, C, seed=5, **kw)
    r3 = tfe.fused_elbo_forward(*main, C, seed=6, **kw)
    g1 = tfe.fused_elbo_backward(*main, a["ct_n"], a["ct_k"], C, seed=5, **kw)
    g2 = tfe.fused_elbo_backward(*main, a["ct_n"], a["ct_k"], C, seed=5, **kw)
    for x, y in zip(r1 + g1, r2 + g2):
        assert torch.equal(x, y)
    assert not torch.equal(r1[0], r3[0])
    z = torch.from_numpy(tfe.philox_normals(5, n, 71)).to(cuda_device)
    ref = tfe.elbo_rows_plain(*main, z[:1], z[1:], C, True)
    for x, y in zip(r1, ref):
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)
    from qbold_vi_tpu_torch.dist.logit_mvn import LogitMVN
    live = a["mask"] > 0
    diff = (r1[1] - LogitMVN().mvg_kl_closed_form(a["q"], a["p"]))[live]
    se = diff.std() / diff.numel() ** 0.5
    assert abs(float(diff.mean())) < 5 * float(se)


def _grads(tuner):
    return {k: p.grad.detach().cpu().double() for k, p in
            tuner.named_parameters() if p.grad is not None}


def _terms_grads(tuner, cfg, batch, noise):
    """Gradients of the plain fine-tune loss, backward at the caller's
    TF32 settings."""
    tuner.zero_grad()
    loss, _ = tsteps.finetune_terms(tuner, cfg, batch, noise=noise)
    loss.backward()
    return _grads(tuner)


def test_step_gradients_are_float32_on_the_card(cuda_device):
    """The fine-tune step's conv gradients on the card match the CPU's in
    float32 (make_finetune_step turns TF32 off for its backward too); the
    same backward with cuDNN's default TF32 would not. The activation is
    smooth: with relu, a pre-activation within float32 rounding of 0 can
    take the other side of the kink on the card than on the CPU, which
    moves a conv gradient by ~1e-4 of its scale whatever the TF32
    setting."""
    cfg = dataclasses.replace(
        tcfg.OPTIMAL, scan=SCAN,
        model=dataclasses.replace(tcfg.OPTIMAL.model, activation="softplus"),
        train=dataclasses.replace(tcfg.OPTIMAL.train, fused_elbo="off",
                                  fused_decode_nll="off"))
    rng = np.random.default_rng(12)
    shape = (6, 25, 25, 8)
    mask = (rng.uniform(size=shape + (1,)) > 0.2).astype(np.float32)
    batch = {"images": (np.abs(rng.normal(size=shape + (11,))) * 50 + 100
                        ).astype(np.float32) * mask, "mask": mask,
             "priors": (rng.normal(size=shape + (5,)) * 0.3
                        ).astype(np.float32)}
    noise = {"z_nll": rng.normal(size=(1,) + shape + (2,)).astype(np.float32),
             "z_kl": rng.normal(size=(70,) + shape + (2,)).astype(np.float32)}
    sd = init_params(cfg.model, SCAN, torch.Generator().manual_seed(3))
    cpu = FineTuner(cfg.model, SCAN, device="cpu")
    cpu.load_state_dict(sd)
    gpu = FineTuner(cfg.model, SCAN, device=cuda_device)
    gpu.load_state_dict(sd)
    ref = _terms_grads(cpu, cfg, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, noise)
    gb = {k: torch.from_numpy(v).to(cuda_device) for k, v in batch.items()}
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        # the backward outside the step, cuDNN at its TF32 default
        tf32 = _terms_grads(gpu, cfg, gb, noise)
        # the step: TF32 off around its forward and backward
        opt = toptim.make_finetune_optimizer(gpu.parameters(), cfg.train)
        tsteps.make_finetune_step(gpu, cfg, opt)(gb, noise=noise)
        got = _grads(gpu)
        assert torch.backends.cudnn.allow_tf32      # restored
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    conv = [k for k in ref if "ConvXY" in k and k.endswith("weight")]
    assert conv
    for k in ref:
        _grad_close(got[k], ref[k], k)
    worst = max(float(((tf32[k] - ref[k]).abs().max()
                       / (ref[k].abs().max() + 1e-8))) for k in conv)
    assert worst > GRAD_TOL["atol"], (
        f"TF32 conv gradients were within float32 tolerance ({worst:.2e}): "
        "the check cannot tell the two apart")


# ---- the 3x3 conv kernel H --------------------------------------------------

def _conv_inputs(rng, shape, device):
    n, h, w, ci, co = shape
    f = np.float32
    arrays = (rng.normal(size=(n, h, w, ci)).astype(f),
              (rng.normal(size=(3, 3, ci, co)) * 0.1).astype(f),
              (rng.normal(size=co) * 0.1).astype(f),
              rng.normal(size=(n, h, w, co)).astype(f))
    return [torch.from_numpy(a).to(device) for a in arrays]


def _scaled_close(got, ref, tol, name):
    got, ref = got.double().cpu(), ref.double().cpu()
    err = float((got - ref).abs().max())
    assert err <= tol * float(ref.abs().max()), f"{name}: {err:.3e}"


# the three main-path shapes (fine-tune fold, serving chunk, prepare_real's
# chunk), a batch of the fold, a pixel count off the 128-pixel tile, W = 3,
# W past the 130 at which the staged strip splits into three tap rows,
# ragged channel counts 1, 3, 5, 7 and 64, 65 (two channel tiles)
CONV_CARD_SHAPES = [(304, 25, 25, 60, 60), (16, 96, 96, 60, 60),
                    (32, 62, 76, 60, 60), (38, 25, 25, 60, 60),
                    (3, 7, 9, 60, 60), (9, 3, 11, 5, 7), (4, 5, 3, 7, 5),
                    (1, 4, 200, 8, 12), (2, 9, 10, 1, 3), (2, 9, 10, 3, 1),
                    (2, 9, 10, 5, 7), (2, 9, 10, 64, 65), (2, 9, 10, 65, 64)]


@pytest.mark.parametrize("shape", CONV_CARD_SHAPES)
def test_conv3x3_kernel_matches_plain(cuda_device, shape):
    x, w, b, ct = _conv_inputs(np.random.default_rng(14), shape, cuda_device)
    counts = (tcv.conv3x3.fwd_launches, tcv.conv3x3.bwd_launches)
    y = tcv.conv3x3_forward(x, w, b)
    dx, dw, db = tcv.conv3x3_backward(x, w, ct)
    torch.cuda.synchronize()
    assert (tcv.conv3x3.fwd_launches - counts[0],
            tcv.conv3x3.bwd_launches - counts[1]) == (1, 1)
    _scaled_close(y, tcv.conv3x3_plain(x, w, b), 1e-5, "y")
    ref = tcv.conv3x3_grads_plain(x, w, ct)
    for name, g, r, tol in zip(("dx", "dw", "db"), (dx, dw, db), ref,
                               (1e-5, 1e-4, 1e-4)):
        _scaled_close(g, r, tol, name)
    _, dw2, db2 = tcv.conv3x3_backward(x, w, ct, need_dx=False)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)   # replay


def test_conv3x3_kernel_refuses_bad_inputs(cuda_device):
    x, w, b, ct = _conv_inputs(np.random.default_rng(15), (2, 5, 6, 4, 3),
                               cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        tcv.conv3x3_forward(x.transpose(1, 2).contiguous().transpose(1, 2),
                            w, b)
    with pytest.raises(TypeError, match="float32"):
        tcv.conv3x3_forward(x.double(), w, b)
    with pytest.raises(TypeError, match="CUDA"):
        tcv.conv3x3_forward(x, w.cpu(), b)
    with pytest.raises(ValueError, match="cotangent"):
        tcv.conv3x3_backward(x, w, ct[:, :, :, :2].contiguous())
    with pytest.raises(ValueError, match="at least 3 x 3"):
        tcv.conv3x3_forward(x[:, :2].contiguous(), w, b)


def test_fused_conv_runs_kernel_h_in_a_finetune_step(cuda_device):
    cfg = dataclasses.replace(
        tcfg.OPTIMAL, scan=SCAN,
        model=dataclasses.replace(tcfg.OPTIMAL.model, fused_conv="on"))
    tuner = _tuner(cfg.model, cuda_device)
    rng = np.random.default_rng(16)
    shape = (4, 25, 25, 8)
    mask = (rng.uniform(size=shape + (1,)) > 0.2).astype(np.float32)
    batch = {"images": (np.abs(rng.normal(size=shape + (11,))) * 50 + 100
                        ).astype(np.float32) * mask, "mask": mask,
             "priors": (rng.normal(size=shape + (5,)) * 0.3
                        ).astype(np.float32)}
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in batch.items()}
    opt = toptim.make_finetune_optimizer(tuner.parameters(), cfg.train)
    counts = (tcv.conv3x3.fwd_launches, tcv.conv3x3.bwd_launches)
    m = tsteps.make_finetune_step(tuner, cfg, opt)(batch, seed=3)
    torch.cuda.synchronize()
    n_conv = 2 * cfg.model.no_intermediate_layers
    assert (tcv.conv3x3.fwd_launches - counts[0],
            tcv.conv3x3.bwd_launches - counts[1]) == (n_conv, n_conv)
    assert all(bool(torch.isfinite(v)) for v in m.values())
