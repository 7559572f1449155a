"""The port's fine-tune loss against the JAX package's, through each of its
three paths: the plain versions of the fused ELBO (kernel F,
ops/fused_elbo.py) and of the decode+NLL (kernel G, ops/decode_nll.py),
and the plain decode + losses. The oracle is the JAX jnp path
(``_finetune_terms`` with ``fused_elbo="off"``, ``fused_decode_nll="off"``)
on the same weights and batch; the port is handed the normals the JAX step
draws from its key (the split structure of steps.py:743-747), so both
compute the same Monte-Carlo loss.

Tolerances (tests/test_pallas_elbo.py:88-97): the loss at rtol 1e-5 /
atol 1e-5; every parameter gradient scale-normalised at rtol 5e-4 /
atol 5e-5; the aux terms at rtol 2e-5 / atol 2e-6.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity_utils import port_params, port_tuner  # noqa: E402
from qbold_vi_tpu.config import (ModelConfig, QBoldConfig,  # noqa: E402
                                 ScanParams, TrainConfig)
from qbold_vi_tpu.models.vi import FineTuner as JFineTuner  # noqa: E402
from qbold_vi_tpu.train.steps import _finetune_terms  # noqa: E402
from qbold_vi_tpu_torch import config as tcfg  # noqa: E402
from qbold_vi_tpu_torch.io.from_jax import state_dict_from_jax  # noqa: E402
from qbold_vi_tpu_torch.ops import decode_nll as tdn  # noqa: E402
from qbold_vi_tpu_torch.ops import fused_elbo as tfe  # noqa: E402
from qbold_vi_tpu_torch.train import steps as tsteps  # noqa: E402

SCAN = ScanParams(simulate_noise=False)
S_KL = 8

# the five branch configurations of tests/test_pallas_elbo.py:67-73, and
# the Gauss-Jacobi rule and the blood-free decode the kernels also cover
CASES = {
    "optimal": dict(),
    "student_multi_s2": dict(student_t_df=2.0, multi_image_normalisation=True,
                             no_samples=2),
    "log_pop_prior": dict(predict_log_data=True, use_population_prior=True),
    "diag": dict(use_mvg=False),
    "diag_student_s2": dict(use_mvg=False, student_t_df=2.0, no_samples=2),
    "gj16_no_blood": dict(quad_rule="gj16", use_blood=False),
}
# the port's three paths: (fused_elbo, fused_decode_nll)
PATHS = {"F": ("on", "off"), "G": ("off", "on"), "plain": ("off", "off")}
# the configuration the fused ELBO leaves out (its KL carries the
# population prior's hyperprior cost): kernel G's path under "auto"
UNFUSED = {"diag_pop_prior": dict(use_mvg=False, use_population_prior=True)}


def _model(kw):
    kw = dict(kw)
    use_blood = kw.pop("use_blood", True)
    kw.setdefault("student_t_df", 200.0)
    kw.setdefault("predict_log_data", False)
    kw.setdefault("multi_image_normalisation", False)
    kw.setdefault("use_mvg", True)
    return ModelConfig(no_units=4, no_intermediate_layers=1, **kw), use_blood


def _batch(rng, k):
    shape = (1, 8, 4, 1)
    img = (np.abs(rng.normal(size=shape + (SCAN.n_taus,))) * 50 + 100
           ).astype(np.float32)
    mask = (rng.uniform(size=shape + (1,)) > 0.2).astype(np.float32)
    priors = (rng.normal(size=shape + (k,)) * 0.3).astype(np.float32)
    return {"images": img * mask, "mask": mask, "priors": priors}


@functools.lru_cache(maxsize=None)
def _jax_reference(case: str):
    """(params, batch, noise, value, aux, grads) of the JAX jnp path."""
    model, use_blood = _model({**CASES, **UNFUSED}[case])
    cfg = QBoldConfig(scan=SCAN, model=model,
                      train=TrainConfig(fused_elbo="off",
                                        fused_decode_nll="off"))
    _, params = port_params(model, SCAN, seed=7)
    tuner = JFineTuner(model, SCAN, use_blood=use_blood)
    batch = _batch(np.random.default_rng(11), 5 if model.use_mvg else 4)
    key = jax.random.PRNGKey(3)

    def loss(p):
        return _finetune_terms(p, key, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                               tuner, cfg, kl_samples=S_KL)

    (value, aux), grads = jax.value_and_grad(loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    # the normals the jnp path draws: k_sample -> apply's sample_many,
    # k_kl -> mvg_kl_samples
    vox = batch["images"].shape[:-1]
    k_sample, k_kl = jax.random.split(key)
    k_draw = jax.random.split(k_sample)[0]
    noise = {"z_nll": np.array(jax.vmap(
        lambda k: jax.random.normal(k, vox + (2,)))(
            jax.random.split(k_draw, model.no_samples)))}
    if model.use_mvg:
        noise["z_kl"] = np.array(jax.vmap(
            lambda k: jax.random.normal(k, vox + (2,)))(
                jax.random.split(k_kl, S_KL)))
    return (params, batch, noise, float(value),
            {k: float(v) for k, v in aux.items()},
            state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads)))


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_jax(case, path):
    _check_loss_and_grads(case, path)


@pytest.mark.parametrize("path", ["G", "plain"])
@pytest.mark.parametrize("case", list(UNFUSED))
def test_unfused_config_matches_jax(case, path):
    """The diagonal posterior with a population prior, on kernel G's path
    and the plain one, against the JAX jnp path at the same tolerances."""
    _check_loss_and_grads(case, path)


def test_diag_pop_prior_resolves_to_kernel_g_on_the_card():
    """Under "auto" on a CUDA device the diagonal posterior with a
    population prior takes kernel G: the fused ELBO does not cover it."""
    model, _ = _model(UNFUSED["diag_pop_prior"])
    tuner = port_tuner(model, SCAN, port_params(model, SCAN)[1])
    cfg = tcfg.QBoldConfig(scan=tuner.scan, model=tuner.cfg,
                           train=tcfg.TrainConfig())
    assert (cfg.train.fused_elbo, cfg.train.fused_decode_nll) == ("auto",
                                                                  "auto")
    cuda = torch.device("cuda")
    assert tsteps.resolve_fused_elbo(tuner, cfg, cuda) is None
    consts = tsteps.resolve_fused_nll(tuner, cfg, cuda)
    assert consts is tdn.decode_consts(tuner.cfg, tuner.scan, True)
    assert not consts.student and not consts.multi and consts.cheb


def _check_loss_and_grads(case, path):
    params, batch, noise, v_ref, aux_ref, g_ref = _jax_reference(case)
    model, use_blood = _model({**CASES, **UNFUSED}[case])
    elbo_mode, nll_mode = PATHS[path]
    if path == "F" and not tfe.fused_elbo_available(
            tcfg.ModelConfig(**dataclasses.asdict(model)),
            tcfg.ScanParams(**dataclasses.asdict(SCAN)), True, use_blood):
        pytest.fail("every case here is one the fused ELBO covers")
    tuner = port_tuner(model, SCAN, params, use_blood=use_blood)
    cfg = tcfg.QBoldConfig(
        scan=tuner.scan, model=tuner.cfg,
        train=tcfg.TrainConfig(fused_elbo=elbo_mode,
                               fused_decode_nll=nll_mode))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, aux = tsteps.finetune_terms(tuner, cfg, tb, noise=noise,
                                      kl_samples=S_KL)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), v_ref, rtol=1e-5,
                               atol=1e-5)
    for k in ("nll", "kl", "smoothness", "sigma"):
        np.testing.assert_allclose(float(aux[k].detach()), aux_ref[k],
                                   rtol=2e-5, atol=2e-6, err_msg=k)
    for name, p in tuner.named_parameters():
        ref = g_ref[name].numpy()
        got = (np.zeros_like(ref) if p.grad is None
               else p.grad.numpy())
        scale = np.abs(ref).max() + 1e-8
        np.testing.assert_allclose(got / scale, ref / scale, rtol=5e-4,
                                   atol=5e-5, err_msg=name)


def _rows_inputs(rng, n, k, s_nll=1, s_kl=S_KL):
    f = np.float32
    return dict(
        q=torch.from_numpy((rng.normal(size=(n, k)) * 0.5).astype(f)),
        p=torch.from_numpy((rng.normal(size=(n, k)) * 0.5).astype(f)),
        y=torch.from_numpy((np.abs(rng.normal(size=(n, 11))) + 0.4
                            ).astype(f)),
        sigma=torch.full((n, 11), 0.08),
        mask=torch.from_numpy((rng.uniform(size=n) > 0.3).astype(f)),
        z_nll=torch.from_numpy(rng.normal(size=(s_nll, n, 2)).astype(f)),
        z_kl=torch.from_numpy(rng.normal(size=(s_kl, n, 2)).astype(f)))


@pytest.mark.parametrize("mvg", [True, False])
def test_kl_rows_match_the_kl_forms(mvg):
    """F's KL rows equal the sampled KL (MVG; dist.mvg_kl_samples on the
    same normals) or the analytic KL (diagonal), in value and in the q
    and p gradients; masked rows are exactly zero."""
    rng = np.random.default_rng(5)
    a = _rows_inputs(rng, 64, 5 if mvg else 4)
    C = tdn.decode_consts(tcfg.OPTIMAL.model, tcfg.ScanParams(
        simulate_noise=False))
    q = a["q"].requires_grad_()
    p = a["p"].requires_grad_()
    nll, kl = tfe.fused_elbo(q, p, a["y"], a["sigma"], a["mask"], C,
                             mvg=mvg, s_nll=1, s_kl=S_KL, z_nll=a["z_nll"],
                             z_kl=a["z_kl"])
    live = a["mask"] > 0
    assert torch.all(nll[~live] == 0) and torch.all(kl[~live] == 0)
    gk = torch.autograd.grad(kl.sum(), (q, p))
    from qbold_vi_tpu_torch.dist.logit_mvn import LogitMVN
    q2 = a["q"].detach().requires_grad_()
    p2 = a["p"].detach().requires_grad_()
    ref = (LogitMVN().mvg_kl_samples(a["z_kl"], q2, p2) if mvg
           else LogitMVN().diag_kl(q2, p2))
    ref = torch.where(live, ref, 0.0)
    gr = torch.autograd.grad(ref.sum(), (q2, p2))
    np.testing.assert_allclose(kl.detach().numpy(), ref.detach().numpy(),
                               rtol=2e-5, atol=2e-6)
    for x, y in zip(gk, gr):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=2e-4,
                                   atol=1e-5)


def test_philox_normals_and_device_noise_replay():
    """The device-noise generator: standard normal moments, independent
    draws, one stream per (voxel, draw); a seed replays bit for bit and
    another seed gives other rows (the plain version takes these
    normals, as the kernel draws them)."""
    z = tfe.philox_normals(12345, 20_000, 4)
    assert z.shape == (4, 20_000, 2) and z.dtype == np.float32
    flat = z.reshape(-1, 2)
    assert abs(flat.mean()) < 0.02 and abs(flat.std() - 1.0) < 0.02
    assert abs(np.corrcoef(flat[:, 0], flat[:, 1])[0, 1]) < 0.02
    np.testing.assert_array_equal(tfe.philox_normals(12345, 10, 2, first=2),
                                  z[2:, :10])
    rng = np.random.default_rng(6)
    a = _rows_inputs(rng, 32, 5)
    C = tdn.decode_consts(tcfg.OPTIMAL.model, tcfg.ScanParams())
    kw = dict(mvg=True, s_nll=1, s_kl=S_KL)
    args = (a["q"], a["p"], a["y"], a["sigma"], a["mask"], C)
    r1 = tfe.fused_elbo(*args, seed=77, **kw)
    r2 = tfe.fused_elbo(*args, seed=77, **kw)
    r3 = tfe.fused_elbo(*args, seed=78, **kw)
    zs = torch.from_numpy(tfe.philox_normals(77, 32, 1 + S_KL))
    r4 = tfe.fused_elbo(*args, z_nll=zs[:1], z_kl=zs[1:], **kw)
    for x, y, w in zip(r1, r2, r4):
        assert torch.equal(x, y) and torch.equal(x, w)
    assert not torch.equal(r1[1], r3[1])


def test_decode_nll_rows_gives_dy_only_when_y_requires_it(monkeypatch):
    """decode_nll_rows asks the backward for dy only when y requires a
    gradient: without it the backward returns no dy and the same doef,
    ddbv and dsigma; with it, dy is nll_row_grads_plain's times the masked
    cotangent."""
    rng = np.random.default_rng(9)
    n = 40
    a = _rows_inputs(rng, n, 4)
    oef = torch.from_numpy(rng.uniform(0.04, 0.84, n).astype(np.float32))
    dbv = torch.from_numpy(rng.uniform(0.001, 0.2, n).astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    C = tdn.decode_consts(tcfg.OPTIMAL.model, tcfg.ScanParams(
        simulate_noise=False))
    asked = []
    backward = tdn.decode_nll_backward

    def spy(*args, **kw):
        out = backward(*args, **kw)
        asked.append((kw["want_dy"], out[3]))
        return out

    monkeypatch.setattr(tdn, "decode_nll_backward", spy)
    grads = {}
    for y_grad in (False, True):
        leaves = [x.clone().requires_grad_() for x in (oef, dbv, a["sigma"])]
        y = a["y"].clone().requires_grad_(y_grad)
        rows = tdn.decode_nll_rows(leaves[0], leaves[1], y, leaves[2],
                                   a["mask"], C)
        torch.autograd.backward(rows, ct)
        grads[y_grad] = [x.grad for x in leaves] + [y.grad]
    assert [w for w, _ in asked] == [False, True]
    assert asked[0][1] is None and grads[False][3] is None
    for x, z in zip(grads[False][:3], grads[True][:3]):
        assert torch.equal(x, z)
    dy = tdn.nll_row_grads_plain(oef, dbv, a["y"], a["sigma"], a["mask"],
                                 C)[3]
    np.testing.assert_allclose(
        grads[True][3].numpy(), ((ct * a["mask"])[:, None] * dy).numpy(),
        rtol=1e-6, atol=1e-7)


def test_modes_resolve_with_force_semantics():
    tuner = port_tuner(*_model({})[:1], SCAN, port_params(_model({})[0],
                                                          SCAN)[1])
    base = tcfg.TrainConfig()
    cpu = torch.device("cpu")

    def cfg(model=None, **kw):
        return tcfg.QBoldConfig(scan=tuner.scan, model=model or tuner.cfg,
                                train=dataclasses.replace(base, **kw))

    assert tsteps.resolve_fused_elbo(tuner, cfg(fused_elbo="auto"), cpu) is None
    assert tsteps.resolve_fused_elbo(tuner, cfg(fused_elbo="on"), cpu)[1] is False
    for mode in ("host", "host-interpret"):
        assert tsteps.resolve_fused_elbo(tuner, cfg(fused_elbo=mode), cpu)[1]
    assert tsteps.resolve_fused_elbo(tuner, cfg(fused_elbo="interpret"),
                                     cpu) is not None
    assert tsteps.resolve_fused_elbo(tuner, cfg(fused_elbo="auto"),
                                     torch.device("cuda")) is not None
    assert tsteps.resolve_fused_nll(tuner, cfg(fused_decode_nll="auto"),
                                    cpu) is None
    uncovered = dataclasses.replace(tuner.cfg, use_mvg=False,
                                    use_population_prior=True)
    with pytest.raises(ValueError, match="not covered"):
        tsteps.resolve_fused_elbo(tuner, cfg(uncovered, fused_elbo="on"), cpu)
    with pytest.raises(ValueError, match="fused_elbo must be"):
        tsteps.resolve_fused_elbo(tuner, cfg(fused_elbo="bogus"), cpu)
    homo = dataclasses.replace(tuner.cfg, heteroscedastic_noise=False)
    with pytest.raises(ValueError, match="not covered"):
        tsteps.resolve_fused_nll(tuner, cfg(homo, fused_decode_nll="on"), cpu)


# ---- the KL state and the moment form of kernel F's KL backward -------------

def _kl_grads_moments(q, p, state, s_kl):
    """d/dq, d/dp (N, 5) of sum(kl_rows) from the KL state's moments: a
    transcription of csrc/fused_elbo.cu::qv_kl_grads_moments (each residual
    of the KL backward affine in (z0, z1), its sums of degree <= 2), valid
    where no draw clamps."""
    from qbold_vi_tpu_torch.dist.logit_mvn import whiten_factors

    qs, (qc1, qc3, qc4) = tfe._unpack(q, True)
    ps, (pc1, pc3, pc4) = tfe._unpack(p, True)
    std0, std1 = torch.exp(qs[1]), torch.exp(qs[3])
    q_itl, q_ibr, q_ibl = whiten_factors(qs[1], qs[3], qs[4])
    p_itl, p_ibr, p_ibl = whiten_factors(ps[1], ps[3], ps[4])
    p_ee = torch.exp(-ps[1] - ps[3])
    m = [torch.full_like(std0, float(s_kl))] + [state[:, i] for i in range(5)]

    def lin(x, sx, y, sy):
        return tuple(a * sx + b * sy for a, b in zip(x, y))

    def scale(x, s):
        return tuple(a * s for a in x)

    def sum1(x):
        return x[0] * m[0] + x[1] * m[1] + x[2] * m[2]

    def sum_z0(x):
        return x[0] * m[1] + x[1] * m[3] + x[2] * m[4]

    def sum_z1(x):
        return x[0] * m[2] + x[1] * m[4] + x[2] * m[5]

    def sum2(x, y):
        return ((x[0] * y[0]) * m[0] + (x[0] * y[1] + x[1] * y[0]) * m[1]
                + (x[0] * y[2] + x[2] * y[0]) * m[2] + (x[1] * y[1]) * m[3]
                + (x[1] * y[2] + x[2] * y[1]) * m[4] + (x[2] * y[2]) * m[5])

    zero = torch.zeros_like(std0)
    rq0, rq1 = (zero, std0, zero), (zero, qs[4], std1)
    rp0, rp1 = (qs[0] - ps[0], std0, zero), (qs[2] - ps[2], qs[4], std1)
    wq0, wq1 = scale(rq0, q_itl), lin(rq1, q_ibr, rq0, q_ibl)
    wp0, wp1 = scale(rp0, p_itl), lin(rp1, p_ibr, rp0, p_ibl)
    dp_l0, dp_l1 = lin(wp0, p_itl, wp1, p_ibl), scale(wp1, p_ibr)
    dl0 = lin(dp_l0, 1.0, lin(wq0, q_itl, wq1, q_ibl), -1.0)
    dl1 = lin(dp_l1, 1.0, scale(wq1, q_ibr), -1.0)
    w1r0 = sum2(wp1, rp0)
    k = [sum1(dl0), sum_z0(dl0) * std0, sum1(dl1), sum_z1(dl1) * std1,
         sum_z0(dl1), -sum1(dp_l0), -(sum2(wp0, wp0) + w1r0 * p_ibl),
         -sum1(dp_l1), -sum2(wp1, wp1), -(w1r0 * p_ee)]
    k = [a / float(s_kl) for a in k]
    k[6], k[8] = k[6] + 1.0, k[8] + 1.0
    return (torch.stack([k[0], k[1] * qc1, k[2], k[3] * qc3, k[4] * qc4], -1),
            torch.stack([k[5], k[6] * pc1, k[7], k[8] * pc3, k[9] * pc4], -1))


def _moment_grads(q, p, y, sigma, mask, z_nll, z_kl, ct_n, ct_k, C, mvg):
    """elbo_grads_plain with the KL side from the moments (MVG, no draw
    clamped): what kernel F's backward computes given the forward's KL
    state."""
    dq, dp, dy, dsig = _PLAIN_GRADS(q, p, y, sigma, mask, z_nll, z_kl, ct_n,
                                    torch.zeros_like(ct_k), C, mvg)
    state = tfe.kl_state_plain(q, mask, z_kl, C)
    assert not bool(state[:, 5].any()), "a KL draw clamped"
    kq, kp = _kl_grads_moments(q, p, state, z_kl.shape[0])
    ck = (ct_k * torch.where(mask > 0, 1.0, 0.0))[:, None]
    return dq + ck * kq, dp + ck * kp, dy, dsig


_PLAIN_GRADS = tfe.elbo_grads_plain


def _scaled_close(got, ref, name):
    got, ref = got.double().numpy(), ref.double().numpy()
    scale = np.abs(ref).max() + 1e-8
    np.testing.assert_allclose(got / scale, ref / scale, rtol=5e-4,
                               atol=5e-5, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_kl_moment_backward_matches_plain(seed):
    """The moment form of F's KL backward equals the draw-by-draw plain
    version on rows whose KL draws do not clamp, scale-normalised at rtol
    5e-4 / atol 5e-5; the forward's state is the plain state."""
    rng = np.random.default_rng(20 + seed)
    a = _rows_inputs(rng, 256, 5, s_kl=70)
    a["q"][:, [1, 3]] *= 0.3                  # logit stds clear of the clamp
    C = tdn.decode_consts(tcfg.OPTIMAL.model, tcfg.ScanParams(
        simulate_noise=False))
    ct_n = torch.from_numpy(rng.normal(size=256).astype(np.float32))
    ct_k = torch.from_numpy(rng.normal(size=256).astype(np.float32))
    args = (a["q"], a["p"], a["y"], a["sigma"], a["mask"], a["z_nll"],
            a["z_kl"], ct_n, ct_k, C, True)
    state = torch.empty(256, tfe.KL_STATE)
    tfe.fused_elbo_forward(*args[:5], C, mvg=True, s_nll=1, s_kl=70,
                           z_nll=a["z_nll"], z_kl=a["z_kl"], state=state)
    assert torch.equal(state, tfe.kl_state_plain(a["q"], a["mask"],
                                                 a["z_kl"], C))
    assert torch.all(state[a["mask"] == 0] == 0)
    for name, x, r in zip(("dq", "dp", "dy", "dsig"), _moment_grads(*args),
                          _PLAIN_GRADS(*args)):
        _scaled_close(x, r, name)


@pytest.mark.parametrize("case", ["optimal", "student_multi_s2",
                                  "log_pop_prior", "gj16_no_blood"])
def test_kl_moment_backward_matches_jax(case, monkeypatch):
    """The fine-tune loss through F's CPU path with the KL backward in the
    moment form, against the JAX jnp path's parameter gradients (as
    test_loss_and_grads_match_jax holds the plain version)."""
    params, batch, noise, v_ref, _, g_ref = _jax_reference(case)
    model, use_blood = _model(CASES[case])
    monkeypatch.setattr(tfe, "elbo_grads_plain", _moment_grads)
    tuner = port_tuner(model, SCAN, params, use_blood=use_blood)
    cfg = tcfg.QBoldConfig(scan=tuner.scan, model=tuner.cfg,
                           train=tcfg.TrainConfig(fused_elbo="on",
                                                  fused_decode_nll="off"))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = tsteps.finetune_terms(tuner, cfg, tb, noise=noise,
                                    kl_samples=S_KL)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), v_ref, rtol=1e-5,
                               atol=1e-5)
    for name, p in tuner.named_parameters():
        ref = g_ref[name].numpy()
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        scale = np.abs(ref).max() + 1e-8
        np.testing.assert_allclose(got / scale, ref / scale, rtol=5e-4,
                                   atol=5e-5, err_msg=name)


def test_kl_state_flags_clamped_draws():
    """The state's flag is set exactly where some KL draw's logits clamp
    at +-kl_bound: always for a mean past the bound, never for a narrow
    posterior near 0; dead voxels hold zero rows."""
    rng = np.random.default_rng(31)
    n = 96
    a = _rows_inputs(rng, n, 5, s_kl=70)
    C = tdn.decode_consts(tcfg.OPTIMAL.model, tcfg.ScanParams(
        simulate_noise=False))
    bound = C.scalars["kl_bound"]
    q = a["q"].clone()
    q[:, [1, 3]] = -3.0                       # std e^-3.98: ~0.02
    q[:, [0, 2]] = 0.1
    q[0::3, 0] = bound + 1.0                  # every draw clamps
    q[1::3, 2] = -(bound + 1.0)
    q[2::6, 0] = bound - 0.01                 # about half the draws clamp
    q[2::6, 1] = 1.0                          # std ~2
    mask = torch.ones(n)
    mask[5::7] = 0.0
    state = torch.empty(n, tfe.KL_STATE)
    tfe.fused_elbo_forward(q, a["p"], a["y"], a["sigma"], mask, C, mvg=True,
                           s_nll=1, s_kl=70, z_nll=a["z_nll"],
                           z_kl=a["z_kl"], state=state)
    expect = torch.zeros(n)
    expect[0::3] = 1.0
    expect[1::3] = 1.0
    expect[2::6] = 1.0
    expect[mask == 0] = 0.0
    assert torch.equal(state[:, 5], expect)
    assert torch.all(state[mask == 0] == 0)
    live = mask > 0
    np.testing.assert_allclose(state[live, 0].numpy(),
                               a["z_kl"][:, live, 0].sum(0).numpy(),
                               rtol=1e-6, atol=1e-5)
    with pytest.raises(ValueError, match="MVG"):
        tfe.fused_elbo_forward(q[:, :4], a["p"][:, :4], a["y"], a["sigma"],
                               mask, C, mvg=False, s_nll=1, s_kl=70,
                               z_nll=a["z_nll"], state=state)
