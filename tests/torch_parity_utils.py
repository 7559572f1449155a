"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*).

Inputs are drawn with numpy from a seed and handed to both the JAX
function and its port; weights cross over through the port's bridge
(qbold_vi_tpu_torch/io/from_jax.py). Not a test module (no ``test_``
prefix), so pytest does not collect it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

# Tier-1 runs several xdist workers; one intra-op thread each keeps them
# from oversubscribing the cores.
torch.set_num_threads(1)


def jax_tuner_and_params(cfg, scan, images, seed: int = 0):
    """A JAX FineTuner and its params initialised on ``images``."""
    import jax

    from qbold_vi_tpu.models.vi import FineTuner

    tuner = FineTuner(cfg, scan)
    params = jax.jit(tuner.init)(jax.random.PRNGKey(seed), images)
    return tuner, params


def port_params(cfg, scan, seed: int = 0):
    """A JAX params tree (numpy leaves) drawn by the port's
    ``init_params`` -- no flax init to compile -- and the JAX FineTuner
    it belongs to."""
    from qbold_vi_tpu.models.vi import FineTuner
    from qbold_vi_tpu_torch import config as tcfg
    from qbold_vi_tpu_torch.io.from_jax import jax_from_state_dict
    from qbold_vi_tpu_torch.models.vi import init_params

    sd = init_params(tcfg.ModelConfig(**_fields(cfg)),
                     tcfg.ScanParams(**_fields(scan)),
                     torch.Generator().manual_seed(seed))
    return FineTuner(cfg, scan), jax_from_state_dict(sd)


def port_tuner(cfg, scan, jax_params, **kw):
    """The port's FineTuner (on the CPU) carrying the JAX params; ``kw``
    (full_model, use_blood) go to the FineTuner."""
    import jax

    from qbold_vi_tpu_torch import config as tcfg
    from qbold_vi_tpu_torch.io.from_jax import state_dict_from_jax
    from qbold_vi_tpu_torch.models.vi import FineTuner

    tuner = FineTuner(tcfg.ModelConfig(**_fields(cfg)),
                      tcfg.ScanParams(**_fields(scan)), device="cpu", **kw)
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    tuner.load_state_dict(state_dict_from_jax(tree))
    return tuner


def own_save_dir(cfg, tmp_path):
    """``cfg`` with a save_directory of its own under ``tmp_path``. The
    port's Trainer writes its checkpoints there and resumes what it finds
    (OPTIMAL's is the relative "optimal"), so no two Trainers -- of one test
    or of tests run side by side -- may share one."""
    import dataclasses
    import tempfile

    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, save_directory=tempfile.mkdtemp(dir=str(tmp_path))))


def _fields(dc) -> dict:
    import dataclasses

    return {f.name: getattr(dc, f.name) for f in dataclasses.fields(dc)}


def volume(rng, shape, n_taus: int) -> np.ndarray:
    """Positive ASE-like signals (..., n_taus), float32."""
    return (np.abs(rng.normal(size=tuple(shape) + (n_taus,)))
            .astype(np.float32) * 50.0 + 100.0)


def raw_head(rng, n: int, k: int = 5) -> np.ndarray:
    """Raw posterior head rows whose logit stds straddle the s = 1.5
    split (log-std tanh(q)*3-1 >= log 1.5 where q >= ~0.51)."""
    q = rng.normal(size=(n, k)).astype(np.float32)
    q[:, 0] *= 3.0
    q[:, 2] *= 3.0
    q[:, 1] *= 1.5
    q[:, 3] *= 1.5
    return q


# kernel A's head mixes: every log-std raw below the s = 1.5 split (the
# three logit stds, sqrt(od^2 + s1^2) included, all Gauss-Hermite), every
# one above it (all Gauss-Laguerre), or the straddling raw_head
HEAD_MIXES = ("below", "above", "straddling")


def head_mix(rng, n: int, mix: str, k: int = 5) -> np.ndarray:
    """raw_head rows whose log-std raws (columns 1 and 3) are redrawn
    uniformly from [-2, 0.45] ("below": s <= 1.31) or [0.6, 3] ("above":
    s >= 1.84), or left straddling the split."""
    q = raw_head(rng, n, k)
    if mix != "straddling":
        lo, hi = {"below": (-2.0, 0.45), "above": (0.6, 3.0)}[mix]
        q[:, [1, 3]] = rng.uniform(lo, hi, size=(n, 2)).astype(np.float32)
    return q


def kl_terms(q_params, p_params, z, mvg: bool = True, parts: bool = False):
    """The sampled KL's terms 0.5 (swr_p(l_s) - swr_q(l_s)) (S, N), each
    the plain version's (dist/logit_mvn.py::_MvgKLStreamed); with
    ``parts``, 0.5 (swr_p(l_s) + swr_q(l_s)) instead: the magnitude from
    which each term cancels."""
    from qbold_vi_tpu_torch.dist.logit_mvn import (LogitMVN, _kl_draw,
                                                   whiten_apply,
                                                   whiten_factors)

    q = LogitMVN().unpack(q_params, mvg)
    p = LogitMVN().unpack(p_params, mvg)
    qf = whiten_factors(q[1], q[3], q[4])
    pf = whiten_factors(p[1], p[3], p[4])
    out = []
    for d in range(z.shape[0]):
        l0, l1 = _kl_draw(q, z[d, ..., 0], z[d, ..., 1])
        _, _, wp0, wp1 = whiten_apply(l0, l1, p[0], p[2], pf)
        _, _, wq0, wq1 = whiten_apply(l0, l1, q[0], q[2], qf)
        swr_p, swr_q = wp0 * wp0 + wp1 * wp1, wq0 * wq0 + wq1 * wq1
        out.append(0.5 * ((swr_p + swr_q) if parts else (swr_p - swr_q)))
    return torch.stack(out)


def kl_lanes_replay(q_params, p_params, z, lanes: int, mvg: bool = True):
    """Kernel E's order of the sampled KL (csrc/summarize.cu::
    qv_mc_kl_kernel) in torch: lane j sums the terms (kl_terms) of the
    voxel's Philox blocks k = j, j + lanes, ... (draw 2k, then 2k + 1
    where below S), the lanes' sums meet in the tree ((a0 + a1) +
    (a2 + a3)) + ..., and the mean is the sum times float32(1 / S), plus
    (ls_p0 + ls_p1) - (ls_q0 + ls_q1)."""
    from qbold_vi_tpu_torch.dist.logit_mvn import LogitMVN

    terms = kl_terms(q_params, p_params, z, mvg)
    s = terms.shape[0]
    acc = [torch.zeros_like(terms[0]) for _ in range(lanes)]
    for j in range(lanes):
        for d in range(2 * j, s, 2 * lanes):
            acc[j] = acc[j] + terms[d]
            if d + 1 < s:
                acc[j] = acc[j] + terms[d + 1]
    while len(acc) > 1:
        acc = [acc[i] + acc[i + 1] for i in range(0, len(acc), 2)]
    q = LogitMVN().unpack(q_params, mvg)
    p = LogitMVN().unpack(p_params, mvg)
    inv_s = torch.tensor(1.0 / s, dtype=acc[0].dtype)
    return acc[0] * inv_s + ((p[1] + p[3]) - (q[1] + q[3]))


# float32 ulps of a KL row's parts that two sums of its terms in other
# orders, or with other last bits of exp and tanh, may differ by
KL_PART_ULPS = 16


def kl_scale(q_params, p_params, z, mvg: bool = True):
    """(N,) the magnitude a sampled KL row cancels from: the mean over its
    draws of 0.5 (swr_p + swr_q), plus |ls_p0| + |ls_p1| + |ls_q0| +
    |ls_q1| of its log-std tail."""
    from qbold_vi_tpu_torch.dist.logit_mvn import LogitMVN

    q = LogitMVN().unpack(q_params, mvg)
    p = LogitMVN().unpack(p_params, mvg)
    tail = p[1].abs() + p[3].abs() + q[1].abs() + q[3].abs()
    return (kl_terms(q_params, p_params, z, mvg, parts=True).double()
            .mean(0) + tail.double())


def assert_kl_close(got, ref, scale, *, rtol: float, atol: float):
    """Sampled KL rows that sum their terms in another order, or take
    other last bits of exp and tanh: (rtol, atol) plus KL_PART_ULPS float32
    ulps of each row's ``kl_scale``. A row is a difference of parts far
    larger than itself (each term 0.5 (swr_p - swr_q), and the mean against
    the log-std tail), and rounding follows the parts, not the row."""
    got, ref = (np.asarray(a, np.float64) for a in (got, ref))
    bound = (atol + rtol * np.abs(ref)
             + KL_PART_ULPS * EPS32 * np.asarray(scale, np.float64))
    err = np.abs(got - ref)
    assert np.isfinite(got).all() and (err <= bound).all(), (
        f"KL rows: max error {err.max():.3e}, max excess "
        f"{np.max(err - bound):.3e}")


EPS32 = float(np.finfo(np.float32).eps)


def assert_vars_close(got, ref, mean_ref, *, rtol: float, atol: float):
    """Posterior variances (..., 3) of (OEF, DBV, R2') against a
    reference. OEF and DBV at (rtol, atol). The R2' variance is
    dw^2 E[(oef dbv)^2] - E[r]^2 in float32 with dw ~ 300: its rounding
    noise is a few ulps of the second moment E[r^2], not of the variance,
    so its absolute bound is the larger of atol and 16 ulps of E[r^2]."""
    got, ref, mean_ref = (np.asarray(a) for a in (got, ref, mean_ref))
    np.testing.assert_allclose(got[..., :2], ref[..., :2], rtol=rtol,
                               atol=atol, err_msg="OEF/DBV variances")
    second = ref[..., 2] + mean_ref[..., 2] ** 2
    bound = rtol * np.abs(ref[..., 2]) + np.maximum(atol, 16 * EPS32 * second)
    err = np.abs(got[..., 2] - ref[..., 2])
    assert (err <= bound).all(), (
        f"R2' variance: max excess {np.max(err - bound)}")


@pytest.fixture
def cuda_device():
    """The first CUDA card; tests that need one skip without it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the H100 with "
                    "python -m pytest --noconftest -m cuda tests/test_torch_cuda.py")
    return torch.device("cuda", 0)


def assert_wls_close(got, ref, signals, scan):
    """WLS maps (..., 3) [oef, dbv, r2p] against a reference fit of the same
    signals: rtol 1e-5 plus the float32 rounding that two fits' sums over
    the taus in different orders carry (qbold_vi_tpu_torch.baseline.
    fit_rounding: 8 float32 ulps of ln S through the fit's cancellations)."""
    from qbold_vi_tpu_torch.baseline import fit_rounding

    atol = fit_rounding(signals, ref, scan)
    for i, name in enumerate(("oef", "dbv", "r2p")):
        g = np.asarray(got[..., i], np.float64)
        r = np.asarray(ref[..., i], np.float64)
        assert np.isfinite(g).all(), name
        excess = np.abs(g - r) - (1e-5 * np.abs(r) + atol[..., i])
        assert excess.max() <= 0, (name, np.abs(g - r).max(), excess.max())


def bf16_ulp(ref) -> float:
    """One bf16 ulp (8 significant bits) at the largest magnitude of ref, a
    numpy array or a tensor."""
    top = float(np.abs(np.asarray(ref.cpu() if torch.is_tensor(ref) else ref,
                                  np.float64)).max())
    return 2.0 ** (np.floor(np.log2(top)) - 7)


def assert_bf16_grads_close(named_params, grads_ref: dict,
                            weight_tol: float = 0.01,
                            bias_tol: float = 0.05) -> None:
    """A bf16-trunk step's float32 gradients against the JAX package's
    (a state_dict of its gradient tree), each scaled by the reference's
    largest entry. Weights: within ``weight_tol`` (2.5 bf16 ulps of the
    scale; both sides sum in float32 and round to bf16 at flax's points).
    Biases: within the JAX package's encoder gate, rtol / atol 0.05 --
    XLA's CPU backend sums a bf16 bias gradient (the transpose of its
    broadcast, a bf16 ``reduce``) in bf16, which moves it by up to a few
    per cent of its scale at a few hundred voxels, where the port's sum is
    float32."""
    for name, p in named_params:
        r = grads_ref[name].cpu().numpy().astype(np.float64)
        assert p.dtype == torch.float32, name
        g = (p.grad.cpu().numpy().astype(np.float64) if p.grad is not None
             else np.zeros_like(r))
        assert p.grad is None or p.grad.dtype == torch.float32, name
        scale = np.abs(r).max() + 1e-12
        if name.endswith("bias"):
            np.testing.assert_allclose(g / scale, r / scale, rtol=bias_tol,
                                       atol=bias_tol, err_msg=name)
        else:
            np.testing.assert_allclose(g / scale, r / scale, rtol=0,
                                       atol=weight_tol, err_msg=name)


def legacy_kernels(rng, cfg, n_taus):
    """The reference encoder's Conv3D (kernel, bias) pairs in creation
    order: (kx, ky, kz, in, out) kernels."""
    u = cfg.no_units
    shapes = [(1, 1, 1, n_taus, u)]
    for _ in range(cfg.no_intermediate_layers):
        shapes += [(1, 1, 1, u, u), (3, 3, 1, u, u), (3, 3, 1, u, u),
                   (1, 1, 1, u, u)]
    shapes += [(1, 1, 1, u, 5 if cfg.use_mvg else 4), (1, 1, 1, u, n_taus)]
    return [(rng.normal(size=s).astype(np.float32),
             rng.normal(size=s[-1:]).astype(np.float32)) for s in shapes]


def write_legacy_h5(path, convs, nested: bool, extras=()):
    """A Keras-2 legacy weights file: root attr layer_names; each layer
    group's attr weight_names lists its datasets' sub-paths. ``nested``
    puts every conv under one "model" group (reference final_model.h5);
    the flat form gives each conv its own group, written in a shuffled
    order (the parser sorts by the names' counter)."""
    names = [f"conv3d_{i}" if i else "conv3d" for i in range(len(convs))]
    import h5py

    with h5py.File(path, "w") as f:
        layer_names = []
        if nested:
            g = f.create_group("model")
            wnames = []
            for name, (k, b) in zip(names, convs):
                for var, arr in (("kernel", k), ("bias", b)):
                    wn = f"{name}/{var}:0"
                    wnames.append(wn.encode())
                    g.create_dataset(wn, data=arr)
            g.attrs["weight_names"] = wnames
            layer_names.append(b"model")
        else:
            order = np.random.default_rng(0).permutation(len(convs))
            for i in order:
                g = f.create_group(names[i])
                wnames = [f"{names[i]}/kernel:0", f"{names[i]}/bias:0"]
                g.create_dataset(wnames[0], data=convs[i][0])
                g.create_dataset(wnames[1], data=convs[i][1])
                g.attrs["weight_names"] = [w.encode() for w in wnames]
                layer_names.append(names[i].encode())
        for i, arr in enumerate(extras):
            lname = f"variable_{i}" if i else "variable"
            vg = f.create_group(lname)
            wn = f"{lname}/Variable:0"
            vg.attrs["weight_names"] = [wn.encode()]
            vg.create_dataset(wn, data=arr)
            layer_names.append(lname.encode())
        f.attrs["layer_names"] = layer_names
