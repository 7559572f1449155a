"""The port's serving export (io/export_model.py, ``torch.export``) and
kernel B's registered op.

The default artifact, written by ``save_exported`` and read back by
``load_exported``, must give ``infer.posterior_maps``' maps on the CPU at
rtol / atol 1e-5 (the maps gate of tests/test_torch_infer.py) at two
geometries it was not traced at. The fused artifact holds kernel B's op
and runs only on the card (tests/test_torch_cuda.py holds it there); here
its export refuses the CPU, and the op's fake implementation gives its
output shapes without data.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qbold_vi_tpu_torch import config as tcfg  # noqa: E402
from qbold_vi_tpu_torch import infer as tinfer  # noqa: E402
from qbold_vi_tpu_torch.io import export_model as em  # noqa: E402
from qbold_vi_tpu_torch.models.vi import FineTuner, init_params  # noqa: E402
from qbold_vi_tpu_torch.ops import fused_infer as fi  # noqa: E402

SCAN = tcfg.ScanParams()


def _tuner(**kw):
    cfg = tcfg.ModelConfig(no_units=8, no_intermediate_layers=2, **kw)
    t = FineTuner(cfg, SCAN, device="cpu")
    t.load_state_dict(init_params(cfg, SCAN, torch.Generator().manual_seed(3)))
    return t


def _volumes(rng, shape):
    v = (np.abs(rng.normal(size=shape + (SCAN.n_taus + 1,))) * 50 + 100
         ).astype(np.float32)
    v[..., -1] = rng.uniform(size=shape) > 0.2
    return v


def test_default_artifact_matches_posterior_maps(tmp_path):
    """Stream 2 of an MVG model with a fused_conv="on" config (the artifact
    takes the library conv): saved, loaded, and run at (1, 6, 5, 2) and
    (3, 4, 9, 5); the map dict, its shapes and values."""
    tuner = _tuner(fused_conv="on")
    ep = em.export_inference(tuner, use_first_op=False)
    path = str(tmp_path / "maps.pt2")
    assert em.save_exported(ep, path) > 0
    art = em.load_exported(path)
    rng = np.random.default_rng(0)
    for shape in ((1, 6, 5, 2), (3, 4, 9, 5)):
        data = _volumes(rng, shape)
        got = art(torch.from_numpy(data))
        ref = tinfer.posterior_maps(tuner, data, use_first_op=False)
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].shape == ref[k].shape, k
            np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)
    with pytest.raises(Exception):
        art(torch.from_numpy(_volumes(rng, (1, 2, 5, 2))))    # x < 3


def test_fused_export_needs_the_card_and_platforms_are_checked():
    tuner = _tuner()
    with pytest.raises(ValueError, match="card"):
        em.export_inference(tuner, fused=True, platforms=("cuda",))
    with pytest.raises(ValueError, match="stream-1"):
        em.export_inference(tuner, fused=True, use_first_op=False,
                            platforms=("cuda",))
    with pytest.raises(ValueError, match="platforms"):
        em.export_inference(tuner, platforms=("tpu", "cpu"))
    with pytest.raises(ValueError, match="activation"):
        em.export_inference(_tuner(activation="selu"), fused=True,
                            platforms=("cuda",))


def test_kernel_b_op_is_registered_with_a_fake():
    """The op mutates nothing; its fake implementation gives (3, N) float32
    outputs for either layout without touching data (meta tensors); a CPU
    tensor has no kernel."""
    op = torch.ops.qbold_vi_tpu_torch.encode_quad_fused.default
    assert not op._schema.is_mutable
    blob = torch.empty(1000, device="meta")
    for shape, channel_major in (((12, 7), True), ((9, 12), False)):
        outs = op(torch.empty(shape, device="meta"), blob, 8, 16, 2,
                  channel_major, True, 3, False, "relu", "float32", True,
                  0.8, 0.04, 0.2, 0.001, 1.0)
        n = shape[1] if channel_major else shape[0]
        assert [tuple(o.shape) for o in outs] == [(3, n)] * 3
        assert all(o.dtype == torch.float32 for o in outs)
    with pytest.raises(NotImplementedError):
        op(torch.zeros((12, 7)), torch.zeros(10), 8, 16, 2, True, True, 3,
           False, "relu", "float32", True, 0.8, 0.04, 0.2, 0.001, 1.0)
    before = fi.encode_quad_fused.launches
    tuner = _tuner()
    x = torch.from_numpy(_volumes(np.random.default_rng(1), (40,)))
    kw = dict(se_idx=SCAN.se_idx, multi_image=False, activation="relu",
              n_blocks=2, trunk="float32", mvg=True, oef_range=0.8,
              min_oef=0.04, dbv_range=0.2, min_dbv=0.001, dw_coeff=1.0,
              mask_channel=True)
    got = fi.encode_quad_fused(x, tuner.encoder, **kw)     # plain on CPU
    ref = fi.encode_quad_fused_plain(x, tuner.encoder, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert fi.encode_quad_fused.launches == before
