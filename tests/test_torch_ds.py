"""The port's DS_SCALE path and windowed correlation against JAX, end to end, on the CPU.

One JAX `model.init` of GIMMVFI_R(raft_iters=2) serves every test: neither
`ds_factor` nor `corr_max_volume_bytes` holds a parameter, and RAFT's
weights are its `flow_estimator` subtree. Float32 throughout:
  * RAFT with the windowed correlation forced (`corr_max_volume_bytes=0`),
    both directions: max-abs <= 1e-4 * max(1, max|ref|);
  * GIMMVFI_R with the windowed correlation forced, 128x192, and with
    `ds_factor=0.5` at 256x384 (every pyramid level of the working size
    at least 2x2): imgt_pred PSNR >= 60 dB, flowt as RAFT;
  * `resize` at the DS scales and their inverses: max-abs <= 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gimmvfi_tpu.flow.raft import RAFT as JaxRAFT
from gimmvfi_tpu.models.gimmvfi_r import GIMMVFI_R as JaxGIMMVFI_R
from gimmvfi_tpu.models.gimmvfi_r import interpolate_sequential as jax_interpolate_sequential
from gimmvfi_tpu.ops.interp import resize as jax_resize
from gimmvfi_tpu_torch.flow.raft import RAFT
from gimmvfi_tpu_torch.models.gimmvfi_r import GIMMVFI_R, interpolate_sequential
from gimmvfi_tpu_torch.ops import corr as tcorr
from gimmvfi_tpu_torch.ops.interp import resize
from gimmvfi_tpu_torch.utils.convert import jax_raft_params_to_torch, load_jax_params

torch.set_num_threads(1)
T_VALUES = [0.25, 0.5, 0.75]


@pytest.fixture(scope="module")
def variables():
    img = np.random.default_rng(0).random((1, 2, 128, 192, 3), dtype=np.float32)
    model = JaxGIMMVFI_R(raft_iters=2, remat=False)
    init = jax.jit(lambda r, x: model.init(r, x, (0.5,)))(jax.random.PRNGKey(0), jnp.asarray(img))
    return {k: jax.tree_util.tree_map(np.asarray, v) for k, v in init.items()}


@pytest.fixture
def windowed_calls(monkeypatch):
    """Counts the plain windowed lookups the port makes."""
    calls = []
    plain = tcorr.windowed_corr_lookup_plain

    def counted(*args, **kwargs):
        calls.append(args[1].shape)
        return plain(*args, **kwargs)

    monkeypatch.setattr(tcorr, "windowed_corr_lookup_plain", counted)
    return calls


def _bound(ref):
    return 1e-4 * max(1.0, float(np.abs(ref).max()))


def _psnr(a, b):
    mse = float(((a - b) ** 2).mean())
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def test_raft_windowed_matches_jax(variables, windowed_calls):
    rng = np.random.default_rng(1)
    img1, img2 = ((rng.random((1, 128, 128, 3)) * 255).astype(np.float32) for _ in range(2))
    sub = {k: v["flow_estimator"] for k, v in variables.items()}
    jm = JaxRAFT(iters=2, corr_max_volume_bytes=0)
    ref = jax.jit(lambda v, a, b: jm.apply(v, a, b, bidir=True))(
        sub, jnp.asarray(img1), jnp.asarray(img2))
    ref_flow, ref_feats, ref_fmaps = jax.tree_util.tree_map(np.asarray, ref)
    model = RAFT(iters=2, corr_max_volume_bytes=0, device="cpu")
    model.load_state_dict(jax_raft_params_to_torch(sub["params"], sub["batch_stats"]), strict=True)
    with torch.inference_mode():
        flow, feats, fmaps = model(torch.from_numpy(img1).permute(0, 3, 1, 2),
                                   torch.from_numpy(img2).permute(0, 3, 1, 2))
    assert windowed_calls == [(2, 2, 16, 16)] * 2  # both directions batched, each iteration
    for got, want in [(flow, ref_flow), (fmaps, ref_fmaps)] + list(zip(feats, ref_feats)):
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= _bound(want)


@pytest.mark.parametrize("size,ds_factor,limit", [
    ((128, 192), None, 0),  # windowed in RAFT and the AMT pyramid
    ((256, 384), 0.5, 2 << 30),  # DS_SCALE, materialized at the working size
])
def test_gimmvfi_r_matches_jax(variables, windowed_calls, size, ds_factor, limit):
    h, w = size
    img = np.random.default_rng(2).random((1, 2, h, w, 3), dtype=np.float32)
    jm = JaxGIMMVFI_R(raft_iters=2, remat=False, corr_max_volume_bytes=limit)
    ref = jax.jit(lambda v, x: jax_interpolate_sequential(
        jm, v, x, jnp.asarray(T_VALUES), ds_factor=ds_factor))(variables, jnp.asarray(img))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    model = load_jax_params(
        GIMMVFI_R(raft_iters=2, device="cpu", corr_max_volume_bytes=limit),
        variables["params"], variables["batch_stats"])
    got = interpolate_sequential(model, torch.from_numpy(img), T_VALUES, ds_factor=ds_factor)
    got = {k: v.numpy() for k, v in got.items()}
    scale = ds_factor or 1
    assert got["imgt_pred"].shape == ref["imgt_pred"].shape == (3, 1, h, w, 3)
    assert got["flowt"].shape == ref["flowt"].shape == (3, 1, int(h * scale), int(w * scale), 2)
    # RAFT's 2 iterations, then the AMT's two directions at each timestep
    assert len(windowed_calls) == (2 + 2 * len(T_VALUES) if limit == 0 else 0)
    assert _psnr(got["imgt_pred"], ref["imgt_pred"]) >= 60.0
    assert np.abs(got["flowt"] - ref["flowt"]).max() <= _bound(ref["flowt"])


@pytest.mark.parametrize("hw,scale", [
    ((136, 256), 0.5), ((136, 256), 0.25),  # the 2K / 4K downsizes, at a small size
    ((34, 64), 2.0), ((34, 64), 4.0),  # their full-resolution upsamples
    ((45, 70), 0.5), ((22, 35), 45 / 22),  # odd: int(h * s) truncates, then back up
])
def test_resize_matches_jax_at_ds_scales(hw, scale):
    """`ops/interp.py: resize` against JAX `resize`: the same int(h * s)
    output size and the same scale = 1/s source positions."""
    img = np.random.default_rng(4).standard_normal((1, *hw, 3)).astype(np.float32)
    ref = np.asarray(jax_resize(jnp.asarray(img), scale))
    got = resize(torch.from_numpy(img).permute(0, 3, 1, 2), scale).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (1, int(hw[0] * scale), int(hw[1] * scale), 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("ds_factor", [None, 1, 1.0, 0.5])
def test_prepare_keeps_full_frames_only_when_it_downsizes(variables, ds_factor):
    img = torch.from_numpy(np.random.default_rng(3).random((1, 2, 256, 256, 3), dtype=np.float32))
    model = load_jax_params(GIMMVFI_R(raft_iters=1, device="cpu"),
                            variables["params"], variables["batch_stats"])
    with torch.inference_mode():
        prep = model.prepare(img, ds_factor)
    if ds_factor == 0.5:
        full0, full1 = prep["full_img"]
        assert torch.equal(full0, img[:, 0].permute(0, 3, 1, 2))
        assert torch.equal(full1, img[:, 1].permute(0, 3, 1, 2))
        assert prep["img0"].shape == (1, 3, 128, 128)
    else:
        assert prep["full_img"] is None and prep["img0"].shape == (1, 3, 256, 256)
