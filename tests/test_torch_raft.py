"""Port RAFT against the JAX RAFT, bidirectional, 2 iterations, 128x128, CPU.

Weights come from the JAX `model.init` and go through
`jax_raft_params_to_torch`. Tolerance: max-abs <= 1e-4 * max(1, max|ref|)
(float32 convolutions summed in another order, through 2 GRU iterations).
RAFT's `corr_levels` and `corr_radius` off JAX's defaults (3 and 3, one
JAX init): the flows within 1e-4 of max|ref|, materialized and windowed
(`corr_max_volume_bytes=0` on both sides); and at 5 levels and radius 5
(the kernels' general case on the card) on a 256x256 pair, whose 32x32
feature map pools to 2x2 at its fifth level, the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gimmvfi_tpu.flow.raft import RAFT as JaxRAFT
from gimmvfi_tpu.utils.convert import convert_raft
from gimmvfi_tpu_torch.flow.raft import RAFT
from gimmvfi_tpu_torch.utils.convert import jax_raft_params_to_torch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def raft_pair():
    rng = np.random.default_rng(0)
    img1 = (rng.random((1, 128, 128, 3)) * 255).astype(np.float32)
    img2 = (rng.random((1, 128, 128, 3)) * 255).astype(np.float32)
    model = JaxRAFT(iters=2)
    variables = jax.jit(lambda r, a, b: model.init(r, a, b, bidir=True))(
        jax.random.PRNGKey(0), jnp.asarray(img1), jnp.asarray(img2)
    )
    ref = jax.jit(lambda v, a, b: model.apply(v, a, b, bidir=True))(
        variables, jnp.asarray(img1), jnp.asarray(img2)
    )
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    return img1, img2, params, stats, jax.tree_util.tree_map(np.asarray, ref)


def _bound(ref):
    return 1e-4 * max(1.0, float(np.abs(ref).max()))


def test_raft_bidir_matches_jax(raft_pair):
    img1, img2, params, stats, (ref_flow, ref_feats, ref_fmaps) = raft_pair
    model = RAFT(iters=2, device="cpu")
    model.load_state_dict(jax_raft_params_to_torch(params, stats), strict=True)
    with torch.inference_mode():
        flow, feats, fmaps = model(
            torch.from_numpy(img1).permute(0, 3, 1, 2),
            torch.from_numpy(img2).permute(0, 3, 1, 2),
        )
    pairs = [(flow, ref_flow), (fmaps, ref_fmaps)] + list(zip(feats, ref_feats))
    for got, ref in pairs:
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= _bound(ref)


@pytest.fixture(scope="module")
def raft_options(raft_pair):
    """One JAX init of RAFT(iters=2, corr_levels=3, corr_radius=3) on the
    fixture's pair."""
    img1, img2 = raft_pair[:2]
    model = JaxRAFT(iters=2, corr_levels=3, corr_radius=3)
    variables = jax.jit(lambda r, a, b: model.init(r, a, b, bidir=True))(
        jax.random.PRNGKey(1), jnp.asarray(img1), jnp.asarray(img2))
    return {k: jax.tree_util.tree_map(np.asarray, v) for k, v in variables.items()}


@pytest.mark.parametrize("limit", [2 << 30, 0])
def test_raft_levels_and_radius_match_jax(raft_pair, raft_options, limit):
    img1, img2 = raft_pair[:2]
    jm = JaxRAFT(iters=2, corr_levels=3, corr_radius=3, corr_max_volume_bytes=limit)
    ref = np.asarray(jax.jit(lambda v, a, b: jm.apply(v, a, b, bidir=True)[0])(
        raft_options, jnp.asarray(img1), jnp.asarray(img2)))
    model = RAFT(iters=2, device="cpu", corr_max_volume_bytes=limit, corr_levels=3,
                 corr_radius=3)
    model.load_state_dict(jax_raft_params_to_torch(raft_options["params"],
                                                   raft_options["batch_stats"]), strict=True)
    assert model.update_block.encoder.convc1.in_channels == 3 * 7**2
    with torch.inference_mode():
        flow = model(*(torch.from_numpy(x).permute(0, 3, 1, 2) for x in (img1, img2)))[0]
    got = flow.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-4 * float(np.abs(ref).max())


@pytest.fixture(scope="module")
def raft_wide():
    """A seeded 256x256 pair and one JAX init of RAFT(iters=2,
    corr_levels=5, corr_radius=5) on it."""
    rng = np.random.default_rng(5)
    img1, img2 = ((rng.random((1, 256, 256, 3)) * 255).astype(np.float32) for _ in range(2))
    model = JaxRAFT(iters=2, corr_levels=5, corr_radius=5)
    variables = jax.jit(lambda r, a, b: model.init(r, a, b, bidir=True))(
        jax.random.PRNGKey(2), jnp.asarray(img1), jnp.asarray(img2))
    return img1, img2, {k: jax.tree_util.tree_map(np.asarray, v) for k, v in variables.items()}


@pytest.mark.parametrize("limit", [2 << 30, 0])
def test_raft_five_levels_radius_five_match_jax(raft_wide, limit):
    img1, img2, variables = raft_wide
    kw = {"corr_max_volume_bytes": limit, "corr_levels": 5, "corr_radius": 5}
    jm = JaxRAFT(iters=2, **kw)
    ref = np.asarray(jax.jit(lambda v, a, b: jm.apply(v, a, b, bidir=True)[0])(
        variables, jnp.asarray(img1), jnp.asarray(img2)))
    model = RAFT(iters=2, device="cpu", **kw)
    model.load_state_dict(jax_raft_params_to_torch(variables["params"],
                                                   variables["batch_stats"]), strict=True)
    assert model.update_block.encoder.convc1.in_channels == 5 * 11**2
    with torch.inference_mode():
        flow = model(*(torch.from_numpy(x).permute(0, 3, 1, 2) for x in (img1, img2)))[0]
    got = flow.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, 256, 256, 2)
    assert np.abs(got - ref).max() <= 1e-4 * float(np.abs(ref).max())


def test_raft_weight_round_trip_is_exact(raft_pair):
    _, _, params, stats, _ = raft_pair
    back_p, back_s = convert_raft(jax_raft_params_to_torch(params, stats))
    for a, b in ((back_p, params), (back_s, stats)):
        fa, ta = jax.tree_util.tree_flatten(a)
        fb, tb = jax.tree_util.tree_flatten(b)
        assert ta == tb
        for x, y in zip(fa, fb):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_motion_encoder_wide_convs_by_dtype(dtype):
    """In float32 the motion encoder's two 3x3 convs over 256 channels are
    GEMMs (cuDNN's FFT path takes them at 720p); bf16 keeps cuDNN. The
    profile's swap back to `Conv2d` keeps the weights and the output
    (<= 1e-5 * max|out| in float32)."""
    from gimmvfi_tpu_torch.models.gimmvfi_r import GIMMVFI_R
    from gimmvfi_tpu_torch.nn.layers import Conv2d, GemmConv2d, init_normal_
    from gimmvfi_tpu_torch.tools.raft_f32_profile import WIDE_CONVS, swap_wide_convs

    model = init_normal_(GIMMVFI_R(raft_iters=2, dtype=dtype, device="cpu"), 3)
    enc = model.flow_estimator.update_block.encoder
    want = GemmConv2d if dtype is None else Conv2d
    assert [type(getattr(enc, n)) for n in WIDE_CONVS] == [want, want]
    assert type(enc.convc1) is Conv2d and type(enc.convf2) is Conv2d
    if dtype is not None:
        return
    gen = torch.Generator().manual_seed(4)
    flow, corr = torch.randn(2, 2, 9, 11, generator=gen), torch.randn(2, 324, 9, 11, generator=gen)
    with torch.inference_mode():
        gemm_out = enc(flow, corr)
        swap_wide_convs(model, Conv2d)
        assert [type(getattr(enc, n)) for n in WIDE_CONVS] == [Conv2d, Conv2d]
        cudnn_out = enc(flow, corr)
    assert float((gemm_out - cudnn_out).abs().max()) <= 1e-5 * float(cudnn_out.abs().max())
