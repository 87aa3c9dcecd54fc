"""The port's Twins encoder and FlowFormer against JAX, on the CPU.

One JAX `FlowFormer(iters=2).init` at 64x64 serves every test (no
parameter depends on the image size). Float32, at 64x64 and at 72x88,
where every pad branch runs: the Twins LSA at 18x22 and 9x11 and the
vertical LSA and GSA at 9x11 pad to a multiple of 7 and of 4, the cost
patch embed pads 9x11 maps to 16x16, and the Twins GSA's VALID sr conv
floors. Features agree to <= 1e-5 * max(1, max|ref|) max-abs (the Twins
1/8 map reaches |9.3| on these weights, where one float32 step is 9.5e-7;
measured 1.1e-5 there), flows to <= 1e-4 * max(1, max|ref|); the
bidirectional pass equals two one-way calls to `tests/test_bidir.py`'s
tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gimmvfi_tpu.flow.flowformer import FlowFormer as JaxFlowFormer
from gimmvfi_tpu.flow.twins import TwinsSVTLarge2Stage as JaxTwins
from gimmvfi_tpu_torch.flow import flowformer as tff
from gimmvfi_tpu_torch.flow.flowformer import FlowFormer, linear_pe
from gimmvfi_tpu_torch.flow.twins import TwinsSVTLarge2Stage
from gimmvfi_tpu_torch.nn.layers import Conv2d, GemmConv2d
from gimmvfi_tpu_torch.utils.convert import jax_flowformer_params_to_torch

torch.set_num_threads(1)
SIZES = [(64, 64), (72, 88)]


@pytest.fixture(scope="module")
def params():
    img = jnp.zeros((1, 64, 64, 3), jnp.float32)
    init = jax.jit(lambda r: JaxFlowFormer(iters=2).init(r, img, img))(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, init["params"])


@pytest.fixture(scope="module")
def model(params):
    m = FlowFormer(iters=2, device="cpu").eval()
    m.load_state_dict(jax_flowformer_params_to_torch(params), strict=True)
    return m


def _images(hw, seed):
    rng = np.random.default_rng(seed)
    return [(rng.random((1, *hw, 3)) * 255).astype(np.float32) for _ in range(2)]


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _bound(ref, rel):
    return rel * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("hw", SIZES)
def test_twins_matches_jax(params, model, hw):
    x = np.random.default_rng(1).uniform(-1, 1, (2, *hw, 3)).astype(np.float32)
    ref_x, ref_feats = jax.jit(JaxTwins().apply)({"params": params["context_encoder"]},
                                                  jnp.asarray(x))
    with torch.inference_mode():
        got_x, got_feats = model.context_encoder(_nchw(x))
    h, w = hw
    expect = [(2, h // 4, w // 4, 128), (2, h // 8, w // 8, 256)]
    for got, ref, shape in zip([got_x, *got_feats], [ref_x, *ref_feats], expect[1:] + expect):
        got, ref = _nhwc(got), np.asarray(ref)
        assert got.shape == ref.shape == shape
        assert np.abs(got - ref).max() <= _bound(ref, 1e-5)


@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("hw", SIZES)
def test_flowformer_matches_jax(params, model, hw, bidir):
    img1, img2 = _images(hw, 2)
    ref = jax.jit(lambda p, a, b: JaxFlowFormer(iters=2).apply(p, a, b, bidir=bidir))(
        {"params": params}, jnp.asarray(img1), jnp.asarray(img2))
    ref_flow, ref_cfeat, ref_ffeat = jax.tree_util.tree_map(np.asarray, ref)
    with torch.inference_mode():
        flow, cfeat, ffeat = model(_nchw(img1), _nchw(img2), bidir=bidir)
    rows = 2 if bidir else 1
    assert _nhwc(flow).shape == ref_flow.shape == (rows, *hw, 2)
    assert np.abs(_nhwc(flow) - ref_flow).max() <= _bound(ref_flow, 1e-4)
    for got, want in zip([*cfeat, ffeat], [*ref_cfeat, ref_ffeat]):
        assert _nhwc(got).shape == want.shape and want.shape[0] == rows
        assert np.abs(_nhwc(got) - want).max() <= _bound(want, 1e-5)


def test_bidir_equals_two_one_way_calls(model):
    """Rows :1 of the batched pass are (img1 -> img2), rows 1: are (img2 ->
    img1): the context goes to each latent token by repeat_interleave, so
    the two directions do not mix."""
    img1, img2 = (_nchw(a) for a in _images((64, 64), 3))
    with torch.inference_mode():
        flow_2n, cfeat_2n, ffeat_2n = model(img1, img2, bidir=True)
        f01, cfeat0, ffeat0 = model(img1, img2)
        f10, cfeat1, ffeat1 = model(img2, img1)
    for got, want in ((flow_2n[:1], f01), (flow_2n[1:], f10)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=1e-4)
    for got, want in [(ffeat_2n[:1], ffeat0), (ffeat_2n[1:], ffeat1)] + [
            (c2[:1], c0) for c2, c0 in zip(cfeat_2n, cfeat0)] + [
            (c2[1:], c1) for c2, c1 in zip(cfeat_2n, cfeat1)]:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-3)


def test_map_chunks_change_nothing(model, monkeypatch):
    """The cost perceiver's patch embed and input layer run over chunks of
    maps; chunks of 7 maps (ragged at the end) give the one-chunk result."""
    img1, img2 = (_nchw(a) for a in _images((64, 64), 4))
    with torch.inference_mode():
        whole = model(img1, img2, bidir=True)
        monkeypatch.setattr(tff.CostPerceiverEncoder, "MAP_CHUNK", 7)
        chunked = model(img1, img2, bidir=True)
    np.testing.assert_allclose(chunked[0].numpy(), whole[0].numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,k,pad,hw", [
    (256, 192, 3, 1, (9, 11)), (256, 126, 3, 1, (8, 8)), (5, 7, (1, 5), (0, 2), (6, 9)),
    (4, 3, 3, 0, (5, 5)),
])
def test_gemm_conv_is_the_conv(cin, cout, k, pad, hw, dtype):
    """`GemmConv2d` (unfold + matmul, which FlowFormer's motion encoder uses
    for its two 3x3 convs over 256 channels) against `Conv2d` with the same
    weights: <= 1e-5 * max|conv| in float32, one bf16 step in bf16."""
    torch.manual_seed(0)
    ref = Conv2d(cin, cout, k, 1, pad, compute_dtype=dtype)
    gemm = GemmConv2d(cin, cout, k, 1, pad, compute_dtype=dtype)
    gemm.load_state_dict(ref.state_dict())
    x = torch.randn(2, cin, *hw)
    with torch.inference_mode():
        want, got = ref(x).float(), gemm(x).float()
    assert got.shape == want.shape
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= (1e-5 if dtype is None else 2**-7) * scale
    with pytest.raises(ValueError):
        GemmConv2d(cin, cout, k, 2, pad)


def test_motion_encoder_wide_convs_are_gemms(model):
    encoder = model.memory_decoder.update_block.encoder
    assert type(encoder.convc2) is GemmConv2d and type(encoder.conv) is GemmConv2d
    assert type(encoder.convc1) is Conv2d


def test_linear_pe_keeps_the_literal_3_14():
    coords = torch.tensor([[[10.0, 4.0]]])
    pe = linear_pe(coords, 8)
    f = np.arange(2, dtype=np.float32) / 200.0
    want = np.concatenate([np.sin(3.14 * 10 * f), np.cos(3.14 * 10 * f),
                           np.sin(3.14 * 4 * f), np.cos(3.14 * 4 * f)])
    np.testing.assert_allclose(pe.numpy().ravel(), want, rtol=0, atol=1e-6)


def test_flowformer_defaults_to_the_card():
    if torch.cuda.is_available():
        assert all(p.is_cuda for p in FlowFormer(iters=1).parameters())
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            FlowFormer(iters=1)
    assert all(p.device.type == "cpu" for p in FlowFormer(iters=1, device="cpu").parameters())


def test_profile_tool_times_the_stages_and_needs_the_card():
    """`tools/flowformer_profile.py` hooks the decoder's update block and
    its motion-encoder convs, the cost perceiver's patch embed and input
    layer, and the vertical blocks; without a card it raises."""
    from gimmvfi_tpu_torch.tools import flowformer_profile

    names = set(flowformer_profile.hooked_modules(FlowFormer(iters=1, device="cpu")).values())
    for name in ("FlowFormer", "context_encoder", "memory_decoder.update_block.encoder.convc2",
                 "memory_decoder.decoder_layer.cross_attend",
                 "memory_encoder.cost_perceiver_encoder.patch_embed.proj.0",
                 "memory_encoder.cost_perceiver_encoder.vertical_encoder_layers.0.global_block"):
        assert name in names
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            flowformer_profile.main(["--iters", "1"])


def test_twins_has_no_dead_norm():
    keys = TwinsSVTLarge2Stage().state_dict()
    assert not any(k.startswith("svt.norm.") for k in keys)
    assert "svt.pos_block.1.proj.0.weight" in keys
    assert tuple(keys["svt.pos_block.1.proj.0.weight"].shape) == (256, 1, 3, 3)
