"""The port's stage-1 GIMM against the JAX GIMM, float32, on the CPU.

One JAX `init` of GIMM at 64x96 (N = 2) serves every test; its parameters
reach the port through `jax_gimm_params_to_torch`. Tolerance (ROADMAP C3):
<= 1e-5 max-abs on the normalized flow and >= 60 dB.
  * `forward` at per-sample timesteps, `forward_multi` over VSF's five;
  * `fwarp_type="softmax"` (the same parameters) against JAX's GIMM with
    that field, `forward` and `forward_multi`;
  * the VSF coordinate override (INR time (t_id - 1) / 6, splat t_id / 6);
  * `jax_gimm_params_to_torch` after `convert_gimm` gives the state dict
    back; `gimm_loss` as JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gimmvfi_tpu.models.gimm import GIMM as JaxGIMM
from gimmvfi_tpu.models.gimm import gimm_loss as jax_gimm_loss
from gimmvfi_tpu.ops.coords import sample_coords_3d as jax_sample_coords_3d
from gimmvfi_tpu.utils.convert import convert_gimm
from gimmvfi_tpu_torch.models.gimm import GIMM, gimm_loss
from gimmvfi_tpu_torch.nn.layers import init_normal_
from gimmvfi_tpu_torch.ops.coords import sample_coords_3d
from gimmvfi_tpu_torch.utils.convert import jax_gimm_params_to_torch

torch.set_num_threads(1)
N, H, W = 2, 64, 96
VSF_TS = [t / 6.0 for t in range(2, 7)]


def _flows(seed):
    rng = np.random.default_rng(seed)
    ori = rng.normal(0, 3, (N, 2, H, W, 2)).astype(np.float32)
    scaler = np.abs(ori).reshape(N, -1).max(axis=-1).reshape(N, 1, 1, 1, 1)
    return ((ori / scaler + 1.0) / 2.0).astype(np.float32), ori


@pytest.fixture(scope="module")
def params():
    xs, ori = _flows(0)
    init = jax.jit(lambda r, a, b, t: JaxGIMM().init(r, a, b, t))(
        jax.random.PRNGKey(0), jnp.asarray(xs), jnp.asarray(ori), jnp.full((N,), 0.5))
    return jax.tree_util.tree_map(np.asarray, init["params"])


@pytest.fixture(scope="module")
def model(params):
    m = GIMM(device="cpu")
    m.load_state_dict(jax_gimm_params_to_torch(params), strict=True)
    return m.eval()


def _psnr(a, b):
    mse = float(((a - b) ** 2).mean())
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def _agrees(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5
    assert _psnr(got, want) >= 60.0


def test_forward_matches_jax(params, model):
    xs, ori = _flows(1)
    t = np.asarray([0.3, 0.7], np.float32)
    ref = np.asarray(jax.jit(lambda p, a, b, tt: JaxGIMM().apply({"params": p}, a, b, tt))(
        params, jnp.asarray(xs), jnp.asarray(ori), jnp.asarray(t)))
    with torch.inference_mode():
        got = model(torch.from_numpy(xs), torch.from_numpy(ori), torch.from_numpy(t)).numpy()
    assert got.shape == (N, 1, H, W, 2)
    _agrees(got, ref)


def test_softmax_fwarp_type_matches_jax(params):
    xs, ori = _flows(5)
    t = np.asarray([0.3, 0.7], np.float32)
    jm = JaxGIMM(fwarp_type="softmax")
    ref = jax.jit(lambda p, a, b, tt: (jm.apply({"params": p}, a, b, tt), jm.apply(
        {"params": p}, a, b, jnp.asarray(VSF_TS[:2], jnp.float32), method=JaxGIMM.forward_multi)))(
        params, jnp.asarray(xs), jnp.asarray(ori), jnp.asarray(t))
    model = GIMM(device="cpu", fwarp_type="softmax")
    model.load_state_dict(jax_gimm_params_to_torch(params), strict=True)
    with torch.inference_mode():
        got = (model(torch.from_numpy(xs), torch.from_numpy(ori), torch.from_numpy(t)),
               model.forward_multi(torch.from_numpy(xs), torch.from_numpy(ori), VSF_TS[:2]))
        linear = GIMM(device="cpu")
        linear.load_state_dict(model.state_dict())
        other = linear(torch.from_numpy(xs), torch.from_numpy(ori), torch.from_numpy(t)).numpy()
    for g, r in zip(got, ref):
        _agrees(g.numpy(), np.asarray(r))
    assert np.abs(got[0].numpy() - other).max() > 1e-4  # the mode changed the splat


def test_forward_multi_matches_jax(params, model):
    xs, ori = _flows(2)
    ref = np.asarray(jax.jit(lambda p, a, b: JaxGIMM().apply(
        {"params": p}, a, b, jnp.asarray(VSF_TS, jnp.float32),
        method=JaxGIMM.forward_multi))(params, jnp.asarray(xs), jnp.asarray(ori)))
    got = model.forward_multi(torch.from_numpy(xs), torch.from_numpy(ori), VSF_TS).numpy()
    assert got.shape == (N, len(VSF_TS), H, W, 2)
    _agrees(got, ref)
    # each timestep of forward_multi is forward at that t
    with torch.inference_mode():
        one = model(torch.from_numpy(xs), torch.from_numpy(ori), torch.full((N,), VSF_TS[3]))
    assert np.abs(got[:, 3] - one[:, 0].numpy()).max() <= 1e-6


def test_vsf_coordinate_override(params, model):
    """VSF decodes at INR time (t_id - 1) / 6 after splatting to t_id / 6:
    the given coordinate reaches the HypoNet as it is."""
    xs, ori = _flows(3)
    t_id = 4
    t_splat = np.full((N,), t_id / 6.0, np.float32)
    ref_coord = jax_sample_coords_3d(N, (H, W), jnp.asarray([(t_id - 1) / 6.0]))
    coord = sample_coords_3d(N, (H, W), [(t_id - 1) / 6.0], "cpu")
    np.testing.assert_array_equal(coord.numpy(), np.asarray(ref_coord))
    ref = np.asarray(jax.jit(lambda p, a, b, tt, c: JaxGIMM().apply(
        {"params": p}, a, b, tt, coord=c))(params, jnp.asarray(xs), jnp.asarray(ori),
                                           jnp.asarray(t_splat), ref_coord))
    with torch.inference_mode():
        got = model(torch.from_numpy(xs), torch.from_numpy(ori), torch.from_numpy(t_splat),
                    coord=coord).numpy()
        plain = model(torch.from_numpy(xs), torch.from_numpy(ori),
                      torch.from_numpy(t_splat)).numpy()
    _agrees(got, ref)
    assert np.abs(got - plain).max() > 1e-4  # the override changed the decode


def test_convert_round_trip():
    torch_model = init_normal_(GIMM(device="cpu"), 5)
    sd = {k: v.numpy() for k, v in torch_model.state_dict().items()}
    params, stats = convert_gimm({**sd, "g_filter": np.ones((1, 1, 3, 3), np.float32)})
    assert stats == {}
    back = jax_gimm_params_to_torch(params)
    assert sorted(back) == sorted(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k])


def test_gimm_loss_matches_jax():
    rng = np.random.default_rng(4)
    preds, targets = rng.random((2, N, 1, 8, 8, 2), dtype=np.float32)
    ref = jax_gimm_loss(jnp.asarray(preds), jnp.asarray(targets))
    got = gimm_loss(torch.from_numpy(preds), torch.from_numpy(targets))
    assert sorted(got) == sorted(ref)
    for k in got:
        assert abs(float(got[k]) - float(ref[k])) <= 1e-5 * max(1.0, abs(float(ref[k])))


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    with pytest.raises((RuntimeError, AssertionError)):
        GIMM()
