"""The port's GIMMVFI_F against the JAX GIMMVFI_F end to end, on the CPU.

One JAX `model.init` of GIMMVFI_F(ff_iters=2) at 128x192 serves every test
(`corr_max_volume_bytes` holds no parameter). `interpolate_sequential` at
t in {0.25, 0.5, 0.75}:
  * float32, at the default limit (materialized AMT pyramid) and at
    `corr_max_volume_bytes=0` (the windowed float32 pyramid, the route the
    720p pair takes; FlowFormer's own volume is always materialized):
    imgt_pred PSNR >= 60 dB, flowt max-abs <= 1e-4 * max(1, max|ref|);
  * bf16 against bf16 JAX: the stacks round at other places, so only
    >= 45 dB is asserted; FlowFormer stays float32 in both.
Each records its PSNR (`record_property`, in the JUnit XML).
The converter round trip: a random-init port state dict goes through the
JAX package's `convert_gimmvfi_f` with every key consumed and the JAX
tree's every leaf produced, and the JAX tree comes back exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gimmvfi_tpu.models.gimmvfi_f import GIMMVFI_F as JaxGIMMVFI_F
from gimmvfi_tpu.models.gimmvfi_r import interpolate_sequential as jax_interpolate_sequential
from gimmvfi_tpu.utils import convert as jax_convert
from gimmvfi_tpu_torch.models.gimmvfi_f import GIMMVFI_F
from gimmvfi_tpu_torch.models.gimmvfi_r import interpolate_sequential
from gimmvfi_tpu_torch.nn.layers import init_normal_
from gimmvfi_tpu_torch.ops import corr as tcorr
from gimmvfi_tpu_torch.utils.convert import jax_gimmvfi_f_params_to_torch, load_jax_params

torch.set_num_threads(1)
T_VALUES = [0.25, 0.5, 0.75]


@pytest.fixture(scope="module")
def setup():
    img = np.random.default_rng(0).random((1, 2, 128, 192, 3), dtype=np.float32)
    model = JaxGIMMVFI_F(ff_iters=2, remat=False)
    init = jax.jit(lambda r, x: model.init(r, x, (0.5,)))(jax.random.PRNGKey(0), jnp.asarray(img))
    return img, {k: jax.tree_util.tree_map(np.asarray, v) for k, v in init.items()}


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


def _run_both(setup, jax_dtype, torch_dtype, limit=tcorr.MAX_VOLUME_BYTES):
    img, variables = setup
    jm = JaxGIMMVFI_F(ff_iters=2, remat=False, dtype=jax_dtype, corr_max_volume_bytes=limit)
    ref = jax.jit(lambda v, x: jax_interpolate_sequential(jm, v, x, jnp.asarray(T_VALUES)))(
        variables, jnp.asarray(img))
    model = load_jax_params(
        GIMMVFI_F(ff_iters=2, dtype=torch_dtype, device="cpu", corr_max_volume_bytes=limit),
        variables["params"], variables["batch_stats"])
    got = interpolate_sequential(model, torch.from_numpy(img), T_VALUES)
    ref = {k: np.asarray(v).astype(np.float32) for k, v in ref.items()}
    got = {k: v.float().numpy() for k, v in got.items()}
    return got, ref


def _psnr(a, b):
    mse = float(((a - b) ** 2).mean())
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


@pytest.mark.parametrize("limit", [tcorr.MAX_VOLUME_BYTES, 0])
def test_interpolate_sequential_f32_matches_jax(setup, windowed_calls, limit, record_property):
    got, ref = _run_both(setup, None, None, limit)
    assert got["imgt_pred"].shape == ref["imgt_pred"].shape == (3, 1, 128, 192, 3)
    assert got["flowt"].shape == ref["flowt"].shape == (3, 1, 128, 192, 2)
    # the AMT's two directions at each timestep, windowed only under limit 0
    assert windowed_calls == ([(1, 2, 16, 24)] * 2 * len(T_VALUES) if limit == 0 else [])
    db = _psnr(got["imgt_pred"], ref["imgt_pred"])
    flow_err = float(np.abs(got["flowt"] - ref["flowt"]).max())
    record_property("imgt_pred_psnr_db", db)
    record_property("flowt_max_abs_err", flow_err)
    assert db >= 60.0
    assert flow_err <= 1e-4 * max(1.0, float(np.abs(ref["flowt"]).max()))


def test_interpolate_sequential_bf16_runs_and_agrees(setup, record_property):
    got, ref = _run_both(setup, jnp.bfloat16, torch.bfloat16)
    assert np.isfinite(got["imgt_pred"]).all() and np.isfinite(got["flowt"]).all()
    db = _psnr(got["imgt_pred"], ref["imgt_pred"])
    record_property("imgt_pred_psnr_db", db)  # the bf16 delta against JAX (ROADMAP C3)
    assert db >= 45.0


def test_flowformer_is_float32_in_a_bf16_model(setup):
    """FlowFormer has no compute dtype: its feature map, and so the AMT
    pyramid built on it, stay float32 in a bf16 GIMMVFI_F."""
    img, variables = setup
    model = load_jax_params(GIMMVFI_F(ff_iters=1, dtype=torch.bfloat16, device="cpu",
                                      corr_max_volume_bytes=0),
                            variables["params"], variables["batch_stats"])
    with torch.inference_mode():
        prep = model.prepare(torch.from_numpy(img))
    fwd, bwd = prep["corr_pyrs"]
    assert isinstance(fwd, tcorr.WindowedCorr) and fwd.f1.dtype == bwd.f1.dtype == torch.float32
    assert prep["flow01"].dtype == torch.float32
    assert not any(n.startswith("amt_") and "proj" in n for n, _ in model.named_parameters())


def test_converter_round_trip_consumes_every_key(setup, monkeypatch):
    _, variables = setup
    trees = []

    class Recording(jax_convert._Tree):
        """The JAX converter's key accumulator, kept for `unused_keys`."""

        def __init__(self, state):
            super().__init__(state)
            trees.append(self)

    monkeypatch.setattr(jax_convert, "_Tree", Recording)
    model = init_normal_(GIMMVFI_F(ff_iters=2, device="cpu"), seed=3)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats = jax_convert.convert_gimmvfi_f(sd)
    assert jax_convert.unused_keys(sd, trees[0]) == []
    for mine, ref in ((params, variables["params"]), (stats, variables["batch_stats"])):
        got_leaves, got_def = jax.tree_util.tree_flatten(mine)
        ref_leaves, ref_def = jax.tree_util.tree_flatten(ref)
        assert got_def == ref_def  # no leaf missing, none extra
        assert [x.shape for x in got_leaves] == [x.shape for x in ref_leaves]
    back_p, back_s = jax_convert.convert_gimmvfi_f(
        jax_gimmvfi_f_params_to_torch(variables["params"], variables["batch_stats"]))
    for a, b in ((back_p, variables["params"]), (back_s, variables["batch_stats"])):
        fa, ta = jax.tree_util.tree_flatten(a)
        fb, tb = jax.tree_util.tree_flatten(b)
        assert ta == tb
        assert all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(fa, fb))


def test_gimmvfi_f_defaults_to_the_card():
    if torch.cuda.is_available():
        assert all(p.is_cuda for p in GIMMVFI_F(ff_iters=1).parameters())
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            GIMMVFI_F(ff_iters=1)
    assert all(p.device.type == "cpu" for p in GIMMVFI_F(ff_iters=1, device="cpu").parameters())
