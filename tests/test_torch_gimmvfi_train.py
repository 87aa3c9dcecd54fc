"""Stage-2 GIMM-VFI-R training of the port against the JAX package, on the CPU.

GIMMVFI_R(raft_iters=2) at 128x128, batch 2, t = (1/3, 2/3) a sample, with
the weights of one JAX `model.init` (BatchNorm statistics included)
through `load_jax_params`, on one seeded batch:
  * `train_forward` in train mode against JAX's with `mutable=["batch_stats"]`:
    imgt_pred and img_warp_4 >= 60 dB, flows and the INR flows <= 1e-4
    relative, the moved BatchNorm running statistics <= 1e-5 x max(1,
    max|ref|) (what catches an unbiased running variance);
  * one `make_gimmvfi_train_step` against JAX's, with a seeded LPIPS in
    both: the loss and each term <= 1e-5 relative; the running statistics
    after the step <= 1e-5 x max(1, max|ref|); the parameters after one SGD
    update <= 1e-6 max-abs and the EMA after it; each gradient tensor, in
    relative L2 norm, within 4x of JAX's own float32 noise in that tensor:
    the gap between JAX's gradient and JAX's for the same step with the
    batch's two samples swapped, equal in exact arithmetic (ROADMAP C3: the
    1e-4 x max|g| of stage 1 misses here, and JAX misses it against itself
    by as much, since batch statistics and near-cancelling sums amplify
    float32 rounding), but `alpha_v` / `alpha_fe`,
    near-cancelling sums over pixels, within 1e-4 x the sum of their terms'
    magnitudes (`alpha_fields`), and the biases of convs that feed a
    normalization, zero in exact arithmetic, within 1e-2 x max|g| of their
    weights on both sides.
The `world2` case runs the port's step data-parallel on two gloo ranks at
batch 1 each (`parallel/dist.py: spawn_ranks`; BatchNorm's statistics
all-reduced across them, the gradients averaged) against the same JAX step
at batch 2, under the same bounds (the running statistics' is what catches
statistics taken per rank); the alphas' terms are the ranks' fields, and
the two ranks' parameters, buffers and EMA must be bitwise equal.
The port's model trains with remat (its default, as JAX's), so these hold
the port with remat against JAX without it; `test_remat_train_forward_matches_jax`
holds it against JAX with remat (`JaxGIMMVFI_R(remat=True)` on the same
init): `train_forward` in train mode, the moved running statistics and the
loss terms (no perceptual loss) under the bounds above. The steps' running
statistics are read after the backward, in which the port's remat units
recompute: moved once, as JAX's; the world2 case's ranks recompute with
the group up (BatchNorm's sums all-reduced again in the backward).
The eval step and `interpolate` after a step are in
`test_torch_gimmvfi_eval.py`. One JAX init for the file, in a module fixture.
"""

import contextlib
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gimmvfi_tpu.models.gimmvfi_r import GIMMVFI_R as JaxGIMMVFI_R
from gimmvfi_tpu.train import create_optimizer as jax_create_optimizer
from gimmvfi_tpu.train import create_train_state as jax_create_train_state
from gimmvfi_tpu.train import losses as jax_losses
from gimmvfi_tpu.train.lpips import LPIPS as JaxLPIPS
from gimmvfi_tpu.train.train_state import make_gimmvfi_train_step as jax_make_train_step
from gimmvfi_tpu.utils.convert import convert_lpips
from gimmvfi_tpu_torch.models import gimmvfi_r as gimmvfi_r_module
from gimmvfi_tpu_torch.models.gimmvfi_r import GIMMVFI_R
from gimmvfi_tpu_torch.parallel import dist as dist_ops
from gimmvfi_tpu_torch.train import losses as port_losses
from gimmvfi_tpu_torch.train.lpips import LPIPS
from gimmvfi_tpu_torch.train.optim import create_optimizer
from gimmvfi_tpu_torch.train.train_state import (
    _flow_rec_loss,
    create_train_state,
    make_gimmvfi_train_step,
)
from gimmvfi_tpu_torch.utils.convert import jax_params_to_torch, load_jax_params

torch.set_num_threads(1)
N, HW = 2, 128
K = int(HW * HW * 0.1)
SGD_LR = 1e-3
REC_WEIGHT = 0.1
TERMS = ("loss_total", "lap", "census", "l1", "rec", "lpips", "psnr")
NOISE_FACTOR = 4.0  # the largest gap / noise read is 1.85 (ROADMAP C3)


def _batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"img0": rng.random((N, HW, HW, 3), dtype=np.float32),
            "img1": rng.random((N, HW, HW, 3), dtype=np.float32),
            "gt": rng.random((N, HW, HW, 3), dtype=np.float32),
            "t": np.asarray([1 / 3, 2 / 3], np.float32),
            "sub_idx0": np.stack([rng.permutation(HW * HW)[:K] for _ in range(N)]).astype(np.int32),
            "sub_idx1": np.stack([rng.permutation(HW * HW)[:K] for _ in range(N)]).astype(np.int32)}


def _keep_grads():
    """A pass-through optax transform whose state is the last gradient."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))


@pytest.fixture(scope="module")
def setup():
    model = JaxGIMMVFI_R(raft_iters=2, remat=False)
    variables = jax.jit(lambda r, x: model.init(r, x, (0.5,)))(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, HW, HW, 3), jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    torch.manual_seed(5)
    lpips = LPIPS(device="cpu").requires_grad_(False)
    lp_params, _ = convert_lpips({k: v.numpy() for k, v in lpips.state_dict().items()})
    return model, params, stats, lpips, lp_params


def _port(setup) -> GIMMVFI_R:
    _, params, stats, _, _ = setup
    return load_jax_params(GIMMVFI_R(raft_iters=2, device="cpu"), params, stats)


def _img_xs(batch):
    return np.stack([batch["img0"], batch["img1"]], axis=1)


def _psnr(a, b):
    mse = float(((np.asarray(a) - np.asarray(b)) ** 2).mean())
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def _close_rel(got, ref, rel, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    bound = rel * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= bound, (what, err, bound)


ALPHAS = ("alpha_v", "alpha_fe")  # the splat weights' scalar parameters
# the biases of the convs that feed a normalization: RAFT's encoders (instance
# norm in fnet, batch statistics in cnet) and the decoder heads' 1x1 projection
PRE_NORM_BIAS = re.compile(r"flow_estimator\.(fnet|cnet)\.(conv1|layer\d\.\d\.(conv1|conv2|downsample\.0))"
                           r"\.bias|amt_init_decoder\.upsample\.6\.bias|amt_final_decoder\.upsample\.7\.bias")


@contextlib.contextmanager
def alpha_fields():
    """Records, for the step run inside, the fields whose contraction is
    the gradient of each of `ALPHAS`: u = dL/d(w1, w2), the gradient that
    reaches the splat weights, and c = d(w1, w2)/d alpha pixel by pixel
    (forward mode); flattened to float64 (ROADMAP C3)."""
    weights_fn, fields, seen = gimmvfi_r_module.splatting_weights, {}, []

    def spy(flow01, flow10, alpha_v, alpha_fe):
        w1, w2 = weights_fn(flow01, flow10, alpha_v, alpha_fe)
        w1.retain_grad()
        w2.retain_grad()
        seen.append((w1, w2))
        f01, f10, a_v, a_fe = (x.detach() for x in (flow01, flow10, alpha_v, alpha_fe))
        one = torch.ones_like(a_v)
        fields["alpha_v"] = torch.func.jvp(lambda a: weights_fn(f01, f10, a, a_fe), (a_v,), (one,))[1]
        fields["alpha_fe"] = torch.func.jvp(lambda a: weights_fn(f01, f10, a_v, a), (a_fe,), (one,))[1]
        return w1, w2

    gimmvfi_r_module.splatting_weights = spy
    flat = {}
    try:
        yield flat
    finally:
        gimmvfi_r_module.splatting_weights = weights_fn
    (w1, w2), = seen
    cat = lambda pair: torch.cat([x.detach().reshape(-1) for x in pair]).double()
    flat.update({"u": cat((w1.grad, w2.grad)), **{k: cat(v) for k, v in fields.items()}})


def _rel_l2(got, ref) -> float:
    return float((got - ref).double().norm() / ref.double().norm())


def _swapped(batch: dict) -> dict:
    """The batch with its two samples swapped: the same step in exact arithmetic."""
    return {k: v[::-1].copy() for k, v in batch.items()}


def _running_stats(sd):
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


def test_train_forward_matches_jax(setup):
    model, params, stats, _, _ = setup
    b = _batch(1)
    fwd = jax.jit(lambda v, x, t, s0, s1: model.apply(
        v, x, t, s0, s1, method=model.train_forward, mutable=["batch_stats"]))
    ref, mut = fwd({"params": params, "batch_stats": stats}, _img_xs(b), b["t"],
                   b["sub_idx0"], b["sub_idx1"])
    m = _port(setup)
    before = {k: v.clone() for k, v in _running_stats(m.state_dict()).items()}
    out = m.train_forward(torch.from_numpy(_img_xs(b)), torch.from_numpy(b["t"]),
                          torch.from_numpy(b["sub_idx0"]), torch.from_numpy(b["sub_idx1"]))
    out = {k: ([x.detach().numpy() for x in v] if isinstance(v, list) else v.detach().numpy())
           for k, v in out.items()}
    assert out["imgt_pred"].shape == (N, HW, HW, 3) and out["ninrflow"][0].shape == (N, K, 2)
    for k in ("imgt_pred", "img_warp_4"):
        assert _psnr(out[k], ref[k]) >= 60.0, k
    for k in ("raft_flow", "nflow", "flowt"):
        _close_rel(out[k], ref[k], 1e-4, k)
    for i in range(2):
        _close_rel(out["ninrflow"][i], ref["ninrflow"][i], 1e-4, f"ninrflow[{i}]")

    ref_stats = _running_stats(jax_params_to_torch(params, mut["batch_stats"]))
    got_stats = _running_stats(m.state_dict())
    assert sorted(got_stats) == sorted(ref_stats) and len(got_stats) > 0
    for k, v in got_stats.items():
        _close_rel(v.numpy(), ref_stats[k].numpy(), 1e-5, k)
    assert all(not torch.equal(v, before[k]) for k, v in got_stats.items())


def _loss_terms(L, out, gt, rec):
    """The stage-2 step's loss terms but the perceptual one, from package
    `L`'s losses (the JAX package's or the port's) on `train_forward`'s
    outputs; `rec`, the flow-reconstruction term, as that package's step
    computes it."""
    pred, aux = out["imgt_pred"], out["img_warp_4"]
    terms = {name: fn(pred, gt) + 0.5 * fn(aux, gt) for name, fn in (
        ("lap", L.lap_loss), ("census", L.census_loss), ("l1", L.charbonnier_l1))}
    terms["rec"] = rec
    terms["loss_total"] = terms["census"] + terms["l1"] + REC_WEIGHT * rec + terms["lap"]
    terms["psnr"] = L.psnr(pred, gt)
    return terms


def test_remat_train_forward_matches_jax(setup):
    _, params, stats, _, _ = setup
    model = JaxGIMMVFI_R(raft_iters=2, remat=True)
    b = _batch(3)

    def fwd(v, x, gt, t, s0, s1):
        out, mut = model.apply(v, x, t, s0, s1, method=model.train_forward,
                               mutable=["batch_stats"])
        nflow = out["nflow"]

        def sub_target(i, idx):
            return jnp.take_along_axis(nflow[:, i].reshape(N, -1, 2), idx[..., None], axis=1)

        inr0, inr1 = out["ninrflow"]
        rec = (0.5 * jnp.mean((inr0 - sub_target(0, s0)) ** 2)
               + 0.5 * jnp.mean((inr1 - sub_target(1, s1)) ** 2))
        return out, mut, _loss_terms(jax_losses, out, gt, rec)

    ref, mut, ref_terms = jax.jit(fwd)({"params": params, "batch_stats": stats}, _img_xs(b),
                                       b["gt"], b["t"], b["sub_idx0"], b["sub_idx1"])
    m = load_jax_params(GIMMVFI_R(raft_iters=2, device="cpu", remat=True), params, stats)
    s0, s1 = torch.from_numpy(b["sub_idx0"]).long(), torch.from_numpy(b["sub_idx1"]).long()
    out = m.train_forward(torch.from_numpy(_img_xs(b)), torch.from_numpy(b["t"]), s0, s1)
    terms = _loss_terms(port_losses, out, torch.from_numpy(b["gt"]),
                        _flow_rec_loss(out, s0, s1))
    for k in ("lap", "census", "l1", "rec", "loss_total", "psnr"):
        got, want = float(terms[k].detach()), float(ref_terms[k])
        assert abs(got - want) <= 1e-5 * abs(want), (k, got, want)
    out = {k: ([x.detach().numpy() for x in v] if isinstance(v, list) else v.detach().numpy())
           for k, v in out.items()}
    for k in ("imgt_pred", "img_warp_4"):
        assert _psnr(out[k], ref[k]) >= 60.0, k
    for k in ("raft_flow", "nflow", "flowt"):
        _close_rel(out[k], ref[k], 1e-4, k)
    for i in range(2):
        _close_rel(out["ninrflow"][i], ref["ninrflow"][i], 1e-4, f"ninrflow[{i}]")
    ref_stats = _running_stats(jax_params_to_torch(params, mut["batch_stats"]))
    got_stats = _running_stats(m.state_dict())
    assert sorted(got_stats) == sorted(ref_stats) and len(got_stats) > 0
    for k, v in got_stats.items():
        _close_rel(v.numpy(), ref_stats[k].numpy(), 1e-5, k)


@pytest.fixture(scope="module")
def jax_step(setup):
    """One jitted JAX stage-2 step: SGD after the gradient-keeping pass,
    EMA on, the seeded LPIPS in the loss; and the gradients of the same
    step on the swapped batch, which differ from its own by JAX's float32
    rounding alone."""
    model, params, stats, _, lp_params = setup
    lp_model = JaxLPIPS()

    def lpips_fn(pred, gt):
        return lp_model.apply({"params": lp_params}, pred, gt, normalize=True)

    tx = optax.chain(_keep_grads(), jax_create_optimizer(
        params, opt_type="sgd", init_lr=SGD_LR, weight_decay=0.0, ft=False))
    step = jax.jit(jax_make_train_step(model, tx, rec_weight=REC_WEIGHT, lpips_fn=lpips_fn,
                                       use_ema=True))
    state = jax_create_train_state({"params": params, "batch_stats": stats}, tx, use_ema=True)
    batch = _batch(2)
    new_state, metrics = step(state, batch)
    swapped_state, _ = step(state, _swapped(batch))
    return batch, jax.tree_util.tree_map(np.asarray, (new_state, metrics, swapped_state.opt_state[0]))


def _lpips_fn(lpips):
    def lpips_fn(pred, gt):
        return lpips(pred.permute(0, 3, 1, 2), gt.permute(0, 3, 1, 2), normalize=True)

    return lpips_fn


def _step_readings(m, lpips, batch):
    """One port step of `m` on `batch` (SGD, EMA, the LPIPS): its metrics,
    gradients, state dict and EMA after it, and the alphas' terms u x c."""
    opt, sched = create_optimizer(m, "sgd", init_lr=SGD_LR, weight_decay=0.0, ft=False)
    state = create_train_state(m, opt, sched, use_ema=True)
    with alpha_fields() as fields:
        got = make_gimmvfi_train_step(REC_WEIGHT, _lpips_fn(lpips), use_ema=True)(state, batch)
    assert state.step == 1 and sched.count == 1
    return {"metrics": {k: float(v) for k, v in got.items()},
            "grads": {n: p.grad for n, p in m.named_parameters()},
            "state": {k: v.detach().clone() for k, v in m.state_dict().items()},
            "ema": state.ema, "terms": {a: fields["u"] * fields[a] for a in ALPHAS}}


def _dp_step_rank(weights, lpips_weights, batch, out_dir):
    """One rank of the data-parallel stage-2 step: its row of `batch`."""
    torch.set_num_threads(1)
    r = dist_ops.rank()
    m = GIMMVFI_R(raft_iters=2, device="cpu")
    m.load_state_dict(weights, strict=True)
    lpips = LPIPS(device="cpu").requires_grad_(False)
    lpips.load_state_dict(lpips_weights, strict=True)
    res = _step_readings(m, lpips, {k: v[r:r + 1] for k, v in batch.items()})
    torch.save(res, os.path.join(out_dir, f"rank{r}.pt"))


def _dp_step(m, lpips, batch, out_dir, world):
    """The step on `world` gloo ranks: rank 0's readings, with the alphas'
    terms of every rank (the averaged gradient is their sum / world)."""
    dist_ops.spawn_ranks(_dp_step_rank, world, (m.state_dict(), lpips.state_dict(), batch,
                                                str(out_dir)),
                         rendezvous=str(out_dir / "rendezvous"))
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=True) for r in range(world)]
    for other in ranks[1:]:
        for key in ("state", "ema"):
            for name, v in other[key].items():
                assert torch.equal(v, ranks[0][key][name]), (key, name)
    res = ranks[0]
    res["terms"] = {a: torch.cat([r["terms"][a] for r in ranks]) / world for a in ALPHAS}
    return res


def test_train_step_matches_jax(setup, jax_step, tmp_path):
    _check_step(setup, jax_step, 1, tmp_path)


def test_train_step_matches_jax_world2(setup, jax_step, tmp_path):
    _check_step(setup, jax_step, 2, tmp_path)


def _check_step(setup, jax_step, world, tmp_path):
    """The port's step, on one process or `world` gloo ranks, against JAX's."""
    _, params, stats, lpips, _ = setup
    batch, (new_state, ref, swapped_grads) = jax_step
    m = _port(setup)
    res = (_step_readings(m, lpips, batch) if world == 1
           else _dp_step(m, lpips, batch, tmp_path, world))
    got, grads = res["metrics"], res["grads"]
    for k in TERMS:
        assert abs(float(got[k]) - float(ref[k])) <= 1e-5 * abs(float(ref[k])), (k, got[k], ref[k])
    assert float(ref["lpips"]) != 0

    ref_grads = jax_params_to_torch(new_state.opt_state[0], new_state.batch_stats)
    noise_grads = jax_params_to_torch(swapped_grads, new_state.batch_stats)
    ref_sd = jax_params_to_torch(new_state.params, new_state.batch_stats)
    ref_ema = jax_params_to_torch(new_state.ema["params"], new_state.ema["batch_stats"])
    within, worst = 0, (0.0, None, 0.0)
    for name, g in grads.items():
        g_ref = ref_grads[name]
        within += float((g - g_ref).abs().max()) <= 1e-4 * float(g_ref.abs().max())
        if name in ALPHAS:
            # a near-cancelling sum over pixels: held relative to its terms
            terms = res["terms"][name]
            s_abs = float(terms.abs().sum())
            own = abs(float(g) - float(terms.sum()))
            assert own <= (np.log2(terms.numel()) + 4) * 2**-24 * s_abs, (name, own, s_abs)
            assert float((g - g_ref).abs().max()) <= 1e-4 * s_abs, (name, s_abs)
        elif PRE_NORM_BIAS.fullmatch(name):
            # zero in exact arithmetic: the normalization after the conv
            # removes any per-channel constant
            w_scale = float(ref_grads[name[:-len("bias")] + "weight"].abs().max())
            for gg in (g, g_ref):
                assert float(gg.abs().max()) <= 1e-2 * w_scale, (name, w_scale)
        else:
            gap, noise = _rel_l2(g, g_ref), _rel_l2(noise_grads[name], g_ref)
            assert gap <= NOISE_FACTOR * noise, (name, gap, noise)
            worst = max(worst, (gap / noise, name, gap))
        assert float((res["state"][name] - ref_sd[name]).abs().max()) <= 1e-6, name
    # the readings ROADMAP C3 quotes (pytest -s shows them)
    print(f"stage-2 step vs JAX ({world} rank(s)): {within} of {len(grads)} gradient tensors within "
          f"1e-4 x max|g|; largest relative L2 gap / JAX's noise {worst[0]:.3f} ({worst[1]}, "
          f"gap {worst[2]:.3e}); loss terms "
          f"{max(abs(float(got[k]) - float(ref[k])) / abs(float(ref[k])) for k in TERMS):.2e}")
    assert any(float(g.abs().max()) > 0 for n, g in grads.items() if n.startswith("amt_"))
    assert any(float(g.abs().max()) > 0 for n, g in grads.items()
               if n.startswith("flow_estimator.cnet"))
    for k, v in _running_stats(res["state"]).items():
        _close_rel(v.numpy(), ref_sd[k].numpy(), 1e-5, k)
    for k, v in res["ema"].items():
        assert float((v - ref_ema[k]).abs().max()) <= 1e-5 * max(1.0, float(ref_ema[k].abs().max())), k
