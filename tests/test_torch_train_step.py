"""Stage-1 training pieces of the port against the JAX package, on the CPU.

  * `make_gimm_train_step` against the JAX step from one JAX `GIMM()` init
    at 32x32, batch 2, on the same batch: the loss (<= 1e-6 relative), each
    parameter's gradient (<= 1e-4 x max|g_jax| of that tensor; the JAX step
    exposes it through a pass-through transform that keeps it as its
    state), the parameters after one SGD update (<= 1e-6 max-abs) and the
    EMA after it. Adam's first update is about lr x sign(g), which turns
    rounding noise in a near-zero gradient into 2 lr, so updates are
    compared under SGD only (ROADMAP C3). The `world2` case runs the port's
    step data-parallel on two gloo ranks at batch 1 each (`parallel/dist.py:
    spawn_ranks`) against the same JAX step at batch 2, under the same
    bounds, and the two ranks' parameters and EMA must be bitwise equal;
    the `remat` case runs `GIMM(remat=True)` (the train CLI's) against the
    JAX step of `GIMM(remat=True)` (JAX's CLI's) on `t_id0`'s batch, under
    the same bounds (ROADMAP C3 says why a batch whose pre-activation sits
    on a leaky kink misses them, with remat or without);
  * `create_optimizer` (adam, adamw, sgd; with and without the `ft` groups
    and clipping) against optax over 3 updates on fixed gradients;
  * `warmup_cosine_schedule` at every step of the JAX tests' schedule and
    of three more; the EMA against `ema_update`;
  * the loader's batches against the JAX `DataLoader`'s, on a toy dataset
    and on fabricated `.flo` triplets, byte for byte;
  * `load_config` on each of `configs/*/*.yaml` against the JAX
    `load_config`, and `save_config` read back;
  * a checkpoint's round trip and `merge_partial`.
"""

import dataclasses
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gimmvfi_tpu.data.flow_dataset import VimeoFlowTriplets as JaxVimeoFlowTriplets
from gimmvfi_tpu.data.loader import DataLoader as JaxDataLoader
from gimmvfi_tpu.models.gimm import GIMM as JaxGIMM
from gimmvfi_tpu.train import create_optimizer as jax_create_optimizer
from gimmvfi_tpu.train import create_train_state as jax_create_train_state
from gimmvfi_tpu.train import make_gimm_train_step as jax_make_gimm_train_step
from gimmvfi_tpu.train.ema import ema_update as jax_ema_update
from gimmvfi_tpu.train.optim import warmup_cosine_schedule as jax_warmup_cosine_schedule
from gimmvfi_tpu.utils.config import load_config as jax_load_config
from gimmvfi_tpu_torch.data import DataLoader, VimeoArbitrary, VimeoFlowTriplets, create_dataset
from gimmvfi_tpu_torch.data.frame_io import write_flo
from gimmvfi_tpu_torch.models.gimm import GIMM
from gimmvfi_tpu_torch.parallel import dist as dist_ops
from gimmvfi_tpu_torch.train.checkpoint import (
    checkpoint_steps,
    merge_partial,
    restore_checkpoint,
    save_checkpoint,
)
from gimmvfi_tpu_torch.train.ema import ema_init, ema_update
from gimmvfi_tpu_torch.train.optim import create_optimizer, warmup_cosine_schedule
from gimmvfi_tpu_torch.train.train_state import (
    create_train_state,
    make_gimm_eval_step,
    make_gimm_train_step,
)
from gimmvfi_tpu_torch.utils import config as tconfig
from gimmvfi_tpu_torch.utils.convert import jax_gimm_params_to_torch

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
N, HW = 2, 32
SGD_LR = 1e-3


def _batch(seed, t_id):
    rng = np.random.default_rng(seed)
    ori = (rng.standard_normal((N, 2, HW, HW, 2)) * 3).astype(np.float32)
    return {"xs": rng.random((N, 3, HW, HW, 2), dtype=np.float32),
            "ori_flows": ori, "t_id": np.asarray(t_id, np.int32)}


def _keep_grads():
    """A pass-through optax transform whose state is the last gradient."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))


@pytest.fixture(scope="module")
def jax_init():
    xs = jnp.zeros((N, 2, HW, HW, 2), jnp.float32)
    variables = jax.jit(lambda r: JaxGIMM().init(r, xs, xs, jnp.zeros((N,), jnp.float32)))(
        jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, variables["params"])


@pytest.fixture(scope="module")
def jax_step(jax_init):
    """One jitted JAX stage-1 step of `JaxGIMM(remat=remat)`: SGD after the
    gradient-keeping pass, with the EMA on."""
    tx = optax.chain(_keep_grads(), jax_create_optimizer(
        jax_init, opt_type="sgd", init_lr=SGD_LR, weight_decay=0.0, ft=False))
    steps = {}

    def run(batch, remat=False):
        if remat not in steps:
            steps[remat] = jax.jit(jax_make_gimm_train_step(JaxGIMM(remat=remat), tx,
                                                            use_ema=True))
        state = jax_create_train_state({"params": jax_init}, tx, use_ema=True)
        new_state, metrics = steps[remat](state, batch)
        return jax.tree_util.tree_map(np.asarray, (new_state, metrics))

    return run


def _dp_step_rank(weights, batch, out_dir):
    """One rank of the data-parallel stage-1 step: its row of `batch`."""
    torch.set_num_threads(1)
    r = dist_ops.rank()
    model = GIMM(device="cpu")
    model.load_state_dict(weights, strict=True)
    opt, sched = create_optimizer(model, "sgd", init_lr=SGD_LR, weight_decay=0.0, ft=False)
    state = create_train_state(model, opt, sched, use_ema=True)
    got = make_gimm_train_step(use_ema=True)(state, {k: v[r:r + 1] for k, v in batch.items()})
    torch.save({"metrics": {k: float(v) for k, v in got.items()}, "step": state.step,
                "count": sched.count, "grads": {n: p.grad for n, p in model.named_parameters()},
                "params": {n: p.detach() for n, p in model.named_parameters()},
                "ema": state.ema}, os.path.join(out_dir, f"rank{r}.pt"))


def _dp_step(weights, batch, out_dir, world):
    dist_ops.spawn_ranks(_dp_step_rank, world, (weights, batch, str(out_dir)),
                         rendezvous=str(out_dir / "rendezvous"))
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=True) for r in range(world)]
    for other in ranks[1:]:
        for key in ("params", "ema"):
            for name, v in other[key].items():
                assert torch.equal(v, ranks[0][key][name]), (key, name)
    return ranks[0]


@pytest.mark.parametrize("t_id,world,remat", [pytest.param([0, 2], 1, False, id="t_id0"),
                                              pytest.param([1, 1], 1, False, id="t_id1"),
                                              pytest.param([0, 2], 2, False, id="world2"),
                                              pytest.param([0, 2], 1, True, id="remat")])
def test_train_step_matches_jax(jax_init, jax_step, t_id, world, remat, tmp_path):
    batch = _batch(sum(t_id), t_id)
    new_state, ref = jax_step(batch, remat)
    weights = jax_gimm_params_to_torch(jax_init)
    if world == 1:
        model = GIMM(device="cpu", remat=remat)
        model.load_state_dict(weights, strict=True)
        opt, sched = create_optimizer(model, "sgd", init_lr=SGD_LR, weight_decay=0.0, ft=False)
        state = create_train_state(model, opt, sched, use_ema=True)
        got = make_gimm_train_step(use_ema=True)(state, batch)
        assert state.step == 1 and sched.count == 1
        params = dict(model.named_parameters())
        grads = {n: p.grad for n, p in params.items()}
        params = {n: p.detach() for n, p in params.items()}
        ema = state.ema
    else:
        res = _dp_step(weights, batch, tmp_path, world)
        assert res["step"] == 1 and res["count"] == 1
        got, grads, params, ema = res["metrics"], res["grads"], res["params"], res["ema"]

    for k in ("loss_total", "mse", "psnr"):
        assert abs(float(got[k]) - float(ref[k])) <= 1e-6 * abs(float(ref[k])), k
    ref_grads = jax_gimm_params_to_torch(new_state.opt_state[0])
    ref_params = jax_gimm_params_to_torch(new_state.params)
    ref_ema = jax_gimm_params_to_torch(new_state.ema["params"])
    assert sorted(ref_grads) == sorted(params)
    for name, p in params.items():
        g_ref = ref_grads[name]
        scale = float(g_ref.abs().max())
        assert float((grads[name] - g_ref).abs().max()) <= 1e-4 * scale, name
        assert float((p - ref_params[name]).abs().max()) <= 1e-6, name
        assert float((ema[name] - ref_ema[name]).abs().max()) <= 1e-6, name
    assert any(float(g.abs().max()) > 0 for g in grads.values())


def test_eval_step_on_the_mid_flow():
    """Validation decodes t = 0.5 and scores it against xs[:, 1]."""
    torch.manual_seed(0)
    model = GIMM(device="cpu")
    batch = _batch(3, [0, 0])
    got = make_gimm_eval_step()(model, batch)
    with torch.no_grad():
        pred = model(torch.from_numpy(batch["xs"][:, [0, 2]]),
                     torch.from_numpy(batch["ori_flows"]), torch.full((N,), 0.5))
    mse = ((pred - torch.from_numpy(batch["xs"][:, 1:2])) ** 2).reshape(N, -1).mean(-1)
    assert torch.allclose(got["mse"], mse.mean())
    assert torch.allclose(got["psnr"], (-10 * torch.log10(mse)).mean())


def test_fresh_hyponet_has_the_siren_init(jax_init):
    """A fresh GIMM's HypoNet starts as JAX's does: each layer's weights and
    bias row uniform within the SIREN bounds (it was all zeros)."""
    torch.manual_seed(0)
    ours = GIMM(device="cpu").hyponet.params_dict
    for i in range(5):
        name = f"linear_wb{i}"
        theirs = np.asarray(jax_init["hyponet"][name])
        assert tuple(ours[name].shape) == theirs.shape
        for wb in (ours[name].detach().numpy(), theirs):
            fan_in = wb.shape[0] - 1
            bound_w = 1.0 / fan_in if i == 0 else (6.0 / fan_in) ** 0.5
            bound_b = 1.0 if i == 0 else 6.0 ** 0.5
            for part, bound in ((wb[:-1], bound_w), (wb[-1], bound_b)):
                # a part of 64 or more draws reaches 0.7 of its bound
                floor = 0.7 * bound if part.size >= 64 else 0.0
                assert floor < float(np.abs(part).max()) <= bound, (name, bound)


class _Toy(torch.nn.Module):
    def __init__(self, rng):
        super().__init__()
        self.amt_head = torch.nn.Linear(3, 4)
        self.enc = torch.nn.Linear(5, 2)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32)))

    def tree(self):
        return {m: {k: jnp.asarray(v.detach().numpy()) for k, v in getattr(self, m).named_parameters()}
                for m in ("amt_head", "enc")}


@pytest.mark.parametrize("clip", [None, 0.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("ft", [False, True], ids=["one_group", "ft"])
@pytest.mark.parametrize("opt_type", ["adam", "adamw", "sgd"])
def test_create_optimizer_matches_optax(opt_type, ft, clip):
    rng = np.random.default_rng(0)
    model = _Toy(rng)
    params = model.tree()
    kw = dict(opt_type=opt_type, init_lr=1e-2, weight_decay=0.05, betas=(0.8, 0.99), ft=ft,
              max_grad_norm=clip)
    tx = jax_create_optimizer(params, lr_schedule=jax_warmup_cosine_schedule(
        1e-2, 1e-3, 4, warmup_steps=1, start_from_zero=False, multiplier=2.0), **kw)
    opt, sched = create_optimizer(model, lr_schedule=warmup_cosine_schedule(
        1e-2, 1e-3, 4, warmup_steps=1, start_from_zero=False, multiplier=2.0), **kw)
    assert len(opt.param_groups) == (2 if ft else 1)
    opt_state = tx.init(params)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for m in ("amt_head", "enc"):
            for k, p in getattr(model, m).named_parameters():
                p.grad = torch.tensor(np.asarray(grads[m][k]))
        opt.step()
        for m in ("amt_head", "enc"):
            for k, p in getattr(model, m).named_parameters():
                np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[m][k]),
                                           rtol=0, atol=1e-6, err_msg=f"{m}.{k}")
    assert sched.count == 3


@pytest.mark.parametrize("kw", [
    dict(init_lr=1e-4, min_lr=1e-5, total_steps=100, warmup_steps=10, start_from_zero=True),
    dict(init_lr=1e-4, min_lr=1e-4, total_steps=50),
    dict(init_lr=2e-4, min_lr=1e-6, total_steps=60, warmup_steps=5, buffer_steps=7,
         multiplier=2.0, mode="linear", world_size=4, start_from_zero=False),
    dict(init_lr=1e-3, min_lr=0.0, total_steps=30, warmup_steps=3, multiplier=3.0, mode="sqrt",
         world_size=2),
])
def test_schedule_matches_jax(kw):
    """The port's schedule is float64, JAX's float32: they agree to
    1e-6 x init_lr x the multiplier at every step."""
    ref, got = jax_warmup_cosine_schedule(**kw), warmup_cosine_schedule(**kw)
    tol = 1e-6 * kw["init_lr"] * max(1.0, kw.get("multiplier", 1.0) * kw.get("world_size", 1))
    for s in range(kw["total_steps"] + 3):
        assert abs(got(s) - float(ref(s))) <= tol, s


@pytest.mark.parametrize("scheduled,mu_cap", [(True, 1.0), (True, 0.95), (False, 0.7)])
def test_ema_matches_jax(scheduled, mu_cap):
    """Values of order 1 in float32, summed in another order: <= 1e-6."""
    rng = np.random.default_rng(1)
    model = torch.nn.Linear(4, 3)
    ema = ema_init(model)
    ref = {k: jnp.asarray(v.numpy()) for k, v in ema.items()}
    for step in range(4):
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32)))
        cur = {k: jnp.asarray(v.detach().numpy()) for k, v in model.state_dict().items()}
        ref = jax_ema_update(ref, cur, step, mu_cap=mu_cap, scheduled=scheduled)
        ema_update(ema, model, step, mu_cap=mu_cap, scheduled=scheduled)
        for k in ema:
            np.testing.assert_allclose(ema[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-6)


class _ToyData:
    meta_data = list(range(23))

    def __len__(self):
        return len(self.meta_data)

    def __getitem__(self, args):
        i, rng = args
        return {"x": np.full((3,), self.meta_data[i], np.float32) + rng.random(3, np.float32),
                "k": rng.integers(0, 100, (2,))}


def _flow_tree(root, seqs, hw=(40, 52), seed=0):
    rng = np.random.default_rng(seed)
    for s in seqs:
        d = os.path.join(root, "flow_sequences", s)
        os.makedirs(d, exist_ok=True)
        for name in ("im1_im3", "im2_im3", "im2_im1", "im3_im1"):
            write_flo(os.path.join(d, f"{name}.flo"),
                      (rng.standard_normal((*hw, 2)) * 3).astype(np.float32))
    for listing in ("tri_trainlist.txt", "tri_testlist.txt"):
        with open(os.path.join(root, listing), "w") as f:
            f.write("\n".join(seqs) + "\n")


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


@pytest.mark.parametrize("shuffle,epoch", [(True, 0), (True, 3), (False, 1)])
def test_loader_batches_equal_jax(shuffle, epoch):
    kw = dict(batch_size=4, shuffle=shuffle, seed=5)
    ours, ref = DataLoader(_ToyData(), **kw), JaxDataLoader(_ToyData(), **kw)
    ours.set_epoch(epoch)
    ref.set_epoch(epoch)
    assert len(ours) == len(ref)
    _same_batches(ours, ref)


def test_flow_triplets_and_loader_equal_jax(tmp_path):
    seqs = [f"00001/{i:04d}" for i in range(6)]
    _flow_tree(str(tmp_path), seqs)
    trn, val = create_dataset("fast_vimeo_flow", str(tmp_path), crop_size=[32, 32])
    assert isinstance(trn, VimeoFlowTriplets) and trn.crop == 32 and len(val) == 6
    for split, ds in (("train", trn), ("test", val)):
        ref = JaxVimeoFlowTriplets(str(tmp_path), split=split, crop=32)
        for epoch in (0, 1):
            ours, theirs = DataLoader(ds, 2, seed=3), JaxDataLoader(ref, 2, seed=3)
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            _same_batches(ours, theirs)
    assert next(iter(DataLoader(trn, 2)))["xs"].shape == (2, 3, 32, 32, 2)
    # stage 2's dataset: the two splits (the test split drops its listing's
    # last line, as the reference's does)
    (tmp_path / "all_sep.txt").write_text("\n".join(seqs) + "\n")
    trn2, val2 = create_dataset("vimeo_arb", str(tmp_path))
    assert isinstance(trn2, VimeoArbitrary) and isinstance(val2, VimeoArbitrary)
    assert (trn2.split, len(trn2), val2.split, len(val2)) == ("train", 6, "test", 5)


CONFIGS = sorted(str(p.relative_to(REPO)) for p in REPO.glob("configs/*/*.yaml"))
OVERRIDES = ["dataset.crop_size=[64,64]", "experiment.batch_size=8", "optimizer.max_gn=1.5",
             "arch.ema=null", "dataset.path=/data/vimeo triplet", "optimizer.betas=[0.5, 0.9]",
             "experiment.seed=-3", "arch.hyponet.use_bias=false"]


@pytest.mark.parametrize("path", CONFIGS)
def test_load_config_matches_jax(path, tmp_path):
    ref = dataclasses.asdict(jax_load_config(str(REPO / path), OVERRIDES))
    got = tconfig.load_config(str(REPO / path), OVERRIDES)
    assert dataclasses.asdict(got) == ref
    tconfig.save_config(got, str(tmp_path / "config.yaml"))
    assert dataclasses.asdict(tconfig.load_config(str(tmp_path / "config.yaml"))) == ref


def test_checkpoint_round_trip_and_merge_partial(tmp_path):
    torch.manual_seed(0)
    model = GIMM(device="cpu")
    opt, sched = create_optimizer(model, "adam", init_lr=1e-3, weight_decay=0.0, ft=False)
    state = create_train_state(model, opt, sched, use_ema=True)
    step = make_gimm_train_step(use_ema=True)
    for s in range(4):
        step(state, _batch(10 + s, [s % 3, 2]))
        save_checkpoint(str(tmp_path), state.step, state)
    assert checkpoint_steps(str(tmp_path)) == [2, 3, 4]
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    saved_ema = {k: v.clone() for k, v in state.ema.items()}

    torch.manual_seed(1)
    fresh = GIMM(device="cpu")
    opt2, sched2 = create_optimizer(fresh, "adam", init_lr=1e-3, weight_decay=0.0, ft=False)
    state2 = create_train_state(fresh, opt2, sched2, use_ema=True)
    assert restore_checkpoint(str(tmp_path), state2) == 4 and sched2.count == 4
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, saved[k]) and torch.equal(state2.ema[k], saved_ema[k])
    # the restored optimizer continues as the original does
    step(state, _batch(20, [1, 1]))
    step(state2, _batch(20, [1, 1]))
    for (k, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k

    part = {"alpha_v": torch.full((1,), 3.0), "not_a_key": torch.zeros(2)}
    assert merge_partial(fresh, part) == ["alpha_v"]
    assert float(fresh.alpha_v.detach()) == 3.0
    with pytest.raises(ValueError, match="shape"):
        merge_partial(fresh, {"alpha_fe": torch.zeros(2)})


def test_image_grids_equal_jax_and_add_image(tmp_path):
    """`reconstruction_grid` and `flow_grid` equal the JAX package's on
    seeded inputs; `Writer.add_image` also writes the grid as a PPM that
    reads back as its 8-bit image, and `NullWriter.add_image` does nothing."""
    from gimmvfi_tpu.utils import writer as jax_writer
    from gimmvfi_tpu_torch.data.frame_io import read_ppm
    from gimmvfi_tpu_torch.utils import writer

    rng = np.random.default_rng(4)
    imgs = [rng.random((5, 12, 16, 3), dtype=np.float32) for _ in range(4)]
    flows = [(rng.standard_normal((5, 12, 16, 2)) * 3).astype(np.float32) for _ in range(2)]
    for kw in ({}, {"flow_t0": flows[0], "flow_t1": flows[1]}, {"flow_t0": flows[0]}):
        got = writer.reconstruction_grid(*imgs, **kw)
        assert np.array_equal(got, jax_writer.reconstruction_grid(*imgs, **kw))
    assert got.shape == (4 * 12, 5 * 16, 3)
    nflows = [rng.random((3, 12, 16, 2), dtype=np.float32) for _ in range(2)]
    assert np.array_equal(writer.flow_grid(*nflows), jax_writer.flow_grid(*nflows))

    w = writer.Writer(str(tmp_path))
    w.add_image("reconstruction", got, "valid", 3)
    w.close()
    back = read_ppm(str(tmp_path / "grids" / "valid_reconstruction_3.ppm"))
    assert np.array_equal(back, (np.clip(got, 0.0, 1.0) * 255).astype(np.uint8))
    writer.NullWriter().add_image("reconstruction", got, "valid", 3)
