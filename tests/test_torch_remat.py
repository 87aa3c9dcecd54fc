"""Activation recomputation (`remat`, JAX's `nn.remat`) in the port, on the CPU.

GIMM, GIMMVFI_R(raft_iters=2) and GIMMVFI_F(ff_iters=2), each built with
remat on and off from the same seeded weights:
  * JAX's defaults (False, True, True) and the same state-dict keys in
    both modes, so that a checkpoint loads into either;
  * inference bitwise equal (GIMM's `forward` under no_grad; R's and F's
    `interpolate` at 128x128);
  * one training step from the same weights and batch (SGD; stage 2 at
    128x128, batch 1, no perceptual loss): the loss and its terms, every
    gradient, and the parameters and BatchNorm running statistics after
    it, bitwise equal. The statistics after the remat step equal those
    after the plain one: a recompute that moved them again (0.81 / 0.19
    where JAX moves 0.9 / 0.1) would show here;
  * in that remat step, the modules the backward runs again are those of
    JAX's remat units and no others (GIMM: the motion encoder and the
    latent refiner; R and F: those, the HypoNet, both decoders and both
    update blocks), every upsample head and ResBlock among them, and
    neither the splat nor a correlation lookup runs in a recompute (no
    hand kernel would launch twice).
The entry points build as JAX's do: the bench and the video CLI's
`load_model` without remat (the training CLI's and the training tool's
builds are checked in their own test files).
"""

import collections
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gimmvfi_tpu_torch import bench
from gimmvfi_tpu_torch.cli import video_nx
from gimmvfi_tpu_torch.models import gimm_core, gimmvfi_r as gimmvfi_r_module
from gimmvfi_tpu_torch.models.gimm import GIMM
from gimmvfi_tpu_torch.models.gimmvfi_f import GIMMVFI_F
from gimmvfi_tpu_torch.models.gimmvfi_r import GIMMVFI_R
from gimmvfi_tpu_torch.models.synthesis import ResBlock, UpsampleHead
from gimmvfi_tpu_torch.nn.layers import recomputing
from gimmvfi_tpu_torch.train.optim import create_optimizer
from gimmvfi_tpu_torch.train.train_state import (
    create_train_state,
    make_gimm_train_step,
    make_gimmvfi_train_step,
)

torch.set_num_threads(1)
HW = 128  # stage 2's side: the CPU's grid_sample backward fails below it
GIMM_HW = 32
SGD_LR = 1e-3
REC_WEIGHT = 0.1

MODELS = {
    "gimm": (lambda remat: GIMM(device="cpu", remat=remat), False),
    "gimmvfi_r": (lambda remat: GIMMVFI_R(raft_iters=2, device="cpu", remat=remat), True),
    "gimmvfi_f": (lambda remat: GIMMVFI_F(ff_iters=2, device="cpu", remat=remat), True),
}
# the top-level children that JAX's `nn.remat` wraps (`gimmvfi_tpu/models/gimm.py:35-36`,
# `gimmvfi_r.py:79-111`): the only ones whose modules a remat backward runs again
UNITS = {
    "gimm": {"cnn_encoder", "res_conv"},
    "gimmvfi_r": {"cnn_encoder", "res_conv", "hyponet", "amt_init_decoder",
                  "amt_final_decoder", "amt_update4_low", "amt_update4_high"},
}
UNITS["gimmvfi_f"] = UNITS["gimmvfi_r"]


def _pair(arch: str, seed: int = 0):
    """The model with remat off and on, both with the weights of one
    seeded build."""
    build, _ = MODELS[arch]
    torch.manual_seed(seed)
    weights = build(False).state_dict()
    models = {}
    for remat in (False, True):
        m = build(remat)
        m.load_state_dict(weights, strict=True)
        models[remat] = m
    return models


def _gimm_batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"xs": rng.random((2, 3, GIMM_HW, GIMM_HW, 2), dtype=np.float32),
            "ori_flows": (rng.standard_normal((2, 2, GIMM_HW, GIMM_HW, 2)) * 3).astype(np.float32),
            "t_id": np.asarray([0, 2], np.int32)}


def _vfi_batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    k = int(HW * HW * 0.1)
    return {"img0": rng.random((1, HW, HW, 3), dtype=np.float32),
            "img1": rng.random((1, HW, HW, 3), dtype=np.float32),
            "gt": rng.random((1, HW, HW, 3), dtype=np.float32),
            "t": np.asarray([0.4], np.float32),
            "sub_idx0": rng.permutation(HW * HW)[None, :k].astype(np.int32),
            "sub_idx1": rng.permutation(HW * HW)[None, :k].astype(np.int32)}


@pytest.mark.parametrize("arch", list(MODELS))
def test_defaults_and_state_dict_keys(arch):
    build, default = MODELS[arch]
    family = {"gimm": GIMM, "gimmvfi_r": GIMMVFI_R, "gimmvfi_f": GIMMVFI_F}[arch]
    assert family(device="cpu").remat is default
    models = _pair(arch)
    assert [m.remat for m in models.values()] == [False, True]
    keys = {remat: list(m.state_dict()) for remat, m in models.items()}
    assert keys[True] == keys[False] and len(keys[True]) > 0
    if arch != "gimm":
        for remat, m in models.items():
            assert m.amt_init_decoder.remat is m.amt_final_decoder.remat is remat


@pytest.mark.parametrize("arch", list(MODELS))
def test_inference_is_bitwise(arch):
    models = _pair(arch, seed=1)
    outs = {}
    for remat, m in models.items():
        if arch == "gimm":
            b = _gimm_batch(2)
            with torch.no_grad():
                outs[remat] = [m(torch.from_numpy(b["xs"][:, [0, 2]]),
                                 torch.from_numpy(b["ori_flows"]), torch.tensor([0.3, 0.6]))]
        else:
            b = _vfi_batch(2)
            img_xs = torch.from_numpy(np.stack([b["img0"], b["img1"]], axis=1))
            got = m.interpolate(img_xs, [0.5])
            outs[remat] = [got["imgt_pred"][0], got["flowt"][0], got["ninrflow"][0]]
    for a, b in zip(outs[False], outs[True]):
        assert torch.isfinite(a).all() and torch.equal(a, b)


def _spy(m, monkeypatch):
    """Records, for the run inside, the names of `m`'s modules that run
    inside a recompute, and the calls of the splat and of the AMT's
    lookup that do."""
    ran, in_recompute = set(), collections.Counter()
    for name, mod in m.named_modules():
        if name:
            mod.register_forward_pre_hook(
                lambda mod, args, name=name: ran.add(name) if recomputing() else None)

    def counted(module, attr):
        fn = getattr(module, attr)

        def call(*args, **kwargs):
            in_recompute[attr] += recomputing()
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, attr, call)

    counted(gimm_core, "softsplat")
    counted(gimmvfi_r_module.corr_ops, "bidir_corr_lookup")
    return ran, in_recompute


def _step(arch, m, batch):
    """One SGD step of `m` on `batch`: its metrics, gradients and state
    dict after it."""
    opt, sched = create_optimizer(m, "sgd", init_lr=SGD_LR, weight_decay=0.0, ft=False)
    state = create_train_state(m, opt, sched, use_ema=False)
    step = (make_gimm_train_step(use_ema=False) if arch == "gimm"
            else make_gimmvfi_train_step(REC_WEIGHT, None, use_ema=False))
    metrics = step(state, batch)
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.clone() for n, p in m.named_parameters()},
            {k: v.clone() for k, v in m.state_dict().items()})


@pytest.mark.parametrize("arch", list(MODELS))
def test_training_step_is_bitwise(arch, monkeypatch):
    models = _pair(arch, seed=3)
    batch = _gimm_batch(4) if arch == "gimm" else _vfi_batch(4)
    before = {k: v.clone() for k, v in models[False].state_dict().items()}
    plain = _step(arch, models[False], batch)
    ran, in_recompute = _spy(models[True], monkeypatch)
    remat = _step(arch, models[True], batch)
    assert plain[0] == remat[0] and all(np.isfinite(v) for v in plain[0].values())
    for got, want in zip(remat[1:], plain[1:]):
        assert sorted(got) == sorted(want)
        for name, v in want.items():
            assert torch.equal(got[name], v), name
    assert any(float(g.abs().max()) > 0 for g in plain[1].values())
    stats = [k for k in plain[2] if k.endswith(("running_mean", "running_var"))]
    if arch != "gimm":
        # the step moved the statistics (once: the plain step's are the same)
        assert stats and all(not torch.equal(plain[2][k], before[k]) for k in stats)

    assert {name.split(".")[0] for name in ran} == UNITS[arch]
    if arch != "gimm":
        heads = {n for n, mod in models[True].named_modules() if isinstance(mod, UpsampleHead)}
        blocks = {n for n, mod in models[True].named_modules() if isinstance(mod, ResBlock)
                  and n.startswith(("amt_init_decoder", "amt_final_decoder"))}
        assert len(heads) == 2 and len(blocks) == 6 and heads | blocks <= ran
    assert in_recompute["softsplat"] == in_recompute["bidir_corr_lookup"] == 0


def test_inference_entry_points_build_without_remat(monkeypatch):
    for model in ("r", "f"):
        args = SimpleNamespace(model=model, f32=True)
        assert bench.build(args, torch.device("cpu")).remat is False
    monkeypatch.setattr(video_nx, "load_reference_state_dict", lambda path, m: m)
    for arch in ("gimmvfi_r", "gimmvfi_f"):
        assert video_nx.load_model("ref.pt", arch, 2, "cpu").remat is False
