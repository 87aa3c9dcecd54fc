"""The port's stage-1 train CLI against the JAX CLI, on the CPU.

On a fabricated flow tree like `tests/test_train_cli.py`'s (64x64 `.flo`,
8 sequences), both CLIs start from one seeded reference-layout GIMM `.pt`
(`--load-path`) and train one epoch of `configs/gimm/gimm.yaml` with
`--smoke-test`: the port at `experiment.batch_size=8` on one device, the
JAX CLI at `batch_size=1` on its 8 virtual devices, so both see the same 8
items a batch and the same t_id. Their epoch-0 train `mse` and valid `psnr`
agree to 1e-4 relative (the JAX CLI remats GIMM, which reassociates the
float32 backward, ROADMAP C1). Both CLIs' writers are replaced by
recorders, so the numbers are compared unrounded. Then the port resumes
for a second epoch, and its checkpoint loads into the JAX
`load_torch_state_dict` + `convert_gimm` and into the port's
`load_reference_state_dict`. The JAX CLI runs once, in a module fixture. With a config off the
defaults (the softmax splat, coordinates in [-0.5, 0.5], 3 RAFT
iterations), `build_model` builds the model the JAX CLI builds for each
architecture: its `fwarp_type`, `coord_range` and flow iterations are the
flax module's fields (read without an init).
"""

import os
import sys

import numpy as np
import pytest
import torch

from gimmvfi_tpu.cli import train as jax_train_cli
from gimmvfi_tpu.utils.convert import convert_gimm, load_torch_state_dict
from gimmvfi_tpu_torch.cli import train as train_cli
from gimmvfi_tpu_torch.data.frame_io import write_flo
from gimmvfi_tpu_torch.models.gimm import GIMM
from gimmvfi_tpu_torch.utils.config import load_config
from gimmvfi_tpu_torch.utils.convert import jax_gimm_params_to_torch, load_reference_state_dict

torch.set_num_threads(1)
SEQS = [f"00001/{i:04d}" for i in range(8)]
OVERRIDES = ["dataset.crop_size=[64,64]", "experiment.epochs=1", "experiment.test_freq=1",
             "experiment.save_ckpt_freq=1"]


class Recorder:
    """Stands in for a CLI's `Writer`: keeps every scalar it is given."""

    records = []

    def __init__(self, result_path):
        pass

    def add_scalars(self, values, mode, step):
        self.records.append((mode, step, {k: float(v) for k, v in values.items()}))

    def add_scalar(self, tag, value, mode, step):
        self.records.append((mode, step, {tag: float(value)}))

    def add_image(self, *args, **kwargs):
        pass

    def close(self):
        pass


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The flow tree (the test listing keeps a `dummy_last`, as the JAX
    test's) and a seeded reference-layout GIMM checkpoint."""
    root = tmp_path_factory.mktemp("flows")
    rng = np.random.default_rng(0)
    for s in SEQS + ["dummy_last"]:
        d = root / "flow_sequences" / s
        d.mkdir(parents=True)
        for name in ("im1_im3", "im2_im3", "im2_im1", "im3_im1"):
            write_flo(str(d / f"{name}.flo"),
                      (rng.random((64, 64, 2)).astype(np.float32) * 4 - 2))
    (root / "tri_trainlist.txt").write_text("\n".join(SEQS) + "\n")
    (root / "tri_testlist.txt").write_text("\n".join(SEQS + ["dummy_last"]) + "\n")
    torch.manual_seed(0)
    sd = GIMM(device="cpu").state_dict()
    sd["g_filter"] = torch.full((1, 1, 3, 3), 1 / 16)
    ckpt = root / "gimm_seeded.pt"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, ckpt)
    return str(root), str(ckpt)


def _by_mode(records):
    return {(mode, step): values for mode, step, values in records}


@pytest.fixture(scope="module")
def jax_run(tree, tmp_path_factory):
    from gimmvfi_tpu.cli.train import main

    root, ckpt = tree
    out = tmp_path_factory.mktemp("jax_runs")
    Recorder.records = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("gimmvfi_tpu.utils.writer.Writer", Recorder)
        main(["--config", "configs/gimm/gimm.yaml", "--result-path", str(out),
              "--load-path", ckpt, "--overrides", f"dataset.path={root}",
              "experiment.batch_size=1", *OVERRIDES, "--smoke-test"])
    return _by_mode(Recorder.records)


def _port(argv, recorder=True):
    Recorder.records = []
    with pytest.MonkeyPatch.context() as mp:
        if recorder:
            mp.setattr(train_cli, "Writer", Recorder)
        res = train_cli.main([*argv, "--device", "cpu"])
    return res, _by_mode(Recorder.records)


def test_cli_matches_jax_then_resumes(tree, jax_run, tmp_path):
    root, ckpt = tree
    out = tmp_path / "runs"
    res, rec = _port(["--config", "configs/gimm/gimm.yaml", "--result-path", str(out),
                      "--load-path", ckpt, "--overrides", f"dataset.path={root}",
                      "experiment.batch_size=8", *OVERRIDES, "--smoke-test"])
    assert res["steps"] == 1 and [e["epoch"] for e in res["epochs"]] == [0]
    for key, metric in ((("train", 0), "mse"), (("train", 0), "loss_total"),
                        (("valid", 0), "psnr"), (("valid", 0), "mse")):
        got, ref = rec[key][metric], jax_run[key][metric]
        assert abs(got - ref) <= 1e-4 * abs(ref), (key, metric, got, ref)
    assert rec[("train", 0)] == res["epochs"][0]["train"]

    run_dir = res["run_dir"]
    log = open(os.path.join(run_dir, "train.log")).read()
    assert "epoch 0: loss_total:" in log and "epoch 0 [valid]: " in log
    assert "partially loaded weights" in log
    assert os.listdir(os.path.join(run_dir, "ckpt")) == ["step_1.pt"]

    res2, _ = _port(["--config", "unused-when-resuming", "--result-path", run_dir, "--resume",
                     "--overrides", *OVERRIDES, "experiment.epochs=2", "--smoke-test"])
    assert res2["steps"] == 2 and [e["epoch"] for e in res2["epochs"]] == [1]
    log = open(os.path.join(run_dir, "train.log")).read()
    assert "resumed from step 1 (epoch 1)" in log and "epoch 1: loss_total:" in log

    # the checkpoint in both packages' .pt readers
    path = os.path.join(run_dir, "ckpt", "step_2.pt")
    saved = torch.load(path, weights_only=True)
    assert sorted(saved) == ["optimizer", "scheduler", "state_dict", "state_dict_ema", "step"]
    params, stats = convert_gimm(load_torch_state_dict(path))
    assert stats == {}
    back = jax_gimm_params_to_torch(params)
    assert sorted(back) == sorted(saved["state_dict"])
    for k, v in back.items():
        assert torch.equal(v, saved["state_dict"][k]), k
    model = load_reference_state_dict(path, GIMM(device="cpu"))
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved["state_dict"][k]), k


def test_eval_without_tensorboardx(tree, tmp_path, monkeypatch):
    """`--eval` validates the loaded weights and exits; without tensorboardX
    the CLI says so once in train.log and writes no event file."""
    root, ckpt = tree
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    res, _ = _port(["--config", "configs/gimm/gimm.yaml", "--result-path", str(tmp_path),
                    "--load-path", ckpt, "--eval", "--overrides", f"dataset.path={root}",
                    "experiment.batch_size=8", "--smoke-test"], recorder=False)
    assert res["writer"] == "none" and res["steps"] == 0
    assert np.isfinite(res["epochs"][0]["valid"]["psnr"])
    log = open(os.path.join(res["run_dir"], "train.log")).read()
    assert log.count("tensorboardX is not installed") == 1
    assert "epoch 0 [valid]: " in log
    assert not os.path.exists(os.path.join(res["run_dir"], "valid"))


def _vimeo_tree(root, hw=(128, 160), n_seq=2, seed=0):
    """A tiny Vimeo tree in the recipe's layout: `vimeo_septuplet` (7
    frames a sequence, `all_sep.txt`) and `vimeo_triplet` (3 frames,
    `tri_testlist.txt`, whose last line the test split drops), seeded PNGs."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    seqs = [f"00001/{i:04d}" for i in range(n_seq)]
    for split, frames, listing, extra in (("vimeo_septuplet", 7, "all_sep.txt", []),
                                          ("vimeo_triplet", 3, "tri_testlist.txt", ["dummy"])):
        for s in seqs:
            d = root / split / "sequences" / s
            d.mkdir(parents=True)
            for k in range(1, frames + 1):
                Image.fromarray((rng.random((*hw, 3)) * 255).astype(np.uint8)).save(d / f"im{k}.png")
        (root / split / listing).write_text("\n".join(seqs + extra) + "\n")
    return str(root / "vimeo_septuplet")


def test_cli_refuses_stage2_and_a_missing_card(tree, tmp_path):
    """Stage 2 is no longer refused: `configs/gimmvfi/gimmvfi_r_arb.yaml`
    builds a GIMMVFI_R run on `--device cpu` and validates (`--eval`) on a
    tiny tree, its `--load-path` a stage-1 checkpoint of which exactly
    GIMM's tensors load. Without a card the default device still raises."""
    _, gimm_ckpt = tree
    sep = _vimeo_tree(tmp_path / "data")
    res, rec = _port(["--config", "configs/gimmvfi/gimmvfi_r_arb.yaml", "--result-path",
                      str(tmp_path / "runs"), "--load-path", gimm_ckpt, "--eval",
                      "--overrides", f"dataset.path={sep}", "arch.raft_iter=2",
                      "experiment.batch_size=1", "--smoke-test"])
    assert res["steps"] == 0 and sorted(rec) == [("valid", 0), ("valid_ema", 0)]
    assert sorted(rec[("valid", 0)]) == ["loss_total", "psnr", "rec"]
    assert all(np.isfinite(v) for v in rec[("valid", 0)].values())
    gimm_keys = [k for k in GIMM(device="cpu").state_dict()]
    log = open(os.path.join(res["run_dir"], "train.log")).read()
    assert f"partially loaded weights from {gimm_ckpt} ({len(gimm_keys)} tensors)" in log
    assert "(gimmvfi_r)" in log
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            train_cli.main(["--config", "configs/gimm/gimm.yaml", "--result-path",
                            str(tmp_path)])


class _Built(Exception):
    """Stops the JAX CLI just after it builds its model."""


class _NoItems:
    """Stands in for a dataset: the JAX CLI reads none before its model."""

    meta_data = []


ARCH_OFF_DEFAULTS = ["arch.fwarp_type=softmax", "arch.coord_range=[-0.5,0.5]", "arch.raft_iter=3"]


@pytest.mark.parametrize("arch,config", [("gimm", "configs/gimm/gimm.yaml"),
                                         ("gimmvfi_r", "configs/gimmvfi/gimmvfi_r_arb.yaml"),
                                         ("gimmvfi_f", "configs/gimmvfi/gimmvfi_f_arb.yaml")])
def test_build_model_builds_what_the_jax_cli_builds(arch, config, tmp_path):
    """The config sets `fwarp_type`, `coord_range` and `raft_iter` off their
    defaults; the JAX CLI, run up to its `create_model` call, reads only
    `raft_iter` (GIMM-VFI-R's), and `build_model` gives the same fields,
    `remat` included (on for all three: GIMM's by the CLI, the others' by
    default)."""
    built = []

    def create_model(*args, **kwargs):
        built.append(real_create(*args, **kwargs))
        raise _Built

    real_create = jax_train_cli.create_model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_train_cli, "create_model", create_model)
        mp.setattr(jax_train_cli, "create_dataset", lambda *a, **k: (_NoItems(), _NoItems()))
        mp.setattr("gimmvfi_tpu.utils.writer.Writer", Recorder)
        with pytest.raises(_Built):
            jax_train_cli.main(["--config", config, "--result-path", str(tmp_path),
                                "--overrides", *ARCH_OFF_DEFAULTS])
    ref = built[0]
    cfg = load_config(config, ARCH_OFF_DEFAULTS)
    assert (cfg.arch.fwarp_type, tuple(cfg.arch.coord_range), cfg.arch.raft_iter) == (
        "softmax", (-0.5, 0.5), 3)
    torch.manual_seed(0)
    model = train_cli.build_model(cfg, arch, torch.device("cpu"))
    assert model.fwarp_type == ref.fwarp_type == "linear"
    assert model.remat is ref.remat is True
    assert tuple(model.coord_range) == tuple(ref.coord_range) == (-1.0, 1.0)
    if arch == "gimmvfi_r":
        assert model.flow_estimator.iters == ref.raft_iters == 3
    elif arch == "gimmvfi_f":
        assert model.flow_estimator.iters == ref.ff_iters == 32
