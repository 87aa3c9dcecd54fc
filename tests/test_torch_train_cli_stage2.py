"""The port's stage-2 train CLI against the JAX CLI, on the CPU.

On a fabricated Vimeo tree (`test_torch_train_cli.py: _vimeo_tree`, 128x160
PNGs), both CLIs train one epoch of `configs/gimmvfi/gimmvfi_r_arb.yaml`
with `--smoke-test` and `arch.raft_iter=2`, `dataset.crop_size=[128,128]`,
batch 1, from one seeded reference-layout GIMMVFI_R `.pt` (`--load-path`).
The JAX CLI runs on a one-device mesh, so that its batch (and the BatchNorm
batch statistics over it) is the port's. Their epoch-0 train `loss_total`,
`rec`, `psnr` and valid `psnr` agree to 1e-4 relative; both writers are
replaced by recorders. The port also logs the reconstruction grid (after
the compared numbers, so the JAX CLI skips it). Then the port resumes for a
second epoch with a seeded LPIPS `.pt` (`--lpips-path`), which adds the
perceptual loss (the step's LPIPS term is held against JAX in
`test_torch_gimmvfi_train.py`). The JAX CLI runs once, in a module fixture.
"""

import os

import jax
import numpy as np
import pytest
import torch

from gimmvfi_tpu_torch.cli import train as train_cli
from gimmvfi_tpu_torch.models.gimmvfi_r import GIMMVFI_R
from gimmvfi_tpu_torch.train.lpips import LPIPS
from test_torch_train_cli import Recorder, _by_mode, _vimeo_tree

torch.set_num_threads(1)
CONFIG = "configs/gimmvfi/gimmvfi_r_arb.yaml"
OVERRIDES = ["arch.raft_iter=2", "dataset.crop_size=[128,128]", "experiment.batch_size=1",
             "experiment.epochs=1", "experiment.test_freq=1", "experiment.save_ckpt_freq=1"]


class ImageRecorder(Recorder):
    images = []

    def add_image(self, tag, img, mode, step):
        self.images.append((tag, mode, step, np.asarray(img).shape))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("stage2")
    sep = _vimeo_tree(root / "data")
    torch.manual_seed(0)
    vfi = root / "gimmvfi_r_seeded.pt"
    torch.save({"state_dict": GIMMVFI_R(raft_iters=2, device="cpu").state_dict()}, vfi)
    torch.manual_seed(1)
    lpips = root / "lpips_seeded.pt"
    torch.save(LPIPS(device="cpu").state_dict(), lpips)
    return sep, str(vfi), str(lpips)


@pytest.fixture(scope="module")
def jax_run(inputs, tmp_path_factory):
    from gimmvfi_tpu.cli import train as jax_train_cli

    sep, vfi, _ = inputs
    mesh = jax_train_cli.create_mesh
    Recorder.records = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("gimmvfi_tpu.utils.writer.Writer", Recorder)
        mp.setattr(jax_train_cli, "create_mesh", lambda: mesh(jax.devices()[:1]))
        jax_train_cli.main(["--config", CONFIG, "--result-path", str(tmp_path_factory.mktemp("jax")),
                            "--load-path", vfi, "--overrides", f"dataset.path={sep}", *OVERRIDES,
                            "--smoke-test"])
    return _by_mode(Recorder.records)


def _port(argv):
    Recorder.records, ImageRecorder.images = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_cli, "Writer", ImageRecorder)
        res = train_cli.main([*argv, "--device", "cpu"])
    return res, _by_mode(Recorder.records), list(ImageRecorder.images)


def test_stage2_cli_matches_jax_then_resumes(inputs, jax_run, tmp_path):
    sep, vfi, lpips = inputs
    res, rec, images = _port(["--config", CONFIG, "--result-path", str(tmp_path / "runs"),
                              "--load-path", vfi, "--overrides", f"dataset.path={sep}",
                              *OVERRIDES, "experiment.test_imlog_freq=1", "--smoke-test"])
    assert res["steps"] == 2 and [e["epoch"] for e in res["epochs"]] == [0]
    assert sorted(rec[("train", 0)]) == sorted(train_cli.STAGE2_METRICS)
    assert rec[("train", 0)]["lpips"] == 0
    for key, metric in ((("train", 0), "loss_total"), (("train", 0), "rec"),
                        (("train", 0), "psnr"), (("valid", 0), "psnr"),
                        (("valid_ema", 0), "psnr")):
        got, ref = rec[key][metric], jax_run[key][metric]
        assert abs(got - ref) <= 1e-4 * abs(ref), (key, metric, got, ref)
    # one grid row a validation sample: I0 | pred | GT | I1 | two flow images
    assert images == [("reconstruction", "valid", 0, (128, 6 * 160, 3))]

    run_dir = res["run_dir"]
    log = open(os.path.join(run_dir, "train.log")).read()
    assert "epoch 0: loss_total:" in log
    assert os.listdir(os.path.join(run_dir, "ckpt")) == ["step_2.pt"]
    res2, rec2, _ = _port(["--config", "unused-when-resuming", "--result-path", run_dir,
                           "--resume", "--lpips-path", lpips, "--overrides", *OVERRIDES,
                           "experiment.epochs=2", "--smoke-test"])
    assert res2["steps"] == 4 and [e["epoch"] for e in res2["epochs"]] == [1]
    assert np.isfinite(rec2[("train", 1)]["loss_total"]) and rec2[("train", 1)]["lpips"] != 0
    log = open(os.path.join(run_dir, "train.log")).read()
    assert "resumed from step 2 (epoch 1)" in log and "perceptual (LPIPS) loss enabled" in log
    assert sorted(os.listdir(os.path.join(run_dir, "ckpt"))) == ["step_2.pt", "step_4.pt"]
