"""The port's stage-1 train CLI data-parallel under torchrun, against the
JAX CLI on one host with two devices, on the CPU.

On `test_torch_train_cli.py`'s fabricated flow tree (64x64 `.flo`, 8
sequences) both CLIs start from one seeded reference-layout GIMM `.pt` and
train one epoch of `configs/gimm/gimm.yaml` with `--smoke-test` at
`experiment.batch_size=2` a device: the port as `torchrun --standalone
--nproc_per_node 2 -m gimmvfi_tpu_torch.cli.train --device cpu` (two gloo
ranks), the JAX CLI in a subprocess with
`XLA_FLAGS=--xla_force_host_platform_device_count=2`. Both form a global
batch of 4 (two steps an epoch), so their epoch-0 train `mse` and valid
`psnr` agree to 1e-4 relative (the JAX CLI remats GIMM, ROADMAP C1). Rank
0 alone writes the run directory: one directory, one `train.log` with each
line once, the config, `ckpt/`. Then `--resume` on two ranks runs a second
epoch. The two CLIs run at the same time.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gimmvfi_tpu_torch.data.frame_io import write_flo
from gimmvfi_tpu_torch.models.gimm import GIMM

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
SEQS = [f"00001/{i:04d}" for i in range(8)]
OVERRIDES = ["dataset.crop_size=[64,64]", "experiment.epochs=1", "experiment.test_freq=1",
             "experiment.save_ckpt_freq=1", "experiment.batch_size=2"]
TIMEOUT = 240

# the JAX CLI with a writer that keeps every scalar, dumped as JSON
_JAX_CLI = r"""
import json, sys
import gimmvfi_tpu.utils.writer as writer_module
records = []

class Recorder:
    def __init__(self, result_path):
        pass
    def add_scalars(self, values, mode, step):
        records.append([mode, step, {k: float(v) for k, v in values.items()}])
    def add_scalar(self, tag, value, mode, step):
        records.append([mode, step, {tag: float(value)}])
    def add_image(self, *args, **kwargs):
        pass
    def close(self):
        pass

writer_module.Writer = Recorder
from gimmvfi_tpu.cli.train import main
main(sys.argv[2:])
json.dump(records, open(sys.argv[1], "w"))
"""


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               **extra)
    env.pop("WORLD_SIZE", None)
    return env


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The flow tree (the test listing keeps a `dummy_last`) and a seeded
    reference-layout GIMM checkpoint."""
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


def _torchrun(args, log_path):
    with open(log_path, "w") as log:
        return subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
             "2", "-m", "gimmvfi_tpu_torch.cli.train", *args, "--device", "cpu"],
            cwd=REPO, env=_env(), stdout=log, stderr=subprocess.STDOUT, timeout=TIMEOUT)


def test_two_ranks_match_the_two_device_jax_cli_then_resume(tree, tmp_path):
    root, ckpt = tree
    common = ["--config", "configs/gimm/gimm.yaml", "--load-path", ckpt, "--overrides",
              f"dataset.path={root}", *OVERRIDES, "--smoke-test"]
    jax_json = tmp_path / "jax_records.json"
    jax = subprocess.Popen(
        [sys.executable, "-c", _JAX_CLI, str(jax_json), *common[:4], "--result-path",
         str(tmp_path / "jax_runs"), *common[4:]],
        cwd=REPO, env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=2"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        runs = tmp_path / "runs"
        proc = _torchrun([*common[:4], "--result-path", str(runs), *common[4:]],
                         tmp_path / "port.log")
        assert proc.returncode == 0, (tmp_path / "port.log").read_text()[-4000:]
        out, _ = jax.communicate(timeout=TIMEOUT)
    finally:
        jax.kill()
    assert jax.returncode == 0, out[-4000:]
    assert "mesh: 2 devices / 1 hosts, global batch 4" in out

    (run_dir,) = runs.iterdir()  # one directory: every rank named it by rank 0's clock
    log = (run_dir / "train.log").read_text()
    for line in ("mesh: 2 devices / 1 hosts, global batch 4", "epoch 0: loss_total:",
                 "epoch 0 [valid]: ", "partially loaded weights"):
        assert log.count(line) == 1, (line, log)
    assert (run_dir / "config.yaml").exists() and os.listdir(run_dir / "ckpt") == ["step_2.pt"]
    (epoch0,) = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    ref = {(mode, step): values for mode, step, values in json.loads(jax_json.read_text())}
    for mode, metric in (("train", "mse"), ("train", "loss_total"), ("valid", "psnr"),
                         ("valid", "mse")):
        got, want = epoch0[mode][metric], ref[(mode, 0)][metric]
        assert abs(got - want) <= 1e-4 * abs(want), (mode, metric, got, want)

    proc = _torchrun(["--config", "unused-when-resuming", "--result-path", str(run_dir),
                      "--resume", "--overrides", *OVERRIDES, "experiment.epochs=2",
                      "--smoke-test"], tmp_path / "resume.log")
    assert proc.returncode == 0, (tmp_path / "resume.log").read_text()[-4000:]
    log = (run_dir / "train.log").read_text()
    assert log.count("resumed from step 2 (epoch 1)") == 1 and log.count("epoch 1: loss_total:") == 1
    epochs = [json.loads(x)["epoch"] for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert epochs == [0, 1]
    assert sorted(os.listdir(run_dir / "ckpt")) == ["step_2.pt", "step_4.pt"]
    assert [p.name for p in runs.iterdir()] == [run_dir.name]


def test_a_failed_rank_fails_the_run(tree, tmp_path):
    """A rank that fails (here: a dataset path that does not exist) ends
    torchrun with a non-zero exit."""
    proc = _torchrun(["--config", "configs/gimm/gimm.yaml", "--result-path", str(tmp_path),
                      "--overrides", f"dataset.path={tmp_path / 'missing'}", *OVERRIDES,
                      "--smoke-test"], tmp_path / "failed.log")
    assert proc.returncode != 0
    assert "FileNotFoundError" in (tmp_path / "failed.log").read_text()
