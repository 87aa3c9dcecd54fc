"""The port's training-throughput tool (`python -m
gimmvfi_tpu_torch.tools.train_throughput`) on the CPU.

Its fabricated data are the JAX tool's draws, bitwise: a transcription of
`tools/tpu_train_throughput.py:72-74, 87` (stage 1) and `:127-141` (stage
2) at the recipes' shapes. Both stages at cut shapes (stage 1: batch 2 at
64x64; stage 2: batch 1 at 128x128, `raft_iters=2`: a stage-2 step takes
~12 s on one CPU thread, and below 128 px the CPU's `grid_sample` backward
fails), 2 steps each through
`main(["--device", "cpu", ...])`: the record printed last and written to
`--out`, each stage with `TRAIN_TPU.json`'s keys (`first_step_s` in place
of `compile_s`) and finite losses; the models built as the JAX tool builds
them (`tools/tpu_train_throughput.py:71,118`): `GIMM(remat=True)` and
`GIMMVFI_R` at its default remat, on. Without a card the default raises.
"""

import functools
import json
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gimmvfi_tpu_torch.tools import train_throughput as tt

torch.set_num_threads(1)
TRAIN_TPU = Path(__file__).resolve().parent.parent / "TRAIN_TPU.json"


def test_stage1_draws_are_the_jax_tools():
    steps, (b, h, w) = 100, (32, 256, 256)
    rng_np = np.random.default_rng(0)
    xs = jnp.asarray(rng_np.random((b, 3, h, w, 2)), jnp.float32)
    ori = jnp.asarray(rng_np.normal(0, 3, (b, 2, h, w, 2)), jnp.float32)
    t_ids = rng_np.integers(0, 3, size=steps)
    got = tt.stage1_data(steps, b, (h, w))
    assert got["xs"].dtype == got["ori_flows"].dtype == np.float32
    np.testing.assert_array_equal(got["xs"], np.asarray(xs))
    np.testing.assert_array_equal(got["ori_flows"], np.asarray(ori))
    np.testing.assert_array_equal(got["t_ids"], t_ids)


def test_stage2_batch_is_the_jax_tools():
    b, h, w = 4, 224, 224
    rng_np = np.random.default_rng(0)
    k = int(h * w * 0.1)
    img0 = jnp.asarray(rng_np.random((b, h, w, 3)), jnp.float32)
    img1 = jnp.asarray(rng_np.random((b, h, w, 3)), jnp.float32)
    want = {
        "img0": img0,
        "img1": img1,
        "gt": 0.5 * (img0 + img1),
        "t": jnp.full((b,), 0.5, jnp.float32),
        "sub_idx0": jnp.asarray(np.stack([rng_np.permutation(h * w)[:k] for _ in range(b)]),
                                jnp.int32),
        "sub_idx1": jnp.asarray(np.stack([rng_np.permutation(h * w)[:k] for _ in range(b)]),
                                jnp.int32),
    }
    got = tt.stage2_batch(b, (h, w))
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == np.asarray(value).dtype, key
        np.testing.assert_array_equal(got[key], np.asarray(value), err_msg=key)


def test_both_stages_on_the_cpu(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(tt, "run_stage1", functools.partial(tt.run_stage1, batch=2, hw=(64, 64)))
    monkeypatch.setattr(tt, "run_stage2", functools.partial(tt.run_stage2, batch=1, hw=(128, 128),
                                                            raft_iters=2))
    built = []

    def init_normal_(model, seed):
        built.append(model)
        return real_init(model, seed)

    real_init = tt.init_normal_
    monkeypatch.setattr(tt, "init_normal_", init_normal_)
    out = tmp_path / "train.json"
    record = tt.main(["--steps", "2", "--device", "cpu", "--out", str(out)])
    assert [(type(m).__name__, m.remat) for m in built] == [("GIMM", True), ("GIMMVFI_R", True)]
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == record == json.loads(out.read_text())
    assert [line.split(":")[0] for line in lines[:-1]] == ["stage1", "stage2"]
    assert (record["device"], record["name"], record["power_limit"]) == ("cpu", None, None)
    tpu = json.loads(TRAIN_TPU.read_text())
    for stage, shape in (("stage1", "bs2 64x64"), ("stage2", "bs1 128x128")):
        got = record[stage]
        want_keys = set(tpu[stage]) - {"compile_s"} | {"first_step_s"}
        assert set(got) == want_keys, stage
        assert (got["stage"], got["shape"], got["steps"]) == (int(stage[-1]), shape, 2)
        assert got["first_step_s"] > 0 and got["steps_per_sec"] > 0
        assert [i for i, _ in got["loss_curve"]] == [0, 0, 0, 0, 1]
        assert all(math.isfinite(loss) for _, loss in got["loss_curve"])
        assert got["loss_decreased"] == (got["loss_curve"][-1][1] < got["loss_curve"][0][1])
        assert got["peak_hbm_mib"] is None


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.main(["--steps", "1"])
