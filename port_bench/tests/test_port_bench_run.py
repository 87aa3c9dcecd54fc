"""The harness end to end on the CPU at a small size: the result line, the
module check, and `correct` coming out false for the control and for
outputs altered where they are produced."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from port_bench.harness import run_cell
from port_bench.run import FORBIDDEN, loaded_forbidden
from port_bench.spec import ROOT, load_cell


def tiny(name="r720_8x"):
    """The cell at a size a test can hold: 120x192 frames, 2 flow
    iterations, 3x, a 3-frame clip; its configuration, mix and limits
    otherwise as committed."""
    cell = load_cell(name)
    cell.traffic.update(height=120, width=192, n=3, clip_frames=3, warmup_calls=1,
                        check_calls=2, trace_skip=1, trace_calls=1)
    prog = cell.config["program"]["kwargs"]
    for k in prog:
        if k.endswith("iters"):
            prog[k] = 2
    cell.config["reference"]["iters"] = 2
    return cell


def run(cell, **kw):
    torch.manual_seed(0)
    return run_cell(cell, 2**31 + 77, 0.5, kw.pop("trace", False), "cpu", time.perf_counter(),
                    **kw)


@pytest.fixture(scope="module")
def program_run():
    return run(tiny())


def test_result_line(program_run):
    r = program_run
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"frames_per_s", "pair_ms_p90", "peak_mib", "setup_s"}
    assert r["metrics"]["frames_per_s"]["value"] > 0
    for c in r["checks"].values():
        assert 0 <= c["value"] <= c["limit"]
    json.dumps(r)


def test_traced_run_reports_per_layer_metrics():
    r = run(tiny(), trace=True)
    assert r["correct"] is True
    assert {"entry_ms", "mfu_pct"} <= set(r["metrics"])
    assert "frames_per_s" not in r["metrics"]
    assert {"busy_s", "window_s"} <= set(r["device"]) and "breakdown" in r


def test_control_is_not_correct():
    """The reference one precision step lower in the program's place."""
    r = run(tiny(), control=True)
    assert r["correct"] is False


@pytest.mark.parametrize("fault", ["frame_altered", "flow_altered", "timestep_dropped"])
def test_altered_outputs_are_not_correct(fault):
    def alter(out, k):
        frames, flows = out["frames"].copy(), out["flows"].copy()
        if fault == "frame_altered":
            frames[-1] = np.clip(frames[-1] + 0.05, 0, 1)
        elif fault == "flow_altered":
            flows[0] = flows[0] * 1.2
        else:
            frames, flows = frames[:-1], flows[:-1]
        return {"frames": frames, "flows": flows}

    assert run(tiny(), fault=alter)["correct"] is False


def test_nothing_forbidden_is_loaded():
    code = ("import time, torch; from port_bench.tests.test_port_bench_run import tiny; "
            "from port_bench.harness import run_cell; from port_bench.run import loaded_forbidden; "
            "r = run_cell(tiny(), 5, 0.1, False, 'cpu', time.perf_counter()); "
            "print(loaded_forbidden(), r['correct'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[-1]
    assert out == "[] True"


def test_forbidden_names_compare_whole_top_levels(monkeypatch):
    assert "gimmvfi_tpu" in FORBIDDEN
    monkeypatch.setitem(sys.modules, "gimmvfi_tpu_torch_lookalike", sys)
    assert "gimmvfi_tpu_torch_lookalike" not in loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert loaded_forbidden() == ["jax.numpy"]


def test_run_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the run would measure")
    p = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", "r720_8x",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True)
    assert p.returncode != 0 and "{" not in p.stdout
