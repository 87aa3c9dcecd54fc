"""The port's bench entry (`python -m gimmvfi_tpu_torch.bench`) on the CPU.

Its flags, its metric labels (the JAX bench's, `bench.py:299-305`), and the
one JSON line it prints last, for both model families, at 128x128 with
`--device cpu`; the timestep and call counts are cut to 2 so that a run
takes seconds (the flow iterations, 20 for R and 32 for F, stay). Without
a card the default device raises.
"""

import json

import pytest
import torch

from gimmvfi_tpu_torch import bench

torch.set_num_threads(1)


@pytest.fixture
def quick(monkeypatch, tmp_path):
    """Two timesteps, two timed calls, results into a scratch file."""
    monkeypatch.setattr(bench, "N_T", 2)
    monkeypatch.setattr(bench, "TIMED_CALLS", 2)
    monkeypatch.setattr(bench, "RESULTS_PATH", tmp_path / "bench_results_torch.jsonl")
    return tmp_path / "bench_results_torch.jsonl"


def test_flag_defaults():
    args = bench.parse_args([])
    assert (args.model, args.size, args.ds, args.f32, args.profile, args.append_results,
            args.device) == ("r", "736x1280", None, False, False, False, "cuda")
    args = bench.parse_args(["--model", "f", "--size", "1088x2048", "--ds", "0.5", "--f32",
                             "--profile", "--append-results", "--device", "cpu"])
    assert (args.model, args.size, args.ds, args.f32, args.profile, args.append_results,
            args.device) == ("f", "1088x2048", 0.5, True, True, True, "cpu")
    with pytest.raises(SystemExit):
        bench.parse_args(["--model", "x"])


@pytest.mark.parametrize("model,size,ds,label", [
    ("r", "736x1280", None, "interp_frames_per_sec_720p_8x"),
    ("f", "736x1280", None, "interp_frames_per_sec_720p_8x_f"),
    ("r", "1088x2048", 0.5, "interp_frames_per_sec_1088x2048_ds0.5_8x"),
    ("r", "2176x4096", 0.25, "interp_frames_per_sec_2176x4096_ds0.25_8x"),
    ("f", "1088x2048", 0.5, "interp_frames_per_sec_1088x2048_ds0.5_8x_f"),
    ("r", "736x1280", 0.5, "interp_frames_per_sec_736x1280_ds0.5_8x"),
    ("r", "128x128", None, "interp_frames_per_sec_128x128_ds1_8x"),
])
def test_metric_labels_are_the_jax_benchs(model, size, ds, label):
    assert bench.metric_label(model, size, ds) == label


@pytest.mark.parametrize("model,extra", [
    ("r", ["--profile", "--append-results"]),
    ("f", ["--f32"]),
])
def test_one_json_line_on_the_cpu(quick, capsys, model, extra):
    record = bench.main(["--model", model, "--size", "128x128", "--device", "cpu", *extra])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == record
    assert sum(line.startswith("{") for line in lines) == 1
    assert record["metric"] == "interp_frames_per_sec_128x128_ds1_8x" + ("_f" if model == "f" else "")
    assert record["unit"] == "frames/sec" and record["value"] > 0
    assert record["dtype"] == ("float32" if "--f32" in extra else "bfloat16")
    assert record["device"] == "cpu"
    # a CPU run has no card, no allocator peak and no power limit
    assert record["peak_mib"] is record["name"] is record["power_limit"] is None
    assert any("fps min" in line for line in lines[:-1])
    if "--profile" in extra:
        for stage in ("prepare", "decode_one", "flow estimator alone (RAFT"):
            assert any(line.startswith(stage) for line in lines[:-1]), stage
        assert quick.read_text() == lines[-1] + "\n"
    else:
        assert not quick.exists()


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--size", "128x128"])
