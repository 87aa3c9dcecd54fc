"""The port's bench entry (`python -m gimmvfi_tpu_torch.bench`) on the CPU.

Its flags, its metric labels (the JAX bench's, `bench.py:299-305`), and the
one JSON line it prints last, for both model families, at 128x128 with
`--device cpu`; the timestep and call counts are cut to 2 so that a run
takes seconds (the flow iterations, 20 for R and 32 for F, stay). The R
run also writes its `--trace-dir` trace, a Chrome trace that names the
`prepare` and `decode_one` spans. Without a card the default device raises.
Each record carries the JAX bench's four FLOP fields and the exact count.

The pipeline FLOP count (`bench.pipeline_flops`) against the JAX package's
on the same pipeline: GIMMVFI_R(raft_iters=2) at 128x192 with 3 timesteps
and GIMMVFI_F(ff_iters=2) at 128x128 with 1, float32. The JAX side is the
products of every `dot_general` and `conv_general_dilated` in
`jax.make_jaxpr` of its `interpolate_sequential` over `jax.eval_shape`
avals (no weights), two FLOPs a multiply-add, a scan body times its
length, with the gather resizes and no strips (`bench.py:120-124`). A
Pallas kernel's body (the splat's) is opaque there, as it is to XLA's cost
analysis; the splat counts zero in the port too. The JAX total less these
named terms, its TPU formulations of what the port computes without a
product (each traced inside a named scope), must equal the port's count to
1e-9 relative:
  * `ops/corr.py: corr_lookup`'s tent einsums (RAFT's, the AMT's and
    FlowFormer's cost lookups; the port samples with `grid_sample`);
  * `ops/interp.py: bilinear_sample`'s corner-weight einsum (the warps;
    the port's `grid_sample`);
  * `flow/raft.py: convex_upsample_8x`'s einsum (a broadcast product and a
    sum in the port).
A float32 `GemmConv2d` is a conv in JAX and a matmul in the port: the
totals are compared, not the ops. On the windowed route
(`corr_max_volume_bytes=0`) the port's count is its materialized count with
each volume's `bmm` replaced by `windowed_corr_work`'s dots of each lookup,
and the plain lookup's own ops counted nowhere.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gimmvfi_tpu.flow import flowformer as jax_flowformer
from gimmvfi_tpu.flow import raft as jax_raft
from gimmvfi_tpu.models.gimmvfi_f import GIMMVFI_F as JaxGIMMVFI_F
from gimmvfi_tpu.models.gimmvfi_r import GIMMVFI_R as JaxGIMMVFI_R
from gimmvfi_tpu.models.gimmvfi_r import interpolate_sequential as jax_interpolate_sequential
from gimmvfi_tpu.ops import corr as jax_corr
from gimmvfi_tpu.ops import interp as jax_interp
from gimmvfi_tpu.ops import strips as jax_strips
from gimmvfi_tpu_torch import bench
from gimmvfi_tpu_torch.models.gimmvfi_f import GIMMVFI_F
from gimmvfi_tpu_torch.models.gimmvfi_r import GIMMVFI_R
from gimmvfi_tpu_torch.nn.layers import init_normal_
from gimmvfi_tpu_torch.ops import corr as corr_ops

torch.set_num_threads(1)

# family: (JAX model, port model, flow iterations, (H, W), timesteps)
FAMILIES = {
    "r": (JaxGIMMVFI_R, GIMMVFI_R, {"raft_iters": 2}, (128, 192), [0.25, 0.5, 0.75]),
    "f": (JaxGIMMVFI_F, GIMMVFI_F, {"ff_iters": 2}, (128, 128), [0.5]),
}
# the JAX functions whose products are its TPU formulations of gathers
# (module, attribute, scope)
RECONCILED = [
    (jax_corr, "corr_lookup", "tent_corr_lookup"),
    (jax_interp, "bilinear_sample", "corner_weight_bilinear_sample"),
    (jax_raft, "convex_upsample_8x", "einsum_convex_upsample_8x"),
    (jax_flowformer, "convex_upsample_8x", "einsum_convex_upsample_8x"),
]


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
            args.device, args.trace_dir) == ("r", "736x1280", None, False, False, False, "cuda",
                                             None)
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
    ("r", ["--profile", "--append-results", "--trace-dir"]),
    ("f", ["--f32"]),
])
def test_one_json_line_on_the_cpu(quick, capsys, model, extra):
    trace_dir = quick.parent / "trace"
    if extra[-1] == "--trace-dir":  # into the scratch directory
        extra = [*extra, str(trace_dir)]
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
    # the JAX bench's four fields, from the exact count of one more call
    flops = record["pipeline_flops"]
    assert isinstance(flops, int) and flops > 0
    assert record["pipeline_tflops"] == round(flops / 1e12, 2)
    v100_fps = bench.N_T * bench.V100_F32_PEAK_FLOPS / flops
    assert record["v100_speed_of_light_fps"] == round(v100_fps, 3)
    assert record["vs_baseline"] == pytest.approx(record["value"] / v100_fps, abs=1e-3)
    assert record["baseline_is_flop_bound"] is True
    (achieved,) = [line for line in lines[:-1] if line.startswith("pipeline FLOPs")]
    assert f"pipeline FLOPs {flops} " in achieved and "TFLOP/s" in achieved
    if "--profile" in extra:
        for stage in ("prepare", "decode_one", "flow estimator alone (RAFT", "FLOPs: prepare"):
            assert any(line.startswith(stage) for line in lines[:-1]), stage
        (split,) = [line for line in lines[:-1] if line.startswith("FLOPs: prepare")]
        prep, dec = (int(w) for w in split.replace(",", "").split() if w.isdigit())
        assert prep + bench.N_T * dec == flops  # materialized: every decode counts the same
        assert quick.read_text() == lines[-1] + "\n"
    else:
        assert not quick.exists()
    if "--trace-dir" in extra:
        (path,) = trace_dir.glob("*.json")
        assert any(line.endswith(str(path)) for line in lines[:-1])
        names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
        assert {"prepare", "decode_one"} <= names
    else:
        assert not trace_dir.exists()


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--size", "128x128"])


def _sub_jaxprs(eqn):
    for value in eqn.params.values():
        for x in value if isinstance(value, (tuple, list)) else (value,):
            if isinstance(x, jax.extend.core.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jax.extend.core.Jaxpr):
                yield x


def _jaxpr_flops(jaxpr, scopes: set[str], mult: int = 1) -> dict:
    """{"total": dot + conv FLOPs, scope: the part traced inside it} of a
    jaxpr: a scan body times its length, a Pallas kernel's body opaque, a
    cond's branches held equal, a while's body holding no product."""
    out = dict.fromkeys(["total", *scopes], 0)

    def add(part, k=1):
        for key, v in part.items():
            out[key] += k * v

    for e in jaxpr.eqns:
        name = e.primitive.name
        flops = 0
        if name == "dot_general":
            (contract, _), _ = e.params["dimension_numbers"]
            k = math.prod(e.invars[0].aval.shape[d] for d in contract)
            flops = 2 * math.prod(e.outvars[0].aval.shape) * k
        elif name == "conv_general_dilated":
            spec = e.params["dimension_numbers"].rhs_spec  # (out, in, *spatial)
            assert all(d == 1 for d in e.params["lhs_dilation"])
            k = math.prod(e.invars[1].aval.shape[d] for d in spec[1:])
            flops = 2 * math.prod(e.outvars[0].aval.shape) * k
        if flops:
            add({"total": flops, **{sc: flops for sc in scopes
                                    if f"{sc}/" in str(e.source_info.name_stack) + "/"}}, mult)
        if name == "pallas_call":
            continue
        parts = [_jaxpr_flops(sub, scopes) for sub in _sub_jaxprs(e)]
        if name == "cond":
            assert all(p == parts[0] for p in parts), parts
            parts = parts[:1]
        elif name == "while":
            assert all(p["total"] == 0 for p in parts), parts
        for part in parts:
            add(part, mult * (e.params["length"] if name == "scan" else 1))
    return out


@pytest.fixture(scope="module")
def jax_counts():
    """{family: the JAX count}, one trace a family with the reconciled
    functions wrapped in named scopes."""
    counts = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_interp, "_TENT_MATMUL_MAX", -1)
        mp.setattr(jax_strips, "ENABLED", False)
        for module, attr, scope in RECONCILED:
            def scoped(*args, _fn=getattr(module, attr), _scope=scope, **kwargs):
                with jax.named_scope(_scope):
                    return _fn(*args, **kwargs)
            mp.setattr(module, attr, scoped)
        for family, (jax_model, _, iters, hw, ts) in FAMILIES.items():
            model = jax_model(remat=False, **iters)
            small = jax.ShapeDtypeStruct((1, 2, 64, 64, 3), jnp.float32)
            variables = jax.eval_shape(lambda r, x: model.init(r, x, (0.5,)),
                                       jax.random.PRNGKey(0), small)
            img = jax.ShapeDtypeStruct((1, 2, *hw, 3), jnp.float32)
            closed = jax.make_jaxpr(lambda v, x: jax_interpolate_sequential(
                model, v, x, jnp.asarray(ts, jnp.float32)))(variables, img)
            counts[family] = _jaxpr_flops(closed.jaxpr, {sc for *_, sc in RECONCILED})
    return counts


# the windowed route's check: R cut to 128x128 and one timestep
WINDOWED_R = (128, 128), [0.5]


@pytest.fixture(scope="module")
def port_counts():
    """`count(family, limit, hw=None, ts=None)`: the port's count of the
    family's pipeline on the CPU at the correlation limit `limit` (the
    family's own shape and timesteps unless given), as (the count by op,
    each all-pairs volume's bmm FLOPs, each windowed lookup's
    `windowed_corr_work` dots); each configuration counted once."""
    cache = {}

    def count(family, limit, hw=None, ts=None):
        _, port_model, iters, fam_hw, fam_ts = FAMILIES[family]
        hw, ts = hw or fam_hw, ts or fam_ts
        key = (family, limit, hw, tuple(ts))
        if key in cache:
            return cache[key]
        model = init_normal_(port_model(*iters.values(), device="cpu",
                                        corr_max_volume_bytes=limit), 0)
        img = torch.from_numpy(np.random.default_rng(0).random((1, 2, *hw, 3), dtype=np.float32))
        volumes, lookups = [], []
        all_pairs, plain = corr_ops.all_pairs_corr, corr_ops.windowed_corr_lookup_plain

        def recorded_volume(fmap1, fmap2):
            n, c, h1, w1 = fmap1.shape
            volumes.append(2 * n * h1 * w1 * fmap2.shape[-2] * fmap2.shape[-1] * c)
            return all_pairs(fmap1, fmap2)

        def recorded_lookup(wc, coords, radius=4):
            lookups.append(corr_ops.windowed_corr_work(wc, coords, radius)[1])
            return plain(wc, coords, radius)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(corr_ops, "all_pairs_corr", recorded_volume)
            mp.setattr(corr_ops, "windowed_corr_lookup_plain", recorded_lookup)
            by_op = bench.count_flops(model, lambda: bench.interpolate_sequential(model, img, ts))
        assert all(p.requires_grad for p in model.parameters())  # restored after counting
        cache[key] = by_op, volumes, lookups
        return cache[key]

    return count


@pytest.mark.parametrize("family", FAMILIES)
def test_pipeline_flops_match_the_jax_count(jax_counts, port_counts, family):
    jax_count = jax_counts[family]
    reconciled = {sc: jax_count[sc] for *_, sc in RECONCILED}
    assert all(v > 0 for v in reconciled.values()), reconciled
    by_op, volumes, _ = port_counts(family, corr_ops.MAX_VOLUME_BYTES)
    assert bench.WINDOWED_LOOKUP_OP not in by_op and volumes
    total = sum(by_op.values())
    expected = jax_count["total"] - sum(reconciled.values())
    assert abs(total - expected) <= 1e-9 * expected, (total, expected, reconciled)


@pytest.mark.parametrize("family", FAMILIES)
def test_windowed_route_charges_the_lookups_work(port_counts, family):
    shape = WINDOWED_R if family == "r" else (None, None)
    mat, volumes, _ = port_counts(family, corr_ops.MAX_VOLUME_BYTES, *shape)
    by_op, no_volumes, lookups = port_counts(family, 0, *shape)
    iters, ts = FAMILIES[family][2], shape[1] or FAMILIES[family][4]
    # RAFT's lookups (one an iteration, both directions batched) and the
    # AMT's two a timestep; FlowFormer's own volume is no all-pairs bmm
    assert len(lookups) == iters.get("raft_iters", 0) + 2 * len(ts)
    assert by_op[bench.WINDOWED_LOOKUP_OP] == sum(lookups) > 0
    assert volumes and not no_volumes
    assert sum(by_op.values()) == sum(mat.values()) - sum(volumes) + sum(lookups)
    # the plain lookup's own einsum is counted nowhere: only the volumes' bmm went
    assert by_op["aten.bmm"] == mat["aten.bmm"] - sum(volumes)
