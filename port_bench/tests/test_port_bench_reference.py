"""The frozen reference against the port, and its independence from it."""

import ast
import subprocess
import sys

import numpy as np
import pytest
import torch

from port_bench.reference.gimmvfi import GIMMVFI, Precision, interpolate_padded
from port_bench.spec import HERE, ROOT
from port_bench.weights import make_weights, state_shapes

H, W = 128, 192  # small: 128 px a side at least, a multiple of 32 after the pad


def pair(seed):
    rng = np.random.default_rng(seed)
    return (rng.random((H - 8, W, 3), dtype=np.float32),
            rng.random((H - 8, W, 3), dtype=np.float32))


def models(kind, dtype):
    from gimmvfi_tpu_torch.models.gimmvfi_f import GIMMVFI_F
    from gimmvfi_tpu_torch.models.gimmvfi_r import GIMMVFI_R

    names = {"compute": "float32" if dtype is None else "bfloat16", "hyponet": "float32",
             "flow": "float32"}
    ref = GIMMVFI("raft" if kind == "r" else "flowformer", 2, Precision.named(names))
    port = (GIMMVFI_R(raft_iters=2, dtype=dtype, device="cpu", remat=False) if kind == "r"
            else GIMMVFI_F(ff_iters=2, dtype=dtype, device="cpu", remat=False))
    w = make_weights(state_shapes(ref), 5, "cpu")
    ref.load_state_dict(w, strict=True)
    port.load_state_dict(w, strict=True)
    return port, ref.requires_grad_(False)


@pytest.mark.parametrize("kind", ["r", "f"])
@pytest.mark.parametrize("ds", [None, 0.5])
def test_reference_agrees_with_port_float32(kind, ds):
    from gimmvfi_tpu_torch.cli.video_nx import interpolate_padded as port_entry
    from gimmvfi_tpu_torch.ops.pad import InputPadder

    torch.manual_seed(0)
    port, ref = models(kind, None)
    a, b = pair(1)
    ts = [0.25, 0.75]
    if ds is not None:  # the working size must stay a multiple of 32
        a, b = np.repeat(np.repeat(a, 2, 0), 2, 1), np.repeat(np.repeat(b, 2, 0), 2, 1)
    pf, pl = port_entry(port, InputPadder(a.shape[:2], divisor=32), a, b, ts, ds)
    rf, rl = interpolate_padded(ref, a, b, ts, ds)
    assert pf.shape == rf.shape and pl.shape == rl.shape
    np.testing.assert_allclose(pf, rf, atol=2e-5)
    np.testing.assert_allclose(pl, rl, atol=2e-4 * max(1.0, np.abs(rl).max()))


def test_reference_bf16_policy_follows_port():
    """At the program's precision the reference computes as the port does:
    the bf16 gap between them is far below the bf16 program's gap to float32."""
    from gimmvfi_tpu_torch.cli.video_nx import interpolate_padded as port_entry
    from gimmvfi_tpu_torch.ops.pad import InputPadder

    port, ref = models("r", torch.bfloat16)
    _, ref32 = models("r", None)
    a, b = pair(2)
    pf, _ = port_entry(port, InputPadder(a.shape[:2], divisor=32), a, b, [0.5], None)
    rf, _ = interpolate_padded(ref, a, b, [0.5], None)
    tf, _ = interpolate_padded(ref32, a, b, [0.5], None)
    assert np.abs(pf - rf).max() < 0.2 * np.abs(pf - tf).max()


def imports_of(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").glob("*.py")):
        for name in imports_of(path):
            assert name.split(".")[0] in ("torch", "numpy", "math", "typing", "dataclasses",
                                          "__future__"), (path.name, name)
    code = ("import sys; import port_bench.reference.gimmvfi; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout
    assert "gimmvfi_tpu_torch" not in out and "'gimmvfi_tpu'" not in out and "jax" not in out
