"""The port's conv probe (`gimmvfi_tpu_torch/tools/conv_proto.py`) against
the JAX probe (`tools/conv_pallas_proto.py`), on the CPU.

`conv3x3_plain`, what a CPU tensor runs, is held against the probe's
`conv3x3_xla` and its Pallas kernel `conv3x3_pallas` (variants A and B, in
interpret mode) at (1,16,24,256) bf16, and against
`jax.lax.conv_general_dilated` at a ragged shape. bf16 bound, elementwise:
|got - ref| <= 2**-6 |ref| + 1e-4 max|ref| (two bf16 roundings of f32 sums
taken in another order, plus slack near zero). float32: 1e-5 max|ref|.
The CUDA kernel itself runs only on the card (`cuda` marker).
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gimmvfi_tpu_torch.tools.conv_proto import (
    CONV3X3_KERNEL,
    conv3x3,
    conv3x3_plain,
    probe_inputs,
)

torch.set_num_threads(1)
PROBE_PATH = Path(__file__).resolve().parents[1] / "tools" / "conv_pallas_proto.py"


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location("conv_pallas_proto", PROBE_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _to_jax(t: torch.Tensor):
    """The same values on the JAX side (bf16 through f32 is exact)."""
    dtype = jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(t.float().numpy()).astype(dtype)


def _assert_bf16_close(got, ref):
    got = np.asarray(got, dtype=np.float32)
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape
    limit = 2.0**-6 * np.abs(ref) + 1e-4 * np.abs(ref).max()
    assert (np.abs(got - ref) <= limit).all(), float(np.abs(got - ref).max())


@pytest.mark.parametrize("reference", ["xla", "pallas_A", "pallas_B"])
def test_plain_matches_jax_probe(probe, monkeypatch, reference):
    x, w = probe_inputs((1, 16, 24, 256), seed=0, device="cpu")
    xj, wj = _to_jax(x), _to_jax(w)
    if reference == "xla":
        ref = probe.conv3x3_xla(xj, wj)
    else:
        orig = probe.pl.pallas_call
        monkeypatch.setattr(probe.pl, "pallas_call", functools.partial(orig, interpret=True))
        ref = probe.conv3x3_pallas(xj, wj, h=16, w=24, variant=reference[-1])
    got = conv3x3_plain(x, w)
    assert got.dtype == torch.bfloat16
    _assert_bf16_close(got.float().numpy(), ref.astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_matches_lax_conv_ragged(probe, dtype):
    x, w = probe_inputs((2, 5, 7, 32), cout=48, seed=1, device="cpu")
    x, w = x.to(dtype), w.to(dtype)
    got = conv3x3_plain(x, w).float().numpy()
    if dtype == torch.float32:
        ref = jax.lax.conv_general_dilated(
            _to_jax(x), _to_jax(w), (1, 1), [(1, 1), (1, 1)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=jax.lax.Precision.HIGHEST,
        )
        ref = np.asarray(ref)
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    else:
        _assert_bf16_close(got, probe.conv3x3_xla(_to_jax(x), _to_jax(w)).astype(jnp.float32))


def test_cpu_tensor_takes_plain_version():
    x, w = probe_inputs((1, 6, 9, 16), cout=32, seed=2, device="cpu")
    before = CONV3X3_KERNEL.launches
    got = conv3x3(x, w)
    assert CONV3X3_KERNEL.launches == before
    assert torch.equal(got, conv3x3_plain(x, w))


def test_kernel_wrapper_refuses_cpu_tensors():
    x, w = probe_inputs((1, 4, 4, 16), seed=3, device="cpu")
    before = CONV3X3_KERNEL.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        CONV3X3_KERNEL(x, w)
    assert CONV3X3_KERNEL.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout", [((1, 17, 23, 256), 256), ((1, 5, 130, 48), 80)])
def test_kernel_matches_plain_on_card(shape, cout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; run on the card")
    x, w = probe_inputs(shape, cout, seed=4, device="cuda")
    before = CONV3X3_KERNEL.launches
    got = conv3x3(x, w)
    torch.cuda.synchronize()
    assert CONV3X3_KERNEL.launches == before + 1
    _assert_bf16_close(got.float().cpu().numpy(), conv3x3_plain(x, w).float().cpu().numpy())
