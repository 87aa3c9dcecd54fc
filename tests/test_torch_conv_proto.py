"""The port's conv probe (`gimmvfi_tpu_torch/tools/conv_proto.py`) against
the JAX probe (`tools/conv_pallas_proto.py`), on the CPU.

`conv3x3_plain`, what a CPU tensor runs, is held against the probe's
`conv3x3_xla` and its Pallas kernel `conv3x3_pallas` (variants A and B, in
interpret mode) at (1,16,24,256) bf16, and against
`jax.lax.conv_general_dilated` at a ragged shape. bf16 bound, elementwise:
|got - ref| <= 2**-6 |ref| + 1e-4 max|ref| (two bf16 roundings of f32 sums
taken in another order, plus slack near zero). float32: 1e-5 max|ref|.

The CUDA kernel itself runs only on the card (`cuda` marker). On the CPU a
model of its tile walk (128-pixel x 256-channel tiles, K steps of one tap
and 64 input channels, boxes read with TMA's zero fill outside the tensor,
the weights as `kernel_weights` repacks them) is held against the plain
version, and the wrapper's tile sizes against the source's.
"""

import functools
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gimmvfi_tpu_torch.tools import conv_ablate, conv_proto
from gimmvfi_tpu_torch.tools.conv_proto import (
    CONV3X3_KERNEL,
    TILE_CHANNELS,
    TILE_PIXELS,
    conv3x3,
    conv3x3_plain,
    kernel_weights,
    probe_inputs,
)
from gimmvfi_tpu_torch.utils.kernel_build import CSRC
from gimmvfi_tpu_torch.utils.timing import device_ms

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


K_CHUNK = 64  # input channels a K step reads (kBK in conv3x3.cu)


def _box(t: torch.Tensor, starts, sizes) -> torch.Tensor:
    """A TMA box: t[starts[i] : starts[i] + sizes[i]] along each dim, with
    zeros wherever the box leaves the tensor (negative starts included)."""
    out = torch.zeros(sizes, dtype=t.dtype)
    src, dst = [], []
    for start, size, dim in zip(starts, sizes, t.shape):
        lo, hi = max(start, 0), min(start + size, dim)
        if lo >= hi:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - start, hi - start))
    out[tuple(dst)] = t[tuple(src)]
    return out


def _tile_walk(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's implicit GEMM on the CPU: per tile (row, 128 pixels,
    256 channels) and K step (tap, 64 input channels), the A box at
    (n, y + dy - 1, x0 + dx - 1, c0) times the B box at (tap, co0, c0) of
    `kernel_weights(w)`, summed in float32, written where the tile is in
    the output."""
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    wt = kernel_weights(w).reshape(9, cout, cin).float()
    xf = x.float()
    out = torch.full((n, h, wd, cout), float("nan"))
    for img in range(n):
        for y in range(h):
            for x0 in range(0, wd, TILE_PIXELS):
                for co0 in range(0, cout, TILE_CHANNELS):
                    acc = torch.zeros(TILE_PIXELS, TILE_CHANNELS)
                    for tap in range(9):
                        dy, dx = divmod(tap, 3)
                        for c0 in range(0, cin, K_CHUNK):
                            a = _box(xf, (img, y + dy - 1, x0 + dx - 1, c0),
                                     (1, 1, TILE_PIXELS, K_CHUNK))[0, 0]
                            b = _box(wt, (tap, co0, c0), (1, TILE_CHANNELS, K_CHUNK))[0]
                            acc += a @ b.T
                    px, co = min(TILE_PIXELS, wd - x0), min(TILE_CHANNELS, cout - co0)
                    out[img, y, x0:x0 + px, co0:co0 + co] = acc[:px, :co]
    return out


@pytest.mark.parametrize("shape,cout", [((1, 3, 130, 80), 96), ((2, 2, 5, 16), 272)])
def test_tile_walk_matches_plain(shape, cout):
    x, w = probe_inputs(shape, cout, seed=5, device="cpu")
    x, w = x.float(), w.float()
    ref = conv3x3_plain(x, w)
    got = _tile_walk(x, w)
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_kernel_weights_transpose_each_tap():
    _, w = probe_inputs((1, 2, 2, 32), cout=48, seed=6, device="cpu")
    wt = kernel_weights(w)
    assert wt.shape == (3, 3, 48, 32) and wt.is_contiguous()
    for dy in range(3):
        for dx in range(3):
            assert torch.equal(wt[dy, dx], w[dy, dx].T)


def test_kernel_source_matches_wrapper():
    """The wrapper's tile sizes are the kernel's, and the kernel is the
    TMA-fed, warp-specialised wgmma design with no warp-level mma left."""
    src = (CSRC / "conv3x3.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kBM"]) == TILE_PIXELS
    assert int(consts["kBN"]) == TILE_CHANNELS
    assert int(consts["kBK"]) == K_CHUNK
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.try_wait",
                   "setmaxnreg.dec", "setmaxnreg.inc", "gridDim.x"):
        assert needle in src, needle
    for gone in ("nvcuda::wmma", "mma.sync", "wmma::"):
        assert gone not in src, gone


@pytest.mark.parametrize("name", sorted(conv_ablate.VARIANTS))
def test_ablation_variants_apply_to_the_kernel_source(name):
    """Each ablation's substitutions still match the kernel source once, so
    `conv_ablate` builds what its docstring says."""
    src = (CSRC / "conv3x3.cu").read_text()
    out = conv_ablate.variant_source(name, src)
    assert (out == src) == (name == "kernel")


def test_probes_refuse_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for probe_main in (conv_proto.main, conv_ablate.main):
        with pytest.raises(RuntimeError, match="CUDA card"):
            probe_main()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout", [
    ((1, 17, 23, 256), 256), ((1, 5, 130, 48), 80),
    ((1, 1, 1, 16), 16), ((2, 9, 257, 64), 256), ((1, 7, 200, 80), 96),
])
def test_kernel_matches_plain_on_card(shape, cout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; run on the card")
    x, w = probe_inputs(shape, cout, seed=4, device="cuda")
    before = CONV3X3_KERNEL.launches
    got = conv3x3(x, w)
    torch.cuda.synchronize()
    assert CONV3X3_KERNEL.launches == before + 1
    _assert_bf16_close(got.float().cpu().numpy(), conv3x3_plain(x, w).float().cpu().numpy())


@pytest.mark.cuda
def test_profiler_device_time_names_the_kernel_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; run on the card")
    x, w = probe_inputs((1, 17, 23, 256), 256, seed=7, device="cuda")
    ms, by_name = device_ms(lambda: conv3x3(x, w), iters=3)
    assert ms is not None and ms > 0
    assert any("conv3x3_kernel" in name for name in by_name), list(by_name)
