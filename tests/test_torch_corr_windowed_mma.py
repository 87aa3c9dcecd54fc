"""The tensor-core windowed-correlation kernel's decomposition, route and
ablations, on the CPU.

`tools/windowed_ablate.py: mma_tile_walk` computes the lookup the way
`csrc/windowed_corr_mma.cu` does: 16-query tiles of one image row, the
clipped union of their live windows walked one row at a time in 8-pixel
blocks, (16 x C) @ (C x 8) products scattered into each query's sums, then
the blend. Held against `windowed_corr_lookup_plain` in float32 at
<= 1e-5 of the largest value (sums in another order), NaN at the same
places; once against JAX `windowed_corr_lookup` too. Inputs come from a
seeded numpy generator. The kernel itself runs only on the card (its cases
are in `tests/test_torch_corr_windowed.py`, `cuda` marker).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gimmvfi_tpu.ops import corr as jcorr
from gimmvfi_tpu_torch.ops import corr as tcorr
from gimmvfi_tpu_torch.tools import windowed_ablate
from gimmvfi_tpu_torch.tools.splat_ablate import smooth_flow
from gimmvfi_tpu_torch.utils.kernel_build import CSRC

torch.set_num_threads(1)
SHAPE = (2, 13, 23)  # a row of 23 queries: a full tile and a short one; levels 6x11, 3x5, 1x2


def _coords(rng, n, h, w, kind):
    """(N, H, W, 2) pixel coordinates: uniform in the frame, the grid plus a
    smooth flow, uniform off the frame by up to 7 px, around the border, or
    far off it with NaN and inf mixed in."""
    grid = np.stack(np.meshgrid(np.arange(w), np.arange(h), indexing="xy"), axis=-1)
    if kind == "in_frame":
        out = rng.random((n, h, w, 2)) * [w - 1, h - 1]
    elif kind == "smooth":
        out = grid + smooth_flow(rng, n, h, w, 4.0, coarse=(2, 3))
    elif kind == "span":
        out = rng.random((n, h, w, 2)) * [w + 14, h + 14] - 7
    elif kind == "border":
        edge = rng.choice([-4.5, -1.25, -0.5, 0.0, 0.75], size=(n, h, w, 2))
        out = np.where(rng.random((n, h, w, 2)) < 0.5, np.array([w, h]) - 1 - edge, edge)
    elif kind == "far":
        out = rng.choice([-1e3, 1e3, -1e10, 1e10, 3.5], size=(n, h, w, 2))
        bad = rng.random((n, h, w, 2)) < 0.1
        out[bad] = rng.choice([np.nan, np.inf, -np.inf], size=int(bad.sum()))
    else:
        raise ValueError(kind)
    return out.astype(np.float32)


def _inputs(rng, shape, c, kind):
    """Seeded float32 maps (N, H, W, C) and coordinates (N, H, W, 2)."""
    n, h, w = shape
    f1, f2 = (rng.standard_normal((n, h, w, c), dtype=np.float32) for _ in range(2))
    return f1, f2, _coords(rng, n, h, w, kind)


def _torch(f1, f2, coords, levels):
    nchw = lambda x: torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)  # noqa: E731
    return tcorr.windowed_corr_pyramid(nchw(f1), nchw(f2), levels), nchw(coords).contiguous()


def _walk_agrees(wc, coords, radius):
    """The tile walk against the plain lookup; its extents against the
    vectorised `mma_tile_extents`. Returns the extents."""
    got, extents = windowed_ablate.mma_tile_walk(wc, coords, radius)
    ref = tcorr.windowed_corr_lookup_plain(wc, coords, radius)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    assert bool(torch.isfinite(coords).all()) == (not bool(nan.any()))
    if not bool(nan.all()):
        bound = 1e-5 * float(ref[~nan].abs().max())
        assert float((got[~nan] - ref[~nan]).abs().max()) <= bound
    fast = windowed_ablate.mma_tile_extents(wc, coords, radius)
    for key in windowed_ablate.EXTENT_KEYS:
        assert torch.equal(fast[key], extents[key]), key
    return extents


@pytest.mark.parametrize("radius,levels", [(4, 4), (3, 2), (1, 1), (5, 4), (8, 2), (2, 6)])
@pytest.mark.parametrize("kind", ["in_frame", "smooth", "span", "border", "far"])
def test_tile_walk_matches_plain(rng, kind, radius, levels):
    """C = 24 (K padded to 32), odd level sizes, a row of 23 queries; the
    kernels' general case (`tap_tiles`) at radius 5 and 8 and at 6 levels
    (the last two 0x1 and 0x0 maps)."""
    wc, coords = _torch(*_inputs(rng, SHAPE, 24, kind), levels)
    extents = _walk_agrees(wc, coords, radius)
    assert extents["rows"].shape == (levels, 2, 13, 2)


@pytest.mark.parametrize("c", [8, 24, 256])
def test_tile_walk_channels(rng, c):
    """C = 8 and 24 (K zero-padded to 16 and 32) and the path's 256."""
    wc, coords = _torch(*_inputs(rng, (1, 11, 21), c, "smooth"), 4)
    _walk_agrees(wc, coords, 4)


def test_tile_walk_matches_jax(rng):
    f1, f2, coords = _inputs(rng, SHAPE, 24, "span")
    jwc = jcorr.windowed_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    ref = np.asarray(jcorr.windowed_corr_lookup(jwc, jnp.asarray(coords), 4))
    wc, tcoords = _torch(f1, f2, coords, 4)
    got, _ = windowed_ablate.mma_tile_walk(wc, tcoords, 4)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=0, atol=1e-5)


def test_tile_extents_on_the_grid():
    """Coordinates on the grid (zero flow, r = 4): an interior tile's level-0
    union is 10 rows of 15 + 10 = 25 columns, 4 blocks of 8 a row; level 1
    halves the tile's spread (8 + 9 = 17 columns, 3 blocks)."""
    n, h, w = 1, 40, 64
    grid = torch.stack(torch.meshgrid(torch.arange(w), torch.arange(h), indexing="xy")).float()
    wc = tcorr.windowed_corr_pyramid(torch.zeros(n, 8, h, w), torch.zeros(n, 8, h, w), 2)
    ext = windowed_ablate.mma_tile_extents(wc, grid[None], 4)
    assert (ext["rows"][0, 0, 20, 1], ext["pixels"][0, 0, 20, 1], ext["blocks"][0, 0, 20, 1]) == (10, 250, 40)
    assert (ext["rows"][1, 0, 20, 1], ext["pixels"][1, 0, 20, 1], ext["blocks"][1, 0, 20, 1]) == (10, 170, 30)
    summary = windowed_ablate.extent_summary(ext, 8)
    assert summary["mma"] == int(ext["blocks"].sum()) and summary["staged_bytes"] == 16 * int(ext["pixels"].sum())
    assert 8.0 <= summary["rows0"] <= 10.0 and 16.0 <= summary["cols0"] <= 32.0


@pytest.mark.parametrize("name", list(windowed_ablate.MMA_ABLATIONS))
def test_mma_ablations_apply_to_the_new_source(name):
    """Each substitution of an ablation matches `windowed_corr_mma.cu` once."""
    src = (CSRC / "windowed_corr_mma.cu").read_text()
    out = windowed_ablate.variant_source(name, src)
    assert out != src and 'extern "C" int windowed_corr_mma_lookup(' in out
    with pytest.raises(ValueError, match="occurs 0 times"):
        windowed_ablate.variant_source(name, (CSRC / "windowed_corr.cu").read_text())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16, torch.float64])
def test_route_picks_the_kernel_by_dtype(dtype):
    """A CUDA lookup goes to the bf16 tensor-core kernel in bf16 and to the
    3xTF32 tensor-core kernel in float32 (the CUDA-core kernel takes no
    route); any other dtype raises, with no fallback."""
    expected = {torch.bfloat16: tcorr.WINDOWED_CORR_MMA_KERNEL,
                torch.float32: tcorr.WINDOWED_CORR_TF32_KERNEL}.get(dtype)
    if expected is None:
        with pytest.raises(TypeError, match="no windowed correlation kernel"):
            tcorr.windowed_corr_kernel_for(dtype)
    else:
        assert tcorr.windowed_corr_kernel_for(dtype) is expected


def test_route_on_the_cpu_and_elsewhere():
    """CPU tensors take the plain version (no kernel launches); a device
    with no lookup raises."""
    kernels = (tcorr.WINDOWED_CORR_MMA_KERNEL, tcorr.WINDOWED_CORR_KERNEL,
               tcorr.WINDOWED_CORR_TF32_KERNEL)
    before = [k.launches for k in kernels]
    wc = tcorr.windowed_corr_pyramid(torch.ones(1, 8, 4, 4, dtype=torch.bfloat16),
                                     torch.ones(1, 8, 4, 4, dtype=torch.bfloat16), 1)
    out = tcorr.windowed_corr_lookup(wc, torch.zeros(1, 2, 4, 4), 1)
    assert out.dtype == torch.bfloat16 and [k.launches for k in kernels] == before
    with pytest.raises(NotImplementedError, match="meta"):
        tcorr.windowed_corr_lookup(wc, torch.zeros(1, 2, 4, 4, device="meta"), 1)


@pytest.mark.parametrize("kernel", ["WINDOWED_CORR_MMA_KERNEL", "WINDOWED_CORR_KERNEL",
                                    "WINDOWED_CORR_TF32_KERNEL"])
def test_wrapper_binds_every_launcher_argument(kernel):
    """The ctypes argument list has one entry for each parameter of the
    source's `extern "C"` launcher (the last is the stream)."""
    k = getattr(tcorr, kernel)
    src = (CSRC / k.source.split("/")[-1]).read_text()
    params = re.search(rf'extern "C" int {k.symbol}\(([^)]*)\)', src).group(1)
    assert len(params.split(",")) == len(k.argtypes)
