"""Port ops (gimmvfi_tpu_torch) against the JAX reference ops, on the CPU.

Inputs come from a seeded numpy generator and feed both sides. The port's
internals are NCHW, the reference's NHWC; the helpers below transpose.
Tolerance: max-abs 1e-5 (float32 rounding of differently ordered sums).
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gimmvfi_tpu.nn import layers as jl
from gimmvfi_tpu.ops import coords as jc
from gimmvfi_tpu.ops import corr as jcorr
from gimmvfi_tpu.ops import interp as ji
from gimmvfi_tpu_torch.nn import layers as tl
from gimmvfi_tpu_torch.ops import coords as tc
from gimmvfi_tpu_torch.ops import corr as tcorr
from gimmvfi_tpu_torch.ops import interp as ti

torch.set_num_threads(1)
ATOL = 1e-5


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def close(got, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0, atol=atol)


def test_coords_grid():
    close(nhwc(tc.coords_grid(2, 5, 7, "cpu")), jc.coords_grid(2, 5, 7))


def test_normalize_unnormalize_flow(rng):
    flows = (rng.standard_normal((2, 2, 6, 8, 2)) * 5).astype(np.float32)
    ref, ref_s = jc.normalize_flow(jnp.asarray(flows))
    got, got_s = tc.normalize_flow(torch.from_numpy(flows).permute(0, 1, 4, 2, 3))
    close(got.permute(0, 1, 3, 4, 2), ref)
    close(got_s, ref_s)
    close(tc.unnormalize_flow(got, got_s).permute(0, 1, 3, 4, 2),
          jc.unnormalize_flow(ref, ref_s))


@pytest.mark.parametrize("t_values", [0.3, [0.25, 0.75]])
def test_sample_coords_3d(t_values):
    ref = jc.sample_coords_3d(2, (6, 10), t_values)
    got = tc.sample_coords_3d(2, (6, 10), t_values, "cpu")
    assert got.shape == ref.shape
    close(got, ref)


def test_warp(rng):
    img = rng.random((2, 12, 16, 5), dtype=np.float32)
    flow = (rng.standard_normal((2, 12, 16, 2)) * 4).astype(np.float32)
    close(nhwc(ti.warp(nchw(img), nchw(flow))), ji.warp(jnp.asarray(img), jnp.asarray(flow)))


def test_bilinear_sampler(rng):
    img = rng.random((2, 10, 14, 3), dtype=np.float32)
    coords = (rng.random((2, 6, 9, 2)) * np.array([18, 14]) - 2).astype(np.float32)
    got = ti.bilinear_sampler(nchw(img), torch.from_numpy(coords))
    close(nhwc(got), ji.bilinear_sampler(jnp.asarray(img), jnp.asarray(coords)))


@pytest.mark.parametrize("scale", [0.25, 2.0, 4.0])
def test_resize_scale_factor(rng, scale):
    img = rng.standard_normal((1, 24, 20, 3)).astype(np.float32)
    ref = ji.resize(jnp.asarray(img), scale)
    got = nhwc(ti.resize(nchw(img), scale))
    assert got.shape == ref.shape
    close(got, ref)


def test_resize_bilinear_size(rng):
    img = rng.standard_normal((1, 7, 11, 4)).astype(np.float32)
    ref = ji.resize_bilinear(jnp.asarray(img), (20, 31))
    close(nhwc(ti.resize_bilinear(nchw(img), (20, 31))), ref)


def test_pixel_shuffle_channel_order(rng):
    x = rng.standard_normal((1, 3, 5, 16)).astype(np.float32)
    close(nhwc(tl.pixel_shuffle(nchw(x), 2)), jl.pixel_shuffle(jnp.asarray(x), 2), atol=0)


def test_instance_norm(rng):
    x = (rng.standard_normal((2, 9, 7, 6)) * 3 + 1).astype(np.float32)
    close(nhwc(tl.instance_norm(nchw(x))), jl.instance_norm(jnp.asarray(x)))


def test_all_pairs_corr_and_bidir_pyramid(rng):
    f1 = rng.standard_normal((1, 16, 16, 8)).astype(np.float32)
    f2 = rng.standard_normal((1, 16, 16, 8)).astype(np.float32)
    close(tcorr.all_pairs_corr(nchw(f1), nchw(f2)),
          jcorr.all_pairs_corr(jnp.asarray(f1), jnp.asarray(f2)))
    ref_f, ref_b = jcorr.bidir_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2))
    got_f, got_b = tcorr.bidir_corr_pyramid(nchw(f1), nchw(f2))
    for got, ref in zip(got_f + got_b, ref_f.levels + ref_b.levels):
        assert got.shape == ref.shape
        close(got, ref)


def test_corr_lookup_channel_order(rng):
    f1 = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    f2 = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    grid = np.asarray(jc.coords_grid(2, 16, 16))
    coords = (grid + rng.standard_normal(grid.shape) * 3).astype(np.float32)
    ref = jcorr.corr_lookup(jcorr.corr_pyramid(jnp.asarray(f1), jnp.asarray(f2)),
                            jnp.asarray(coords))
    got = tcorr.corr_lookup(tcorr.corr_pyramid(nchw(f1), nchw(f2)), nchw(coords))
    close(nhwc(got), ref)


@pytest.mark.parametrize("build", [tcorr.corr_pyramid_auto, tcorr.bidir_corr_pyramid_auto])
def test_windowed_volume_raises(build):
    f = torch.zeros(1, 1, 64, 64)
    with pytest.raises(NotImplementedError, match="windowed correlation"):
        build(f, f, max_volume_bytes=1000)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys, gimmvfi_tpu_torch\n"
        "for m in pkgutil.walk_packages(gimmvfi_tpu_torch.__path__, 'gimmvfi_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'flax', 'gimmvfi_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=Path(__file__).resolve().parents[1])
