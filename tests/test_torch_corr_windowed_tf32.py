"""The float32 tensor-core windowed-correlation kernel's arithmetic, walk,
variants and wrapper, on the CPU.

`csrc/windowed_corr_tf32.cu` walks the tile union as
`csrc/windowed_corr_mma.cu` does and takes its dots in 3xTF32: each operand
split into big = rna(x) and small = rna(x - big), TF32 values rounded to
nearest with ties away from zero (`cvt.rna.tf32.f32`), and big*big +
small*big + big*small summed in float32. `tools/windowed_ablate.py:
mma_tile_walk` with `dot=split_tf32_dot` models that in plain torch; it is
held against `windowed_corr_lookup_plain` and against JAX
`windowed_corr_lookup` at <= 1e-5 * max|plain| (ROADMAP C3's float32
tolerance), NaN at the same places. One pass of TF32 misses that bound, so
the tests tell the two apart. Inputs come from a seeded numpy generator.
The kernel itself runs only on the card (its cases are in
`tests/test_torch_corr_windowed.py`, `cuda` marker).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gimmvfi_tpu.ops import corr as jcorr
from gimmvfi_tpu_torch.ops import corr as tcorr
from gimmvfi_tpu_torch.tools import windowed_ablate
from gimmvfi_tpu_torch.utils.kernel_build import CSRC
from test_torch_corr_windowed_mma import SHAPE, _inputs, _torch

torch.set_num_threads(1)
KINDS = ["in_frame", "smooth", "span", "border", "far"]
RADII_LEVELS = [(4, 4), (3, 2), (1, 1)]
SOURCE = CSRC / "windowed_corr_tf32.cu"


def _bound_and_err(got, ref):
    """(max-abs error off the NaNs, 1e-5 * max|plain|); NaN at the same
    places is asserted."""
    assert got.shape == ref.shape and got.dtype == ref.dtype == torch.float32
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    if bool(nan.all()):
        return 0.0, 0.0
    return float((got[~nan] - ref[~nan]).abs().max()), 1e-5 * float(ref[~nan].abs().max())


def test_tf32_rna_rounds_to_nearest_ties_away():
    """10 mantissa bits kept: below half a TF32 step rounds down, half a
    step rounds away from zero (either sign), a step and a half up to two;
    rounding may carry into the exponent; non-finite values pass."""
    step = 2.0**-10
    x = torch.tensor([1.0, 1 + step / 4, 1 + step / 2, -(1 + step / 2), 1 + 1.5 * step,
                      2 - step / 2, 3.0 * 2**-130, float("nan"), float("inf"), -float("inf")])
    got = windowed_ablate.tf32_rna(x)
    want = [1.0, 1.0, 1 + step, -(1 + step), 1 + 2 * step, 2.0, 3.0 * 2**-130]
    assert got[:7].tolist() == want
    assert math.isnan(got[7]) and got[8:].tolist() == [float("inf"), -float("inf")]
    # every result is a TF32 value: its 13 low bits are zero
    r = windowed_ablate.tf32_rna(torch.from_numpy(np.random.default_rng(0).standard_normal(1000, dtype=np.float32)))
    assert int((r.view(torch.int32) & 0x1FFF).abs().sum()) == 0


@pytest.mark.parametrize("c", [8, 24, 64, 200, 256])
def test_split_tf32_dot_is_float32_exact(rng, c):
    """Against float64 sums: 3xTF32 within 2**-20 of the largest product
    sum's scale (float32 sums round at 2**-24 a step); 1xTF32 off by more
    than 2**-14."""
    a = torch.from_numpy(rng.standard_normal((16, c), dtype=np.float32) / math.sqrt(c))
    pix = torch.from_numpy(rng.standard_normal((3, 8, c), dtype=np.float32))
    exact = torch.einsum("qc,kpc->qkp", a.double(), pix.double())
    scale = float(torch.einsum("qc,kpc->qkp", a.double().abs(), pix.double().abs()).max())
    three = (windowed_ablate.split_tf32_dot(a, pix).double() - exact).abs().max()
    one = (windowed_ablate.one_pass_tf32_dot(a, pix).double() - exact).abs().max()
    assert float(three) <= 2.0**-20 * scale
    assert float(one) > 2.0**-14 * scale


@pytest.mark.parametrize("radius,levels", RADII_LEVELS)
@pytest.mark.parametrize("c", [8, 24, 256])
@pytest.mark.parametrize("kind", KINDS)
def test_tf32_walk_matches_plain(rng, kind, c, radius, levels):
    """The walk with 3xTF32 dots against the plain lookup, a row of 23
    queries (a full tile and a short one), odd level sizes."""
    wc, coords = _torch(*_inputs(rng, SHAPE, c, kind), levels)
    got, _ = windowed_ablate.mma_tile_walk(wc, coords, radius, dot=windowed_ablate.split_tf32_dot)
    err, bound = _bound_and_err(got, tcorr.windowed_corr_lookup_plain(wc, coords, radius))
    assert err <= bound


@pytest.mark.parametrize("c,radius,levels", [(256, 4, 4), (24, 3, 2), (8, 1, 1)])
@pytest.mark.parametrize("kind", KINDS)
def test_tf32_walk_matches_jax(rng, kind, c, radius, levels):
    """The walk with 3xTF32 dots against JAX's float32 windowed lookup."""
    f1, f2, coords = _inputs(rng, SHAPE, c, kind)
    jwc = jcorr.windowed_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), levels)
    ref = torch.from_numpy(np.array(jcorr.windowed_corr_lookup(jwc, jnp.asarray(coords), radius)))
    wc, tcoords = _torch(f1, f2, coords, levels)
    got, _ = windowed_ablate.mma_tile_walk(wc, tcoords, radius, dot=windowed_ablate.split_tf32_dot)
    plain = tcorr.windowed_corr_lookup_plain(wc, tcoords, radius)
    err, bound = _bound_and_err(got.permute(0, 2, 3, 1), ref)
    _, plain_bound = _bound_and_err(plain.permute(0, 2, 3, 1), ref)
    assert err <= plain_bound
    assert bound == pytest.approx(plain_bound, rel=1e-5)


@pytest.mark.parametrize("kind", ["in_frame", "smooth"])
def test_one_pass_tf32_misses_the_float32_bound(rng, kind):
    """At C = 256, 1xTF32 dots miss 1e-5 * max|plain| where 3xTF32 keeps
    it: the tolerance tells the two apart."""
    wc, coords = _torch(*_inputs(rng, SHAPE, 256, kind), 4)
    ref = tcorr.windowed_corr_lookup_plain(wc, coords, 4)
    one, _ = windowed_ablate.mma_tile_walk(wc, coords, 4, dot=windowed_ablate.one_pass_tf32_dot)
    three, _ = windowed_ablate.mma_tile_walk(wc, coords, 4, dot=windowed_ablate.split_tf32_dot)
    err_one, bound = _bound_and_err(one, ref)
    err_three, _ = _bound_and_err(three, ref)
    assert err_three <= bound < err_one


@pytest.mark.parametrize("name", list(windowed_ablate.tf32_variants(SOURCE.read_text())))
def test_tf32_variants_apply_to_the_source(name):
    """Every variant of `--tf32` builds from the source by substitutions
    that each match once: the stage configurations set the three constants,
    the ablations keep the launcher and the configuration; none of the
    ablations' substitutions match the bf16 kernel."""
    src = SOURCE.read_text()
    text, computes = windowed_ablate.tf32_variants(src)[name]
    assert (text == src) == (name == "tf32")
    assert 'extern "C" int windowed_corr_tf32_lookup(' in text
    assert computes == (name not in windowed_ablate.TF32_ABLATIONS)
    if name in windowed_ablate.TF32_CONFIGS:
        assert windowed_ablate.tf32_config(text) == windowed_ablate.TF32_CONFIGS[name]
    elif name != "tf32":
        assert windowed_ablate.tf32_config(text) == windowed_ablate.tf32_config(src)
        with pytest.raises(ValueError, match="occurs 0 times"):
            windowed_ablate.tf32_variant_source(name, (CSRC / "windowed_corr_mma.cu").read_text())


def test_tf32_source_config_is_one_of_the_measured():
    """The source is built with one of the configurations `--tf32` times."""
    assert windowed_ablate.tf32_config(SOURCE.read_text()) in windowed_ablate.TF32_CONFIGS.values()


def test_f32_lookup_bounds_take_each_kernels_units(rng):
    """The 3xTF32 kernel's bound is its bytes or three TF32 products a
    float32 one at the TF32 tensor-core peak, whichever is later; the
    CUDA-core kernel's is the float32 operations at the CUDA-core peak; the
    tensor-core bound is never the later one."""
    wc, coords = _torch(*_inputs(rng, SHAPE, 256, "in_frame"), 4)
    bounds = windowed_ablate.f32_lookup_bounds(wc, coords)
    nbytes, flops = tcorr.windowed_corr_work(wc, coords)
    assert (bounds["bytes"], bounds["flops"]) == (nbytes, flops)
    by_bytes, tf32_ops = 1e3 * nbytes / 3.35e12, 1e3 * 3 * flops / 495e12
    assert bounds["tf32"] == (pytest.approx(max(by_bytes, tf32_ops)),
                              "operations" if tf32_ops > by_bytes else "bytes")
    assert bounds["cuda_core"][0] == pytest.approx(max(by_bytes, 1e3 * flops / 67e12))
    assert bounds["tf32"][0] <= bounds["cuda_core"][0]


def test_tf32_wrapper_refuses_bf16():
    """A bf16 state never reaches the float32 kernel; the route sends it
    float32 only."""
    wc = tcorr.windowed_corr_pyramid(torch.zeros(1, 16, 8, 8, dtype=torch.bfloat16),
                                     torch.zeros(1, 16, 8, 8, dtype=torch.bfloat16), 2)
    before = tcorr.WINDOWED_CORR_TF32_KERNEL.launches
    with pytest.raises(TypeError, match="f1 must be float32"):
        tcorr.WINDOWED_CORR_TF32_KERNEL(wc, torch.zeros(1, 2, 8, 8))
    assert tcorr.WINDOWED_CORR_TF32_KERNEL.launches == before
    assert tcorr.windowed_corr_kernel_for(torch.float32) is tcorr.WINDOWED_CORR_TF32_KERNEL
    assert tcorr.WINDOWED_CORR_TF32_KERNEL.name == "windowed_corr_tf32"


def test_tf32_extent_summary_counts_three_mma_a_k_step():
    """In float32 the summary counts float32 bytes staged and three m16n8k8
    `mma` a k-step of 8 channels; bf16 keeps its m16n8k16 count."""
    ext = {"rows": torch.tensor([[[[2]]]]), "blocks": torch.tensor([[[[5]]]]),
           "pixels": torch.tensor([[[[33]]]])}
    f32 = windowed_ablate.extent_summary(ext, 256, 4)
    bf16 = windowed_ablate.extent_summary(ext, 256)
    assert (f32["staged_bytes"], f32["mma"]) == (33 * 256 * 4, 5 * 3 * 32)
    assert (bf16["staged_bytes"], bf16["mma"]) == (33 * 256 * 2, 5 * 16)


def test_tf32_main_needs_the_card():
    """Off the card `--tf32` raises instead of running anything."""
    if torch.cuda.is_available():
        pytest.skip("runs on a CPU-only machine")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        windowed_ablate.main_tf32()
