"""The port's windowed correlation against JAX `gimmvfi_tpu.ops.corr`, on the CPU.

Inputs come from a seeded numpy generator and feed both sides (NHWC for
JAX, NCHW for the port). Tolerances (ROADMAP C4):
  * float32 pyramid and plain lookup vs JAX: max-abs <= 1e-5 (float32 sums
    taken in another order);
  * bf16 vs JAX: both accumulate in float32 and cast once, so they differ
    only where a sum's order flips a rounding; asserted >= 45 dB against the
    largest value (measured: equal or within one bf16 step);
  * windowed vs the port's materialized lookup, float32: <= 1e-4 of the
    largest value (the identity of corr.py:185-202, summed in other orders).
The CUDA kernels run only on the card (`cuda` marker): a bf16 lookup goes to
the bf16 tensor-core kernel, a float32 one to the 3xTF32 tensor-core kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gimmvfi_tpu.ops import corr as jcorr
from gimmvfi_tpu_torch.ops import corr as tcorr
from gimmvfi_tpu_torch.tools import windowed_ablate
from gimmvfi_tpu_torch.tools.splat_ablate import smooth_flow
from gimmvfi_tpu_torch.tools.windowed_ablate import windowed_agreement, windowed_inputs
from gimmvfi_tpu_torch.utils.kernel_build import CSRC

torch.set_num_threads(1)
ATOL = 1e-5


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy()


def _maps(rng, n, h, w, c):
    return (rng.standard_normal((n, h, w, c), dtype=np.float32),
            rng.standard_normal((n, h, w, c), dtype=np.float32))


def _coords(rng, n, h, w, kind):
    """(N, H, W, 2) pixel coordinates: in the frame, the grid plus a smooth
    flow, around its border, or far off it with non-finite values mixed in."""
    if kind == "in_frame":
        return (rng.random((n, h, w, 2)) * [w - 1, h - 1]).astype(np.float32)
    if kind == "smooth":
        grid = np.stack(np.meshgrid(np.arange(w), np.arange(h), indexing="xy"), axis=-1)
        return (grid + smooth_flow(rng, n, h, w, 4.0, coarse=(2, 3))).astype(np.float32)
    if kind == "span":  # in-bounds, sub-pixel and off the frame by up to 7 px
        return (rng.random((n, h, w, 2)) * (w + 14) - 7).astype(np.float32)
    if kind == "border":
        edge = rng.choice([-4.5, -1.25, -0.5, 0.0, 0.75], size=(n, h, w, 2))
        far = rng.random((n, h, w, 2)) < 0.5
        return np.where(far, np.array([w, h]) - 1 - edge, edge).astype(np.float32)
    if kind == "far":
        out = rng.choice([-1e3, 1e3, -1e10, 1e10, 3.5], size=(n, h, w, 2)).astype(np.float32)
        bad = rng.random((n, h, w, 2)) < 0.1
        out[bad] = rng.choice([np.nan, np.inf, -np.inf], size=int(bad.sum()))
        return out
    raise ValueError(kind)


def _both(f1, f2, coords, radius, levels, jdt=jnp.float32, tdt=torch.float32):
    wc = jcorr.windowed_corr_pyramid(jnp.asarray(f1).astype(jdt), jnp.asarray(f2).astype(jdt),
                                     levels)
    ref = jcorr.windowed_corr_lookup(wc, jnp.asarray(coords), radius)
    twc = tcorr.windowed_corr_pyramid(nchw(f1).to(tdt), nchw(f2).to(tdt), levels)
    got = tcorr.windowed_corr_lookup(twc, nchw(coords), radius)
    assert got.dtype == tdt and got.shape[1] == levels * (2 * radius + 1) ** 2
    return wc, twc, np.asarray(ref.astype(jnp.float32)), nhwc(got)


@pytest.mark.parametrize("radius,levels", [(4, 4), (3, 4), (3, 2), (1, 1), (5, 4), (8, 2), (4, 6)])
def test_windowed_pyramid_and_lookup_match_jax(rng, radius, levels):
    f1, f2 = _maps(rng, 2, 12, 17, 32)
    coords = _coords(rng, 2, 12, 17, "span")
    wc, twc, ref, got = _both(f1, f2, coords, radius, levels)
    np.testing.assert_allclose(twc.f1.numpy(), np.asarray(wc.f1), rtol=0, atol=ATOL)
    assert twc.shape_hw == wc.shape_hw
    for a, b in zip(twc.f2_levels, wc.f2_levels, strict=True):
        assert a.shape == b.shape and a.is_contiguous()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ATOL)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", ["border", "far"])
def test_windowed_lookup_off_the_frame_matches_jax(rng, kind):
    """Coordinates on the border, 1e3 and 1e10 px off the frame, and NaN or
    infinite: the same values, and NaN at the same places."""
    f1, f2 = _maps(rng, 1, 10, 14, 16)
    coords = _coords(rng, 1, 10, 14, kind)
    _, _, ref, got = _both(f1, f2, coords, 4, 4)
    nan = np.isnan(ref)
    assert np.array_equal(np.isnan(got), nan)
    assert (kind == "far") == bool(nan.any())
    np.testing.assert_allclose(got[~nan], ref[~nan], rtol=0, atol=ATOL)


def test_windowed_odd_level_sizes_match_jax(rng):
    """13x23 pools to 6x11, 3x5 and 1x2: the pooling floors odd sizes."""
    f1, f2 = _maps(rng, 1, 13, 23, 24)
    coords = _coords(rng, 1, 13, 23, "span")
    wc, twc, ref, got = _both(f1, f2, coords, 4, 4)
    assert [tuple(x.shape[1:3]) for x in twc.f2_levels] == [(13, 23), (6, 11), (3, 5), (1, 2)]
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_windowed_bf16_agrees_with_jax(rng):
    f1, f2 = _maps(rng, 2, 12, 17, 32)
    coords = _coords(rng, 2, 12, 17, "span")
    wc, twc, ref, got = _both(f1, f2, coords, 4, 4, jnp.bfloat16, torch.bfloat16)
    for a, b in zip(twc.f2_levels, wc.f2_levels, strict=True):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b.astype(jnp.float32)),
                                   rtol=2.0**-7, atol=0)
    mse = float(((got - ref) ** 2).mean())
    db = float("inf") if mse == 0 else 10 * np.log10(float(np.abs(ref).max()) ** 2 / mse)
    assert db >= 45.0, db


def test_windowed_matches_materialized_lookup(rng):
    """The port's two lookups agree: windowed == materialized (linearity)."""
    f1, f2 = _maps(rng, 2, 16, 20, 32)
    coords = nchw(_coords(rng, 2, 16, 20, "span"))
    mat = tcorr.corr_lookup(tcorr.corr_pyramid(nchw(f1), nchw(f2)), coords)
    win = tcorr.windowed_corr_lookup(tcorr.windowed_corr_pyramid(nchw(f1), nchw(f2)), coords)
    assert win.shape == mat.shape
    bound = 1e-4 * float(mat.abs().max())
    assert float((win - mat).abs().max()) <= bound


@pytest.mark.parametrize("bidir", [False, True])
def test_auto_dispatch_picks_windowed_above_the_limit(rng, bidir):
    """The JAX formula decides: at the limit materialized, one byte under
    it windowed; the lookups agree through the dispatchers. (16x18: the
    materialized sampler needs every level at least 2x2.)"""
    f1, f2 = (nchw(x) for x in _maps(rng, 1, 16, 18, 16))
    coords = nchw((rng.random((1, 16, 18, 2)) * 18).astype(np.float32))
    copies = 2 if bidir else 1
    vol = copies * 1 * 288 * 288 * 4 * 4 // 3
    build = tcorr.bidir_corr_pyramid_auto if bidir else tcorr.corr_pyramid_auto
    small, capped = build(f1, f2, max_volume_bytes=vol), build(f1, f2, max_volume_bytes=vol - 1)
    if bidir:
        assert not any(isinstance(s, tcorr.WindowedCorr) for s in small)
        assert all(isinstance(s, tcorr.WindowedCorr) for s in capped)
        pairs = zip(tcorr.bidir_corr_lookup(capped, coords, coords),
                    tcorr.bidir_corr_lookup(small, coords, coords))
    else:
        assert not isinstance(small, tcorr.WindowedCorr)
        assert isinstance(capped, tcorr.WindowedCorr)
        pairs = [(tcorr.corr_lookup_any(capped, coords), tcorr.corr_lookup_any(small, coords))]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=2e-5)


def test_windowed_work_counts_taps_on_the_map(rng):
    """`windowed_corr_work`: bytes from the shapes, and two operations a
    channel for each tap on its level's map, counted against a brute force."""
    n, h, w, c, r = 1, 9, 13, 8, 2
    f1, f2 = _maps(rng, n, h, w, c)
    coords = _coords(rng, n, h, w, "span")
    coords[0, 0, 0, 0] = np.nan
    wc = tcorr.windowed_corr_pyramid(nchw(f1), nchw(f2), 3)
    nbytes, ops = tcorr.windowed_corr_work(wc, nchw(coords), r)
    span = 2 * r + 2
    taps = 0
    for i, lvl in enumerate(wc.f2_levels):
        hl, wl = lvl.shape[1:3]
        for x, y in coords.reshape(-1, 2) / 2.0**i:
            if not np.isfinite([x, y]).all():
                continue
            xs = np.floor(x) - r + np.arange(span)
            ys = np.floor(y) - r + np.arange(span)
            taps += int(((xs >= 0) & (xs < wl)).sum() * ((ys >= 0) & (ys < hl)).sum())
    assert ops == 2 * c * taps
    out_bytes = n * 3 * (2 * r + 1) ** 2 * h * w * 4
    assert nbytes == 4 * (f1.size + sum(x.numel() for x in wc.f2_levels)) + coords.size * 4 + out_bytes


FAULTS = [
    ("dtype", "must be {dtypes}"),
    ("c", "multiple of 8"),
    ("wide", "multiple of 8"),
    ("levels", "1-4 levels"),
    ("radius", "radius"),
    ("level_dtype", "level 1 must be torch.{dtype}"),
    ("level_shape", "level 2 must be"),
    ("coords_shape", "H\\*W == P"),
    ("cpu", "must be a CUDA tensor"),
]
# (wrapper, the dtype it is given, the dtypes it names); the CUDA-core
# kernel's cases keep their ids
WRAPPERS = [("cuda_core", torch.float32, "float32 or bfloat16"), ("mma", torch.bfloat16, "bfloat16"),
            ("tf32", torch.float32, "float32")]
# the backward kernel's wrapper, which also takes the output's gradient g
BWD_WRAPPER = ("bwd", torch.float32, "float32 or bfloat16")
# the two tensor-core wrappers and the backward's take any level count and
# radius (their general case): at 5 levels and at radius 5 and 8, CPU tensors
# are refused only for lying on the CPU
GENERAL = {"levels": "must be a CUDA tensor", "radius": "must be a CUDA tensor",
           "radius8": "must be a CUDA tensor"}


def _faults(wrapper):
    if wrapper == "cuda_core":
        return FAULTS
    out = [(fault, GENERAL.get(fault, match)) for fault, match in FAULTS]
    i = [fault for fault, _ in out].index("radius") + 1
    return out[:i] + [("radius8", GENERAL["radius8"])] + out[i:]


@pytest.mark.parametrize("fault,match,wrapper", [
    pytest.param(fault, match.format(dtypes=names, dtype=str(dtype)[6:]), wrapper,
                 id=f"{fault}-{match.format(dtypes=names, dtype=str(dtype)[6:])}"
                 if wrapper == "cuda_core" else f"{wrapper}-{fault}")
    for wrapper, dtype, names in WRAPPERS + [BWD_WRAPPER] for fault, match in _faults(wrapper)
])
def test_kernel_wrapper_refuses_what_it_does_not_take(rng, fault, match, wrapper):
    """The wrappers' checks run before any build, so they hold on the CPU;
    the bf16 tensor-core wrapper takes bf16 only, the 3xTF32 one float32
    only, the backward's both (with g of the output's shape). The CUDA-core
    kernel takes 1-4 levels and a radius of 0-4; the others any level count
    and radius, so their `levels` (5 levels), `radius` (5) and `radius8`
    cases meet only the CPU tensor's refusal. No case launches anything."""
    kernel = {"cuda_core": tcorr.WINDOWED_CORR_KERNEL, "mma": tcorr.WINDOWED_CORR_MMA_KERNEL,
              "tf32": tcorr.WINDOWED_CORR_TF32_KERNEL, "bwd": tcorr.WINDOWED_CORR_BWD_KERNEL}[wrapper]
    dtype = dict((w, d) for w, d, _ in WRAPPERS + [BWD_WRAPPER])[wrapper]
    c = {"c": 20, "wide": 264}.get(fault, 16)
    f1, f2 = _maps(rng, 1, 8, 8, c)
    wc = tcorr.windowed_corr_pyramid(nchw(f1).to(dtype), nchw(f2).to(dtype),
                                     5 if fault == "levels" else 3)
    coords = torch.zeros(1, 2, 8, 7 if fault == "coords_shape" else 8)
    if fault == "dtype":
        wc = wc._replace(f1=wc.f1.double())
    elif fault == "level_dtype":
        wc = wc._replace(f2_levels=(wc.f2_levels[0], wc.f2_levels[1].half(), wc.f2_levels[2]))
    elif fault == "level_shape":
        wc = wc._replace(f2_levels=wc.f2_levels[:2] + (wc.f2_levels[2][..., :8],))
    radius = {"radius": 5, "radius8": 8}.get(fault, 4)
    g = torch.zeros((1, len(wc.f2_levels) * (2 * radius + 1) ** 2, *coords.shape[-2:]),
                    dtype=wc.f1.dtype)
    before = kernel.launches
    with pytest.raises((TypeError, ValueError), match=match):
        kernel(wc, coords, g, radius) if wrapper == "bwd" else kernel(wc, coords, radius)
    assert kernel.launches == before


@pytest.mark.parametrize("wrapper", [w for w, _, _ in WRAPPERS])
@pytest.mark.parametrize("needs_grad", ["f1", "level", "coords", "none"])
def test_kernel_wrapper_refuses_grad(rng, wrapper, needs_grad):
    """With grad enabled, an input that requires grad makes each wrapper
    raise before anything is built: the kernels have no backward, and their
    output would leave the graph. Without one, the wrapper goes on to its
    other checks (here: the CPU tensor)."""
    kernel = {"cuda_core": tcorr.WINDOWED_CORR_KERNEL, "mma": tcorr.WINDOWED_CORR_MMA_KERNEL,
              "tf32": tcorr.WINDOWED_CORR_TF32_KERNEL}[wrapper]
    dtype = dict((w, d) for w, d, _ in WRAPPERS)[wrapper]
    f1, f2 = _maps(rng, 1, 8, 8, 16)
    wc = tcorr.windowed_corr_pyramid(nchw(f1).to(dtype), nchw(f2).to(dtype), 3)
    coords = torch.zeros(1, 2, 8, 8)
    if needs_grad == "f1":
        wc = wc._replace(f1=wc.f1.requires_grad_())
    elif needs_grad == "level":
        wc = wc._replace(f2_levels=(wc.f2_levels[0], wc.f2_levels[1].requires_grad_(),
                                    wc.f2_levels[2]))
    elif needs_grad == "coords":
        coords.requires_grad_()
    before = kernel.launches
    error, match = ((ValueError, "must be a CUDA tensor") if needs_grad == "none"
                    else (NotImplementedError, "no backward"))
    with pytest.raises(error, match=match):
        kernel(wc, coords)
    if needs_grad != "none":
        with torch.no_grad(), pytest.raises(ValueError, match="must be a CUDA tensor"):
            kernel(wc, coords)
    assert kernel.launches == before


def test_mma_wrapper_refuses_float32():
    """A float32 state never reaches the tensor-core kernel."""
    wc = tcorr.windowed_corr_pyramid(torch.zeros(1, 16, 8, 8), torch.zeros(1, 16, 8, 8), 2)
    with pytest.raises(TypeError, match="f1 must be bfloat16"):
        tcorr.WINDOWED_CORR_MMA_KERNEL(wc, torch.zeros(1, 2, 8, 8))


# (C, dtype, coordinate kind, radius, levels, map size)
CARD_CASES = [
    (256, torch.float32, "in_frame", 4, 4, (20, 28)),
    (256, torch.bfloat16, "span", 4, 4, (20, 28)),
    (24, torch.float32, "border", 4, 4, (13, 23)),
    (24, torch.bfloat16, "far", 4, 4, (13, 23)),
    (64, torch.float32, "span", 3, 2, (9, 15)),
    (8, torch.float32, "far", 1, 1, (7, 9)),
    (256, torch.bfloat16, "smooth", 4, 4, (20, 40)),
    (8, torch.bfloat16, "smooth", 4, 4, (13, 23)),
    (8, torch.bfloat16, "span", 1, 1, (7, 9)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("c,dtype,kind,radius,levels,hw", CARD_CASES)
def test_kernel_matches_plain_on_card(rng, c, dtype, kind, radius, levels, hw):
    """`windowed_agreement`: float32 <= 1e-5 of the largest value (sums in
    another order); bf16 within one bf16 step (2**-7 relative) of the plain
    version, whose float32 sums may round the other way; NaN at the same
    places. The lookup launches the kernel its dtype routes to, once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; run on the card")
    f1, f2 = _maps(rng, 2, *hw, c)
    coords = nchw(_coords(rng, 2, *hw, kind))
    wc = tcorr.windowed_corr_pyramid(nchw(f1).to(dtype), nchw(f2).to(dtype), levels)
    ref = tcorr.windowed_corr_lookup_plain(wc, coords, radius)
    cwc = tcorr.WindowedCorr(wc.f1.cuda(), tuple(x.cuda() for x in wc.f2_levels), wc.shape_hw)
    kernels = (tcorr.WINDOWED_CORR_MMA_KERNEL, tcorr.WINDOWED_CORR_TF32_KERNEL,
               tcorr.WINDOWED_CORR_KERNEL)
    routed = kernels[0] if dtype == torch.bfloat16 else kernels[1]
    before = [k.launches for k in kernels]
    got = tcorr.windowed_corr_lookup(cwc, coords.cuda(), radius)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [int(k is routed) for k in kernels]
    agree = windowed_agreement(got.cpu(), ref)
    assert agree["ok"], agree


@pytest.mark.parametrize("name", list(windowed_ablate.VARIANTS))
def test_ablation_variants_apply_to_the_kernel_source(name):
    """Every substitution of a variant matches the kernel's source once, so
    `windowed_ablate` builds what its docstring says; only `kernel` is the
    source itself."""
    src = (CSRC / "windowed_corr.cu").read_text()
    out = windowed_ablate.variant_source(name, src)
    assert (out == src) == (name == "kernel")
    assert "extern \"C\" int windowed_corr_lookup(" in out


@pytest.mark.parametrize("kind", ["in_frame", "border", "far", "smooth"])
def test_windowed_inputs_and_agreement(kind):
    """The card checks' inputs, made on the CPU: a state of the asked
    shape, NaN/inf only where `far` puts them; and the tolerance accepts
    the plain version against itself and refuses two bf16 steps or a NaN
    in another place."""
    shape = (2, 13, 23)
    wc, coords, (f1, f2) = windowed_inputs(shape, 16, torch.bfloat16, kind, 3, device="cpu")
    assert wc.f1.shape == (2, 13 * 23, 16) and wc.f1.dtype == torch.bfloat16
    assert [tuple(x.shape) for x in wc.f2_levels] == [(2, 13, 23, 16), (2, 6, 11, 16),
                                                      (2, 3, 5, 16)]
    assert coords.shape == (2, 2, 13, 23) and coords.dtype == torch.float32
    assert bool(torch.isfinite(coords).all()) == (kind != "far")
    ref = tcorr.windowed_corr_lookup_plain(wc, coords).contiguous()
    assert windowed_agreement(ref.clone(), ref)["ok"]
    flat = ref.view(-1)
    big = int(torch.where(torch.isfinite(flat), flat.abs(), 0).argmax())
    off = flat.clone()
    off[big] *= 1 + 2.0**-6
    assert not windowed_agreement(off, flat)["ok"]
    moved = flat.clone()
    moved[0] = 0.0 if torch.isnan(flat[0]) else float("nan")
    assert not windowed_agreement(moved, flat)["ok"]
    with pytest.raises(ValueError, match="unknown coordinate kind"):
        windowed_inputs(shape, 16, torch.float32, "sideways", device="cpu")


def test_ablation_main_needs_the_card():
    """Off the card the ablation tool raises instead of running anything."""
    if torch.cuda.is_available():
        pytest.skip("runs on a CPU-only machine")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        windowed_ablate.main()
