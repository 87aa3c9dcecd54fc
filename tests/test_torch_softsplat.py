"""The port's splat against the JAX reference, on the CPU.

The plain sum core (what a CPU tensor runs) is held against both the
reference's XLA scatter core and its Pallas sorted-window kernel in
interpret mode, at the shapes of tests/test_splat_pallas.py plus a
non-finite and a smooth-flow case; `softsplat` against the reference for
every mode and eps policy, with and without `return_norm`. Tolerance:
rtol = atol = 1e-5 (float32 sums in another order).

The CUDA kernel itself runs only on the card (`cuda` marker). On the CPU a
model of its block walk (`_kernel_walk`, the source's index stepping in
Python) is held against the plain version, and the wrapper's checks are
shown to raise before anything is built.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gimmvfi_tpu.ops.softsplat import _splat_core_xla
from gimmvfi_tpu.ops.softsplat import softsplat as jax_softsplat
from gimmvfi_tpu.ops.splat_pallas import splat_corners_sorted
from gimmvfi_tpu_torch.ops.softsplat import SPLAT_KERNEL, softsplat, splat_sum, splat_sum_plain
from gimmvfi_tpu_torch.tools import splat_ablate
from gimmvfi_tpu_torch.tools.splat_ablate import CHECK_CASES, kernel_bound_ok, smooth_flow, splat_inputs
from gimmvfi_tpu_torch.utils.kernel_build import CSRC

torch.set_num_threads(1)

SHAPES = [((1, 16, 24, 5), 3.0), ((2, 24, 16, 3), 30.0), ((1, 8, 8, 1), 0.6)]
KERNEL_SRC = (CSRC / "softsplat.cu").read_text()
PIXELS = int(re.search(r"constexpr int kPixels = (\d+);", KERNEL_SRC).group(1))


def _inputs(rng, shape, flow_scale, field="random"):
    n, h, w, _ = shape
    vals = rng.standard_normal(shape).astype(np.float32)
    if field == "smooth":
        return vals, smooth_flow(rng, n, h, w, flow_scale, coarse=(3, 4))
    flow = (rng.standard_normal((n, h, w, 2)) * flow_scale).astype(np.float32)
    if field == "non_finite":
        flow[0, 3, 4, 0] = np.nan
        flow[0, 5, 6, 1] = np.inf
        flow[0, 7, 1, 0] = -np.inf
        flow[0, 2, 2, :] = 1e30
    return vals, flow


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
@pytest.mark.parametrize(
    "shape,flow_scale,field",
    [(s, f, "random") for s, f in SHAPES]
    + [((1, 16, 16, 2), 1.0, "non_finite"), ((2, 20, 36, 5), 6.0, "smooth")],
    ids=["shape0-3.0-False", "shape1-30.0-False", "shape2-0.6-False", "shape3-1.0-True",
         "smooth-2x20x36x5"],
)
def test_plain_core_matches_reference(rng, reference, shape, flow_scale, field):
    vals, flow = _inputs(rng, shape, flow_scale, field)
    if reference == "xla":
        ref = _splat_core_xla(jnp.asarray(vals), jnp.asarray(flow))
    else:
        ref = splat_corners_sorted(jnp.asarray(vals), jnp.asarray(flow), interpret=True)
    _close(splat_sum_plain(torch.from_numpy(vals), torch.from_numpy(flow)), ref)


@pytest.mark.parametrize("eps", ["addeps", "zeroeps", "clipeps"])
@pytest.mark.parametrize("base", ["sum", "avg", "linear", "softmax"])
def test_softsplat_modes(rng, base, eps):
    n, h, w, c = 2, 20, 28, 4
    ten = rng.standard_normal((n, h, w, c)).astype(np.float32)
    flow = (rng.standard_normal((n, h, w, 2)) * 6).astype(np.float32)
    metric = None
    if base in ("linear", "softmax"):
        metric = (rng.random((n, h, w, 1)) + 0.5).astype(np.float32)
    mode = f"{base}-{eps}"
    ref = jax_softsplat(jnp.asarray(ten), jnp.asarray(flow),
                        None if metric is None else jnp.asarray(metric), mode)
    got = softsplat(torch.from_numpy(ten), torch.from_numpy(flow),
                    None if metric is None else torch.from_numpy(metric), mode)
    _close(got, ref)


def test_cpu_tensor_takes_plain_core(rng):
    vals, flow = _inputs(rng, (1, 8, 8, 3), 2.0)
    before = SPLAT_KERNEL.launches
    got = splat_sum(torch.from_numpy(vals), torch.from_numpy(flow))
    assert SPLAT_KERNEL.launches == before
    _close(got, splat_sum_plain(torch.from_numpy(vals), torch.from_numpy(flow)))


@pytest.mark.parametrize("eps", ["addeps", "zeroeps", "clipeps"])
@pytest.mark.parametrize("base", ["avg", "linear", "softmax"])
def test_softsplat_return_norm(rng, base, eps):
    """`return_norm` gives the splatted values and the eps-adjusted weight,
    both as the reference gives them."""
    n, h, w, c = 2, 18, 26, 3
    ten = rng.standard_normal((n, h, w, c)).astype(np.float32)
    flow = (rng.standard_normal((n, h, w, 2)) * 5).astype(np.float32)
    metric = None if base == "avg" else (rng.random((n, h, w, 1)) + 0.5).astype(np.float32)
    mode = f"{base}-{eps}"
    ref_out, ref_norm = jax_softsplat(jnp.asarray(ten), jnp.asarray(flow),
                                      None if metric is None else jnp.asarray(metric), mode,
                                      return_norm=True)
    got_out, got_norm = softsplat(torch.from_numpy(ten), torch.from_numpy(flow),
                                  None if metric is None else torch.from_numpy(metric), mode,
                                  return_norm=True)
    assert got_out.shape == (n, h, w, c) and got_norm.shape == (n, h, w, 1)
    _close(got_out, ref_out)
    _close(got_norm, ref_norm)


def _faulty(fault):
    vals = torch.zeros(1, 4, 6, 3)
    flow = torch.zeros(1, 4, 6, 2)
    if fault == "vals_dtype":
        return vals.double(), flow, TypeError, "vals must be torch.float32"
    if fault == "flow_dtype":
        return vals, flow.half(), TypeError, "flow must be torch.float32"
    if fault == "non_contiguous":
        return vals.transpose(1, 2), flow.transpose(1, 2), ValueError, "contiguous"
    if fault == "misaligned":
        return torch.zeros(1 + 72)[1:].view(1, 4, 6, 3), flow, ValueError, "16-byte aligned"
    if fault == "flow_shape":
        return vals, torch.zeros(1, 4, 6, 3), ValueError, r"flow must have shape \(1, 4, 6, 2\)"
    if fault == "flow_device":
        return vals, flow.to("meta"), ValueError, "flow is on meta"
    if fault == "rank":
        return vals[0], flow, ValueError, r"vals \(N, H, W, C\)"
    return vals, flow, ValueError, "CUDA tensor"


@pytest.mark.parametrize("fault", ["vals_dtype", "flow_dtype", "non_contiguous", "misaligned",
                                   "flow_shape", "flow_device", "rank", "cpu"])
def test_kernel_wrapper_checks_before_building(fault):
    """The wrapper raises on what the kernel does not take, through
    `CudaKernel.check`, before it builds or launches anything."""
    vals, flow, error, match = _faulty(fault)
    before = SPLAT_KERNEL.launches
    with pytest.raises(error, match=match):
        SPLAT_KERNEL(vals, flow)
    assert SPLAT_KERNEL._fn is None
    assert SPLAT_KERNEL.launches == before


def _kernel_walk(vals: np.ndarray, flow: np.ndarray, pixels: int, vec4: bool) -> np.ndarray:
    """`csrc/softsplat.cu` on the CPU, one float32 add at a time: each block's
    geometry (dst -1 where a corner is masked), then its flat walk over
    pixels x C values with the (pixel, channel) pair stepped as the source
    steps it, in 16-byte groups with a scalar tail when `vec4`."""
    n, h, w, c = vals.shape
    npix = n * h * w
    src_all = vals.reshape(-1)
    fl = flow.reshape(npix, 2)
    out = np.zeros(npix * c, np.float32)
    f32 = np.float32
    for p0 in range(0, npix, pixels):
        npx = min(pixels, npix - p0)
        dst, wgt = [], []
        for t in range(npx):
            p = p0 + t
            j, i = p % w, (p // w) % h
            img0 = p - (i * w + j)
            x, y = f32(j) + fl[p, 0], f32(i) + fl[p, 1]
            if not (np.isfinite(x) and np.isfinite(y)):
                x, y = f32(-10.0), f32(-10.0)
            x0f, y0f = np.floor(x), np.floor(y)
            wx1, wy1 = x - x0f, y - y0f
            wx0, wy0 = f32(1.0) - wx1, f32(1.0) - wy1
            x0 = int(min(max(x0f, -2.0), w))
            y0 = int(min(max(y0f, -2.0), h))
            base = img0 + y0 * w + x0
            xin = (0 <= x0 < w, 0 <= x0 + 1 < w)
            yin = (0 <= y0 < h, 0 <= y0 + 1 < h)
            dst.append([base if xin[0] and yin[0] else -1, base + 1 if xin[1] and yin[0] else -1,
                        base + w if xin[0] and yin[1] else -1,
                        base + w + 1 if xin[1] and yin[1] else -1])
            wgt.append([wx0 * wy0, wx1 * wy0, wx0 * wy1, wx1 * wy1])
        src = src_all[p0 * c:]
        m = npx * c

        def splat_value(v, q, r):
            for d, wk in zip(dst[q], wgt[q]):
                if d >= 0:
                    out[d * c + r] += v * wk

        if vec4:
            m4 = m // 4
            dq, dr = divmod(4 * pixels, c)
            for t in range(pixels):
                q, r = divmod(4 * t, c)
                for e4 in range(t, m4, pixels):
                    qq, rr = q, r
                    for k in range(4):
                        splat_value(src[4 * e4 + k], qq, rr)
                        rr += 1
                        if rr == c:
                            rr, qq = 0, qq + 1
                    q, r = q + dq, r + dr
                    if r >= c:
                        r, q = r - c, q + 1
                for e in range(4 * m4 + t, m, pixels):
                    splat_value(src[e], e // c, e % c)
        else:
            dq, dr = divmod(pixels, c)
            for t in range(pixels):
                q, r = divmod(t, c)
                for e in range(t, m, pixels):
                    splat_value(src[e], q, r)
                    q, r = q + dq, r + dr
                    if r >= c:
                        r, q = r - c, q + 1
    return out.reshape(vals.shape)


@pytest.mark.parametrize("vec4", [False, True], ids=["scalar", "vec4"])
@pytest.mark.parametrize("shape,flow_scale,field", [
    ((2, 13, 23, 3), 4.0, "random"),  # 3 blocks, the last ragged
    ((1, 7, 13, 5), 2.0, "random"),  # 455 values: a 3-value tail after the 16-byte groups
    ((1, 9, 31, 17), 6.0, "smooth"),  # the main path's C, 2 blocks
    ((1, 16, 16, 2), 1.0, "non_finite"),
    ((1, 5, 4, 300), 1.5, "random"),  # C over a block's thread count: dq = 0
])
def test_kernel_walk_matches_plain(rng, shape, flow_scale, field, vec4):
    vals, flow = _inputs(rng, shape, flow_scale, field)
    got = _kernel_walk(vals, flow, PIXELS, vec4)
    ref = splat_sum_plain(torch.from_numpy(vals), torch.from_numpy(flow))
    assert kernel_bound_ok(float(np.abs(got - ref.numpy()).max()), ref)[0]


def test_kernel_source_is_the_channel_contiguous_design():
    """Lanes over the flat (pixel, channel) range with the geometry in shared
    memory; no per-thread channel array as in the one-pixel-a-thread kernel."""
    assert PIXELS % 4 == 0
    for needle in ("__shared__ int4 s_dst[kPixels]", "__shared__ float4 s_wgt[kPixels]",
                   "__syncthreads()", "for (int e = t; e < m; e += kPixels)"):
        assert needle in KERNEL_SRC, needle
    for gone in ("kChannelRun", "float v["):
        assert gone not in KERNEL_SRC, gone


@pytest.mark.parametrize("name", sorted(splat_ablate.VARIANTS))
def test_ablation_variants_apply_to_the_kernel_source(name):
    out = splat_ablate.variant_source(name, KERNEL_SRC)
    assert (out == KERNEL_SRC) == (name == "kernel")


def test_check_cases_cover_the_kernel_edges():
    """The card's check cases: every channel count of the list, N = 2, value
    counts off a multiple of 4, and all three flow fields at the main shape."""
    shapes = [s for s, _, _ in CHECK_CASES]
    assert {s[3] for s in shapes} >= {1, 3, 5, 17, 33, 64}
    assert any(s[0] == 2 for s in shapes)
    assert any(np.prod(s) % 4 for s in shapes)
    assert {f for s, f, _ in CHECK_CASES if s == splat_ablate.MAIN_SHAPE} == {
        "random", "smooth", "non_finite"}


def test_splat_inputs_are_seeded_and_smooth():
    vals, flow = splat_inputs((1, 96, 160, 2), "smooth", 20.0, seed=3, device="cpu")
    vals2, flow2 = splat_inputs((1, 96, 160, 2), "smooth", 20.0, seed=3, device="cpu")
    assert torch.equal(vals, vals2) and torch.equal(flow, flow2)
    assert flow.shape == (1, 96, 160, 2) and torch.isfinite(flow).all()
    # neighbours differ by far less than the field's spread
    step = (flow[:, :, 1:] - flow[:, :, :-1]).abs().mean()
    assert float(step) < 0.3 * float(flow.std())
    _, bad = splat_inputs((1, 40, 40, 1), "non_finite", 20.0, device="cpu")
    assert not torch.isfinite(bad).all() and float(bad[torch.isfinite(bad)].abs().max()) > 1e3
    with pytest.raises(ValueError, match="unknown flow field"):
        splat_inputs((1, 4, 4, 1), "sideways", 1.0, device="cpu")


def test_ablation_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        splat_ablate.main([])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,field,std", CHECK_CASES)
def test_kernel_matches_plain_on_card(shape, field, std):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; run on the card")
    vals, flow = splat_inputs(shape, field, std, seed=1)
    before = SPLAT_KERNEL.launches
    got = splat_sum(vals, flow)
    torch.cuda.synchronize()
    assert SPLAT_KERNEL.launches == before + 1
    ref = splat_sum_plain(vals, flow)
    ok, bound = kernel_bound_ok(float((got - ref).abs().max()), ref)
    assert ok, (float((got - ref).abs().max()), bound)
