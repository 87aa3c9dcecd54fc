"""The port's splat against the JAX reference, on the CPU.

The plain sum core (what a CPU tensor runs) is held against both the
reference's XLA scatter core and its Pallas sorted-window kernel in
interpret mode, at the shapes of tests/test_splat_pallas.py plus a
non-finite and a smooth-flow case; `softsplat` against the reference for
every mode and eps policy, with and without `return_norm`. Tolerance:
rtol = atol = 1e-5 (float32 sums in another order).

The deterministic kernel's order (`splat_sum_sorted_plain`: sources
stably sorted by destination key, each output's four key runs summed in a
fixed order) is held against the plain core and the Pallas kernel in
interpret mode at the same shapes and on many-to-one collisions, <= 1e-5
max-abs.

The CUDA kernels themselves run only on the card (`cuda` marker). On the
CPU a model of the atomic kernel's block walk (`_kernel_walk`, the
source's index stepping in Python) is held against the plain version; a
model of the sorted kernel's tile-staged gather (`_sorted_tile_walk`: its
range bounds, run marks, walk order and chunks) is held bitwise to
`splat_sum_sorted_plain`; both wrappers' checks are shown to raise before
anything is built.
"""

import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gimmvfi_tpu.ops.softsplat import _splat_core_xla
from gimmvfi_tpu.ops.softsplat import softsplat as jax_softsplat
from gimmvfi_tpu.ops.splat_pallas import splat_corners_sorted
from gimmvfi_tpu_torch.ops import softsplat as softsplat_ops
from gimmvfi_tpu_torch.ops.softsplat import (
    SPLAT_KERNEL,
    SPLAT_SORTED_KERNEL,
    SplatSum,
    softsplat,
    SortedSplatKernel,
    splat_geometry,
    splat_sort_keys,
    splat_sum,
    splat_sum_plain,
    splat_sum_sorted_plain,
)
from gimmvfi_tpu_torch.tools import splat_ablate
from gimmvfi_tpu_torch.tools.splat_ablate import (
    CHECK_CASES,
    kernel_bound_ok,
    smooth_flow,
    sorted_capacity,
    sorted_tile,
    splat_inputs,
)
from gimmvfi_tpu_torch.utils.kernel_build import CSRC, substitute

torch.set_num_threads(1)

SHAPES = [((1, 16, 24, 5), 3.0), ((2, 24, 16, 3), 30.0), ((1, 8, 8, 1), 0.6)]
KERNEL_SRC = (CSRC / "softsplat.cu").read_text()
PIXELS = int(re.search(r"constexpr int kPixels = (\d+);", KERNEL_SRC).group(1))
SORTED_SRC = (CSRC / "softsplat_sorted.cu").read_text()
SORTED_TILE = sorted_tile(SORTED_SRC)


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


def _collisions(rng, shape=(1, 20, 30, 4), at=(10.3, 7.6)):
    """Every source pixel sent to one point: one destination quad takes all
    of them (a key run as long as the frame)."""
    n, h, w, _ = shape
    jj, ii = np.meshgrid(np.arange(w), np.arange(h))
    flow = np.stack([at[0] - jj, at[1] - ii], axis=-1)[None].repeat(n, 0).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32), flow


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


SORTED_CASES = ([(s, f, "random") for s, f in SHAPES]
                + [((1, 16, 16, 2), 1.0, "non_finite"), ((2, 20, 36, 5), 6.0, "smooth"),
                   ((1, 20, 30, 4), None, "collisions")])


@pytest.mark.parametrize("reference", ["plain", "pallas_interpret"])
@pytest.mark.parametrize("shape,flow_scale,field", SORTED_CASES,
                         ids=[f"{'x'.join(map(str, s))}-{f}" for s, _, f in SORTED_CASES])
def test_sorted_order_matches_reference(rng, reference, shape, flow_scale, field):
    """The sorted kernel's order against the plain core and JAX's sorted
    Pallas kernel (interpret mode): masked edges, non-finite and far
    positions, many-to-one collisions; <= 1e-5 max-abs."""
    vals, flow = _collisions(rng) if field == "collisions" else _inputs(rng, shape, flow_scale,
                                                                         field)
    if reference == "plain":
        ref = splat_sum_plain(torch.from_numpy(vals), torch.from_numpy(flow)).numpy()
    else:
        ref = np.asarray(splat_corners_sorted(jnp.asarray(vals), jnp.asarray(flow),
                                              interpret=True))
    got = splat_sum_sorted_plain(torch.from_numpy(vals), torch.from_numpy(flow)).numpy()
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= 1e-5


def test_sort_keys_are_the_padded_base_corners(rng):
    """Keys = image * P + y0 * W + x0 + W + 1, P = H*W + 2(W + 1): zero flow
    gives each pixel its own key, one off-frame row/column before it; a
    position none of whose corners is on the frame, far or non-finite,
    takes the image's last key, P - 1, which no destination reads."""
    n, h, w = 2, 5, 7
    flow = np.zeros((n, h, w, 2), np.float32)
    keys, p_pad = splat_sort_keys(torch.from_numpy(flow))
    assert p_pad == h * w + 2 * (w + 1)
    want = (np.arange(n)[:, None] * p_pad + np.arange(h * w)[None] + w + 1).reshape(-1)
    assert np.array_equal(keys.numpy(), want)
    flow[0, 0, 0] = [np.nan, 0.0]
    flow[0, 0, 1] = [1e30, 1e30]
    flow[1, 4, 6] = [-1e30, -3.0]
    flow[0, 0, 2] = [-2.5, -0.5]  # base corner (-1, -1): only its (1, 1) corner, (0, 0), is on
    keys, _ = splat_sort_keys(torch.from_numpy(flow))
    assert keys[0] == keys[1] == p_pad - 1 and keys[-1] == 2 * p_pad - 1 and keys[2] == 0
    # destination d reads the keys d + W + 1 - {0, 1, W, W + 1}, all below P - 1
    assert int(keys.min()) >= 0 and int(keys.max()) < n * p_pad


def test_card_route_is_the_sorted_kernel(rng, monkeypatch):
    """`SplatSum.forward`, the card's forward, calls the sorted kernel; shown
    on CPU tensors with the kernel replaced by a recorder."""
    calls = []

    def recorder(vals, flow):
        calls.append(vals.shape)
        return splat_sum_sorted_plain(vals, flow)

    monkeypatch.setattr(softsplat_ops, "SPLAT_SORTED_KERNEL", recorder)
    vals, flow = _inputs(rng, (1, 8, 8, 3), 2.0)
    got = SplatSum.apply(torch.from_numpy(vals), torch.from_numpy(flow))
    assert calls == [(1, 8, 8, 3)]
    _close(got, splat_sum_plain(torch.from_numpy(vals), torch.from_numpy(flow)))


def test_cpu_tensor_takes_plain_core(rng):
    vals, flow = _inputs(rng, (1, 8, 8, 3), 2.0)
    before = SPLAT_KERNEL.launches, SPLAT_SORTED_KERNEL.launches
    got = splat_sum(torch.from_numpy(vals), torch.from_numpy(flow))
    assert (SPLAT_KERNEL.launches, SPLAT_SORTED_KERNEL.launches) == before
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


FAULTS = ["vals_dtype", "flow_dtype", "non_contiguous", "misaligned", "flow_shape",
          "flow_device", "rank", "cpu"]


@pytest.mark.parametrize("fault", FAULTS)
def test_kernel_wrapper_checks_before_building(fault):
    """The wrapper raises on what the kernel does not take, through
    `CudaKernel.check`, before it builds or launches anything."""
    vals, flow, error, match = _faulty(fault)
    before = SPLAT_KERNEL.launches
    with pytest.raises(error, match=match):
        SPLAT_KERNEL(vals, flow)
    assert SPLAT_KERNEL._fn is None
    assert SPLAT_KERNEL.launches == before


@pytest.mark.parametrize("fault", FAULTS + ["grad", "key_space"])
def test_sorted_kernel_wrapper_checks_before_building(fault):
    """The sorted kernel's wrapper: the same checks, its graph refusal and
    its int32 key space, all before it builds or launches anything."""
    if fault == "grad":
        vals, flow = torch.zeros(1, 4, 6, 3, requires_grad=True), torch.zeros(1, 4, 6, 2)
        error, match = NotImplementedError, "no graph"
    elif fault == "key_space":
        # 2 x (2**30 + 2 (2**30 + 1)) keys; meta tensors hold no memory
        vals = torch.empty(2, 1, 2**30, 1, device="meta")
        flow = torch.empty(2, 1, 2**30, 2, device="meta")
        error, match = ValueError, "2\\*\\*31"
    else:
        vals, flow, error, match = _faulty(fault)
    before = SPLAT_SORTED_KERNEL.launches
    with pytest.raises(error, match=match):
        SPLAT_SORTED_KERNEL(vals, flow)
    assert SPLAT_SORTED_KERNEL._fn is None and SPLAT_SORTED_KERNEL._keys_fn is None
    assert SPLAT_SORTED_KERNEL.launches == before


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


def _sorted_tile_walk(vals: np.ndarray, flow: np.ndarray, rows: int, cols: int,
                      capacity: int) -> tuple[np.ndarray, int]:
    """`csrc/softsplat_sorted.cu`'s gather on the CPU, one float32 operation
    at a time (over a row's channels at once): for each tile of `rows` x
    `cols` destinations of one image, its rows + 1 key rows' range bounds
    in the sorted keys, the run marks (`vst`: each key's run end in walk
    order), then the walk in chunks of `capacity` entries, each staged entry
    placed as the kernel places it (from its key where one chunk holds the
    tile, else found from its walk position), each (column,
    channel) walked down the key rows, each output adding its runs' part in
    the chunk to its partial sum. Asserts that the entries
    each destination reads, over all chunks, are exactly its four key runs
    of the whole sorted array. Returns (out, tiles that took more than one
    chunk)."""
    n, h, w, c = vals.shape
    npix = n * h * w
    keys, p_pad = splat_sort_keys(torch.from_numpy(flow))
    keys, order = (a.numpy() for a in torch.sort(keys, stable=True))
    wq = np.stack([torch.where(ok, wgt, 0.0).numpy()
                   for _, _, wgt, ok in splat_geometry(torch.from_numpy(flow))],
                  axis=-1).reshape(npix, 4)
    rows_v = vals.reshape(npix, c)
    out = np.full((npix, c), np.nan, np.float32)
    read = {}  # (destination, corner) -> sorted positions read, in order
    chunked = 0
    for img in range(n):
        for ya in range(0, h, rows):
            for xa in range(0, w, cols):
                wc, rt = min(cols, w - xa), min(rows, h - ya)
                nr, kbase = rt + 1, img * p_pad + ya * w + xa
                bound = [(int(np.searchsorted(keys, kbase + rr * w)),
                          int(np.searchsorted(keys, kbase + rr * w + wc + 1))) for rr in range(nr)]
                e_, vend, v = [0] * nr, [0] * nr, 0
                for rr in reversed(range(nr)):
                    e_[rr] = v + bound[rr][1]
                    v += bound[rr][1] - bound[rr][0]
                    vend[rr] = v
                total = v
                vst = [[e_[rr] - bound[rr][1]] * (wc + 2) for rr in range(nr)]
                for rr, (b0, b1) in enumerate(bound):
                    klo = kbase + rr * w
                    for g in range(b0, b1):
                        kp = -1 if g == b0 else keys[g - 1] - klo
                        for j in range(kp + 1, keys[g] - klo + 1):
                            vst[rr][j] = e_[rr] - g
                v0 = 0
                while True:
                    v1 = min(total, v0 + capacity)
                    staged = [None] * (v1 - v0)  # sorted position of each slot
                    if total <= capacity:  # one chunk: each entry's slot from its key
                        for rr, (b0, b1) in enumerate(bound):
                            for g in range(b0, b1):
                                j = keys[g] - (kbase + rr * w)
                                staged[vst[rr][j + 1] + g - (e_[rr] - vst[rr][j])] = g
                    else:  # each slot's entry from its walk position
                        for v in range(v0, v1):
                            rr = nr - 1
                            while v >= vend[rr]:
                                rr -= 1
                            j = next(j for j in range(wc + 1) if vst[rr][j + 1] <= v)
                            staged[v - v0] = e_[rr] - vst[rr][j] + v - vst[rr][j + 1]
                    src = order[staged]
                    s_w, s_val = wq[src], rows_v[src]
                    zero = np.zeros(c, np.float32)
                    for tx in range(wc):  # a column, down the key rows
                        dst = [(img * h + ya + ty) * w + xa + tx for ty in range(rt)]
                        upper = zero  # destination row rr, its (0,0), (1,0) summed
                        lower = zero if v0 == 0 else out[dst[rt - 1]].copy()  # row rr - 1
                        for rr in range(rt, -1, -1):
                            vr = vst[rr]
                            a, m = max(vr[tx + 2], v0) - v0, max(min(vr[tx + 1], v1), v0) - v0
                            b = min(vr[tx], v1) - v0
                            for lo, hi, up, low in ((a, m, 2, 0), (m, b, 3, 1)):
                                for e in range(lo, hi):
                                    upper = upper + s_val[e] * s_w[e, up]
                                    lower = lower + s_val[e] * s_w[e, low]
                                    if rr < rt:
                                        read.setdefault((dst[rr], up), []).append(staged[e])
                                    if rr > 0:
                                        read.setdefault((dst[rr - 1], low), []).append(staged[e])
                            if rr < rt:
                                out[dst[rr]] = upper
                            upper = lower
                            lower = zero if v0 == 0 or rr < 2 else out[dst[rr - 2]].copy()
                    v0 = v1
                    if v0 >= total:
                        break
                chunked += total > capacity
    for d in range(npix):
        k = (d // (h * w)) * p_pad + d % (h * w) + w + 1
        for corner, delta in enumerate((0, 1, w, w + 1)):
            lo, hi = np.searchsorted(keys, [k - delta, k - delta + 1])
            assert read.get((d, corner), []) == list(range(lo, hi)), (d, corner)
    return out.reshape(vals.shape), chunked


# (shape, flow std, field): the order tests' cases plus C = 17 with H and W
# off every tile
TILE_CASES = SORTED_CASES + [((1, 13, 37, 17), 4.0, "random")]


@pytest.mark.parametrize("tile", ["kernel", "3x5"])
@pytest.mark.parametrize("shape,flow_scale,field", TILE_CASES,
                         ids=[f"{'x'.join(map(str, s))}-{f}" for s, _, f in TILE_CASES])
def test_sorted_tile_walk_is_bitwise_the_plain_order(rng, shape, flow_scale, field, tile):
    """The model of the sorted gather, at the source's tile (one ragged tile
    spanning the whole width here, so neighbouring key rows share a key) and
    at 3 x 5 tiles (many, ragged at the right and bottom edges), each with
    the kernel's capacity at this C and with 2 entries (the chunked walk in
    every tile that holds more), is bit-equal to `splat_sum_sorted_plain`."""
    vals, flow = _collisions(rng) if field == "collisions" else _inputs(rng, shape, flow_scale,
                                                                         field)
    rows, cols = ((SORTED_TILE["kRows"], SORTED_TILE["kCols"]) if tile == "kernel" else (3, 5))
    ref = splat_sum_sorted_plain(torch.from_numpy(vals), torch.from_numpy(flow)).numpy()
    for capacity in (sorted_capacity(vals.shape[3], SORTED_TILE), 2):
        got, chunked = _sorted_tile_walk(vals, flow, rows, cols, capacity)
        assert got.dtype == np.float32 and np.array_equal(got.view(np.uint32), ref.view(np.uint32))
        if capacity == 2:
            assert chunked > 0


def test_sorted_kernel_source_is_the_tile_staged_gather():
    """One gather kernel staging each tile's key ranges by `cp.async`, no
    float atomic, no segments kernel and no global segment scratch; the
    wrapper allocates only the keys and the output."""
    code = re.sub(r"//[^\n]*", "", SORTED_SRC)
    assert not re.search(r"\batom|\bred\.", code)  # atomicAdd, atom.*, red.* (PTX)
    for gone in ("splat_sorted_segments_kernel", "starts", "wq"):
        assert gone not in code, gone
    for needle in ("splat_sorted_gather_kernel", "cp.async.ca.shared.global",
                   "cp.async.cg.shared.global", "__fadd_rn(acc.x, __fmul_rn(v.x, w))"):
        assert needle in code, needle
    call = inspect.getsource(SortedSplatKernel.__call__)
    assert call.count("torch.empty") == 2 and "launch(" in call
    assert len(SPLAT_SORTED_KERNEL.argtypes) == 5 + 4 + 1


@pytest.mark.parametrize("point", sorted(splat_ablate.SORTED_SWEEP))
def test_sorted_sweep_points_apply_to_the_source(point):
    """Each point of the sorted gather's sweep sets the source's constants;
    each ablation applies to it."""
    dims = splat_ablate.SORTED_SWEEP[point]
    tile = sorted_tile(splat_ablate.sorted_variant_source(SORTED_SRC, *dims))
    assert tuple(tile[k] for k in ("kRows", "kCols", "kSmemBytes", "kGatherThreads",
                                   "kMinBlocks")) == dims
    for name, subs in splat_ablate.SORTED_ABLATIONS.items():
        assert substitute(SORTED_SRC, subs, name) != SORTED_SRC


@pytest.mark.parametrize("name", sorted(splat_ablate.VARIANTS))
def test_ablation_variants_apply_to_the_kernel_source(name):
    out = splat_ablate.variant_source(name, KERNEL_SRC)
    assert (out == KERNEL_SRC) == (name == "kernel")


def test_check_cases_cover_the_kernel_edges():
    """The card's check cases: every channel count of the list, N = 2, value
    counts off a multiple of 4, all three flow fields at the main shape, and
    a collisions case whose one key run is longer than the sorted gather
    stages at once at its C (the chunked walk on the card)."""
    shapes = [s for s, _, _ in CHECK_CASES]
    assert {s[3] for s in shapes} >= {1, 3, 5, 17, 33, 64}
    assert any(s[0] == 2 for s in shapes)
    assert any(np.prod(s) % 4 for s in shapes)
    assert {f for s, f, _ in CHECK_CASES if s == splat_ablate.MAIN_SHAPE} == {
        "random", "smooth", "non_finite"}
    collisions = [(s, std) for s, f, std in CHECK_CASES if f == "collisions"]
    assert len(collisions) == 1
    shape, std = collisions[0]
    _, flow = splat_inputs(shape, "collisions", std, device="cpu")
    keys, _ = splat_sort_keys(flow)
    longest = int(torch.unique(keys, return_counts=True)[1].max())
    assert longest == np.prod(shape[:3]) > sorted_capacity(shape[3], SORTED_TILE)


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
    got = SPLAT_KERNEL(vals, flow)
    torch.cuda.synchronize()
    assert SPLAT_KERNEL.launches == before + 1
    ref = splat_sum_plain(vals, flow)
    ok, bound = kernel_bound_ok(float((got - ref).abs().max()), ref)
    assert ok, (float((got - ref).abs().max()), bound)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,field,std", CHECK_CASES)
def test_sorted_kernel_matches_plain_on_card(shape, field, std):
    """The route (`splat_sum`) launches the sorted kernel once; two calls
    give the same bits, those of its order in plain torch; within the
    atomic kernel's bound of the plain core."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; run on the card")
    vals, flow = splat_inputs(shape, field, std, seed=1)
    before = SPLAT_SORTED_KERNEL.launches
    got = splat_sum(vals, flow)
    torch.cuda.synchronize()
    assert SPLAT_SORTED_KERNEL.launches == before + 1
    assert torch.equal(got, SPLAT_SORTED_KERNEL(vals, flow))
    assert torch.equal(got, splat_sum_sorted_plain(vals, flow))
    ref = splat_sum_plain(vals, flow)
    ok, bound = kernel_bound_ok(float((got - ref).abs().max()), ref)
    assert ok, (float((got - ref).abs().max()), bound)
