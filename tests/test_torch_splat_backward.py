"""The splat's backward: the port's plain version and autograd against the
JAX package, on the CPU.

`splat_sum_backward_plain` (what the backward kernel computes) is held
against the JAX gather-form VJP `_splat_pallas_bwd`, called directly (it is
plain jnp), and against `jax.vjp` of the XLA scatter core, on random,
smooth, far and non-finite flows with C in {1, 3, 17, 33}, N = 2; autograd
through `splat_sum_plain` (what a CPU tensor runs) against it; and
`softsplat(..., "linear-zeroeps")`'s gradients for values, metric and flow
against JAX's. Tolerance: d_vals and d_flow <= 1e-5 x max(1, max|ref|)
(float32 sums in another order). The backward kernel's wrapper refuses
what it does not take before it builds; the kernel's walk is followed on
the CPU by a model (`_kernel_model`: its tiles, its flat walk with the
(pixel, channel) pair stepped as the source steps it, its d_flow chunks
and its pixel sums in channel order) held against the plain version; the
kernel itself and `SplatSum` run only on the card (`cuda` marker), where
d_vals and d_flow must also be bitwise the same over two calls.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gimmvfi_tpu.ops.softsplat import _splat_core_xla, _splat_pallas_bwd
from gimmvfi_tpu.ops.softsplat import softsplat as jax_softsplat
from gimmvfi_tpu_torch.ops.softsplat import (
    SPLAT_BACKWARD_KERNEL,
    SPLAT_KERNEL,
    splat_sum,
    splat_sum_backward_plain,
    splat_sum_plain,
    softsplat,
)
from gimmvfi_tpu_torch.tools import splat_ablate
from gimmvfi_tpu_torch.tools.splat_ablate import BWD_CASES, bwd_inputs, smooth_flow, splat_inputs
from gimmvfi_tpu_torch.utils.kernel_build import CSRC

torch.set_num_threads(1)
KERNEL_SRC = (CSRC / "softsplat_bwd.cu").read_text()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", KERNEL_SRC).group(1))


PIXELS = _constant("kPixels")
TILE_ROWS = (_constant("kTileRowsVals"), _constant("kTileRowsFlow"))
UNROLL = (_constant("kUnrollVals"), _constant("kUnrollFlow"))
PITCH = _constant("kPitch")

# (N, H, W, C), flow field, flow std in px
CASES = [
    ((2, 16, 24, 5), "random", 0.5),
    ((2, 16, 24, 5), "random", 3.0),
    ((2, 16, 24, 5), "random", 40.0),
    ((2, 12, 20, 1), "random", 2.0),
    ((2, 14, 18, 3), "smooth", 4.0),
    ((2, 10, 16, 17), "smooth", 3.0),
    ((2, 9, 13, 33), "random", 6.0),
    ((2, 12, 16, 3), "far", 1e4),
    ((2, 12, 16, 17), "non_finite", 3.0),
]


def _inputs(shape, field, std, seed):
    rng = np.random.default_rng(seed)
    n, h, w, c = shape
    vals = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    if field == "smooth":
        flow = smooth_flow(rng, n, h, w, std, coarse=(3, 4))
    else:
        flow = (rng.standard_normal((n, h, w, 2)) * std).astype(np.float32)
    if field == "far":  # most positions off the frame, a few just inside
        flow[:, ::3, ::3] = rng.uniform(-3, 3, flow[:, ::3, ::3].shape)
    if field == "non_finite":
        flow[0, 3, 4, 0] = np.nan
        flow[0, 5, 6, 1] = np.inf
        flow[1, 7, 1, 0] = -np.inf
        flow[1, 2, 2, :] = 1e30
    return vals, flow, g


def _bound(ref) -> float:
    return 1e-5 * max(1.0, float(np.abs(np.asarray(ref)).max()))


def _agrees(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= _bound(ref), (err, _bound(ref))


@pytest.mark.parametrize("shape,field,std", CASES)
def test_plain_backward_matches_jax(shape, field, std):
    vals, flow, g = _inputs(shape, field, std, seed=sum(shape))
    ref_bwd = _splat_pallas_bwd((jnp.asarray(vals), jnp.asarray(flow)), jnp.asarray(g))
    _, vjp = jax.vjp(_splat_core_xla, jnp.asarray(vals), jnp.asarray(flow))
    ref_vjp = vjp(jnp.asarray(g))
    d_vals, d_flow = splat_sum_backward_plain(torch.from_numpy(vals), torch.from_numpy(flow),
                                              torch.from_numpy(g))
    for ref in (ref_bwd, ref_vjp):
        _agrees(d_vals, ref[0])
        _agrees(d_flow, ref[1])
    assert torch.isfinite(d_flow).all() and torch.isfinite(d_vals).all()
    d_vals_only, none = splat_sum_backward_plain(torch.from_numpy(vals), torch.from_numpy(flow),
                                                 torch.from_numpy(g), need_flow=False)
    assert none is None and torch.equal(d_vals_only, d_vals)


@pytest.mark.parametrize("shape,field,std", CASES)
def test_autograd_through_plain_core_matches_plain_backward(shape, field, std):
    """What a CPU tensor runs (`splat_sum` -> `splat_sum_plain`, index_add_
    under autograd) has the plain backward's gradients."""
    vals, flow, g = _inputs(shape, field, std, seed=7 + sum(shape))
    tv = torch.from_numpy(vals).requires_grad_()
    tf = torch.from_numpy(flow).requires_grad_()
    out = splat_sum(tv, tf)
    out.backward(torch.from_numpy(g))
    d_vals, d_flow = splat_sum_backward_plain(torch.from_numpy(vals), torch.from_numpy(flow),
                                              torch.from_numpy(g))
    _agrees(tv.grad, d_vals)
    _agrees(tf.grad, d_flow)


@pytest.mark.parametrize("std", [0.7, 5.0])
def test_softsplat_linear_zeroeps_gradients_match_jax(std):
    """GIMM's splat mode, gradients for values, metric and flow, against
    `jax.grad` of the JAX softsplat on the same weighted sum."""
    rng = np.random.default_rng(int(std * 10))
    n, h, w, c = 2, 14, 20, 4
    ten = rng.standard_normal((n, h, w, c)).astype(np.float32)
    flow = (rng.standard_normal((n, h, w, 2)) * std).astype(np.float32)
    metric = (rng.random((n, h, w, 1)) + 0.5).astype(np.float32)
    weight = rng.standard_normal((n, h, w, c)).astype(np.float32)

    def jax_loss(t, f, m):
        return jnp.sum(jax_softsplat(t, f, m, "linear-zeroeps") * weight)

    refs = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(ten), jnp.asarray(flow),
                                                 jnp.asarray(metric))
    tt, tf, tm = (torch.from_numpy(x).requires_grad_() for x in (ten, flow, metric))
    (softsplat(tt, tf, tm, "linear-zeroeps") * torch.from_numpy(weight)).sum().backward()
    for got, ref in zip((tt.grad, tf.grad, tm.grad), refs):
        _agrees(got, ref)


def _faulty(fault):
    vals = torch.zeros(1, 4, 6, 3)
    flow = torch.zeros(1, 4, 6, 2)
    g = torch.zeros(1, 4, 6, 3)
    if fault == "vals_dtype":
        return vals.double(), flow, g, TypeError, "vals must be torch.float32"
    if fault == "g_dtype":
        return vals, flow, g.half(), TypeError, "g must be torch.float32"
    if fault == "g_shape":
        return vals, flow, torch.zeros(1, 4, 6, 4), ValueError, r"g must have shape \(1, 4, 6, 3\)"
    if fault == "g_non_contiguous":
        return vals, flow, torch.zeros(1, 6, 4, 3).transpose(1, 2), ValueError, "contiguous"
    if fault == "flow_shape":
        return vals, torch.zeros(1, 4, 6, 3), g, ValueError, r"flow must have shape \(1, 4, 6, 2\)"
    if fault == "g_device":
        return vals, flow, g.to("meta"), ValueError, "g is on meta"
    if fault == "rank":
        return vals[0], flow, g, ValueError, r"vals \(N, H, W, C\)"
    return vals, flow, g, ValueError, "CUDA tensor"


@pytest.mark.parametrize("fault", ["vals_dtype", "g_dtype", "g_shape", "g_non_contiguous",
                                   "flow_shape", "g_device", "rank", "cpu"])
def test_backward_wrapper_checks_before_building(fault):
    vals, flow, g, error, match = _faulty(fault)
    before = SPLAT_BACKWARD_KERNEL.launches
    with pytest.raises(error, match=match):
        SPLAT_BACKWARD_KERNEL(vals, flow, g)
    assert SPLAT_BACKWARD_KERNEL._fn is None
    assert SPLAT_BACKWARD_KERNEL.launches == before


def test_forward_kernel_refuses_a_graph_it_cannot_carry():
    """Called directly with grad on, the forward kernel raises instead of
    returning a detached output; `splat_sum` carries the graph."""
    vals = torch.zeros(1, 4, 6, 3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="splat_sum"):
        SPLAT_KERNEL(vals, torch.zeros(1, 4, 6, 2))


def _geometry(flow: np.ndarray, p: np.ndarray, h: int, w: int):
    """The kernel's step 1 for source pixels `p` (flat indices): corner
    destinations (-1 where masked) and weights, each (len(p), 4), and the
    factors (wx0, wx1, wy0, wy1), in float32 as the kernel computes them."""
    f32 = np.float32
    fl = flow.reshape(-1, 2)[p]
    j, i = p % w, (p // w) % h
    img0 = p - (i * w + j)
    with np.errstate(invalid="ignore", over="ignore"):
        x, y = j.astype(f32) + fl[:, 0], i.astype(f32) + fl[:, 1]
        ok = np.isfinite(x) & np.isfinite(y)
    x, y = np.where(ok, x, f32(-10)), np.where(ok, y, f32(-10))
    x0f, y0f = np.floor(x), np.floor(y)
    wx1, wy1 = x - x0f, y - y0f
    wx0, wy0 = f32(1) - wx1, f32(1) - wy1
    x0 = np.clip(x0f, -2, w).astype(np.int64)
    y0 = np.clip(y0f, -2, h).astype(np.int64)
    base = img0 + y0 * w + x0
    dst, wgt = [], []
    for dx, dy, wk in ((0, 0, wx0 * wy0), (1, 0, wx1 * wy0), (0, 1, wx0 * wy1), (1, 1, wx1 * wy1)):
        inside = (x0 + dx >= 0) & (x0 + dx < w) & (y0 + dy >= 0) & (y0 + dy < h)
        dst.append(np.where(inside, base + dy * w + dx, -1))
        wgt.append(wk)
    return np.stack(dst, -1), np.stack(wgt, -1), (wx0, wx1, wy0, wy1)


def _walk_order(np_: int, ck: int, pixels: int, unroll: int):
    """The (pixel, channel) pair of each value the kernel's walk visits,
    stepped as the source steps it: thread t starts at value t, takes
    `unroll` values `pixels` apart, then moves on by unroll x pixels.
    Returns the values' (e, q, r), each an array."""
    m = np_ * ck
    dq, dr = divmod(pixels, ck)
    es, qs, rs = [], [], []
    for t in range(pixels):
        q, r = divmod(t, ck)
        for e0 in range(t, m, unroll * pixels):
            for u in range(unroll):
                if e0 + u * pixels < m:
                    es.append(e0 + u * pixels)
                    qs.append(q)
                    rs.append(r)
                q, r = q + dq, r + dr
                if r >= ck:
                    r, q = r - ck, q + 1
    return np.array(es), np.array(qs), np.array(rs)


def _kernel_model(vals, flow, g, need_flow, tile_rows=None, pitch=None, unroll=None):
    """`csrc/softsplat_bwd.cu` on the CPU, block by block: the tile's
    pixels, its walk (whose (pixel, channel) pairs must be e's), each value
    written once; with d_flow, the walk over chunks of `pitch` channels and
    the pixel's sums of its products in channel order. Returns (d_vals,
    d_flow or None) and checks that every value was written exactly once."""
    rows_of_tile = (tile_rows or TILE_ROWS)[int(need_flow)]
    tile = (rows_of_tile, PIXELS // rows_of_tile)
    pitch, unroll = pitch or PITCH, (unroll or UNROLL)[int(need_flow)]
    n, h, w, c = vals.shape
    pixels = tile[0] * tile[1]
    vflat, gflat = vals.reshape(-1, c), g.reshape(-1, c)
    d_vals = np.zeros(n * h * w * c, np.float32)
    written = np.zeros(n * h * w * c, np.int64)
    d_flow = np.zeros((n * h * w, 2), np.float32)
    tiles_x, tiles_y = math.ceil(w / tile[1]), math.ceil(h / tile[0])
    for blk in range(n * tiles_x * tiles_y):
        tx, ty, b = blk % tiles_x, (blk // tiles_x) % tiles_y, blk // tiles_x // tiles_y
        i0, j0 = ty * tile[0], tx * tile[1]
        rows, cols = min(tile[0], h - i0), min(tile[1], w - j0)
        t = np.arange(rows * cols)
        p = b * h * w + (i0 + t // cols) * w + j0 + t % cols
        dst, wgt, (wx0, wx1, wy0, wy1) = _geometry(flow, p, h, w)
        chunks = [(c0, min(pitch, c - c0)) for c0 in range(0, c, pitch)] if need_flow else [(0, c)]
        sums = np.zeros((len(p), 4), np.float32)
        for c0, ck in chunks:
            e, q, r = _walk_order(len(p), ck, pixels, unroll)
            assert np.array_equal(np.sort(e), np.arange(len(p) * ck))
            assert np.array_equal(q * ck + r, e)
            at = p[q] * c + c0 + r
            gk = np.where(dst[q] >= 0, gflat[np.maximum(dst[q], 0), (c0 + r)[:, None]], 0)
            gk = gk.astype(np.float32)
            d_vals[at] = (wgt[q] * gk).sum(-1, dtype=np.float32)
            written[at] += 1
            if need_flow:
                prod = np.zeros((len(p), ck, 4), np.float32)
                prod[q, r] = vflat[p[q], c0 + r][:, None] * gk
                for rr in range(ck):  # the pixel's thread, in channel order
                    sums += prod[:, rr]
        if need_flow:
            m = (dst >= 0).astype(np.float32)
            s00, s01, s10, s11 = (sums * m).T
            du = -wy0 * s00 + wy0 * s01 - wy1 * s10 + wy1 * s11
            dv = -wx0 * s00 - wx1 * s01 + wx0 * s10 + wx1 * s11
            d_flow[p] = np.stack([du, dv], -1)
    assert (written == 1).all()
    return d_vals.reshape(vals.shape), (d_flow.reshape(*vals.shape[:3], 2) if need_flow else None)


# (N, H, W, C), field, std: a tile-aligned frame; W off the 32-column tile
# and H off its 4 rows; C above one d_flow chunk; even C; C over a block's
# thread count (one value a thread per round); one pixel
MODEL_CASES = [
    ((1, 8, 64, 17), "smooth", 4.0),
    ((2, 7, 37, 5), "random", 3.0),
    ((1, 5, 13, 130), "random", 2.0),
    ((1, 6, 45, 16), "non_finite", 3.0),
    ((1, 3, 4, 300), "random", 1.5),
    ((1, 1, 1, 3), "random", 0.5),
]


@pytest.mark.parametrize("need_flow", [True, False], ids=["full", "d_vals"])
@pytest.mark.parametrize("shape,field,std", MODEL_CASES)
def test_kernel_model_matches_plain(shape, field, std, need_flow):
    vals, flow, g = (x.numpy() for x in bwd_inputs(shape, field, std, seed=sum(shape),
                                                   device="cpu"))
    if field == "non_finite":
        flow[0, 1, 2] = np.nan
        flow[0, 3, 4, 1] = np.inf
    d_vals, d_flow = _kernel_model(vals, flow, g, need_flow)
    ref_vals, ref_flow = splat_sum_backward_plain(*(torch.from_numpy(x) for x in (vals, flow, g)),
                                                  need_flow=need_flow)
    _agrees(d_vals, ref_vals)
    if need_flow:
        _agrees(d_flow, ref_flow)
    else:
        assert d_flow is None and ref_flow is None


@pytest.mark.parametrize("variant", ["vals_tile4x32", "flow_raster", "vals_unroll2",
                                     "flow_unroll2", "pitch17", "pitch5"])
def test_kernel_model_of_each_tile_variant(variant):
    """The ablation's tile and unroll variants change only constants, and
    the walk stays right under each."""
    text = splat_ablate.bwd_variant_source(variant, KERNEL_SRC)
    const = {name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
             for name in ("kTileRowsVals", "kTileRowsFlow", "kUnrollVals", "kUnrollFlow",
                          "kPitch")}
    shape = (1, 9, 37, 20)
    vals, flow, g = (x.numpy() for x in bwd_inputs(shape, "random", 3.0, seed=9, device="cpu"))
    ref_vals, ref_flow = splat_sum_backward_plain(*(torch.from_numpy(x) for x in (vals, flow, g)))
    for need_flow in (True, False):
        d_vals, d_flow = _kernel_model(vals, flow, g, need_flow,
                                       tile_rows=(const["kTileRowsVals"],
                                                  const["kTileRowsFlow"]),
                                       pitch=const["kPitch"],
                                       unroll=(const["kUnrollVals"], const["kUnrollFlow"]))
        _agrees(d_vals, ref_vals)
        if need_flow:
            _agrees(d_flow, ref_flow)


def test_kernel_source_is_the_pixel_owner_design():
    """A 2D tile with d_flow, an odd d_flow pitch whose shared memory fits
    the static 48 KB, and no warp shuffle or atomic left: d_flow's sums are
    a pixel thread's, in channel order."""
    assert TILE_ROWS[1] > 1 and PITCH % 2 == 1
    assert all(PIXELS % rows == 0 for rows in TILE_ROWS)
    assert 16 * PIXELS * PITCH + PIXELS * (4 + 16 + 16) <= 48 * 1024
    for gone in ("__shfl", "atomicAdd", "kFullMask"):
        assert gone not in KERNEL_SRC, gone
    for needle in ("s_prod[qs[u] * kPitch + rs[u]] =", "s00 += a.x;",
                   "template <bool kFlow>", "if constexpr (!kFlow)"):
        assert needle in KERNEL_SRC, needle


@pytest.mark.parametrize("name", sorted(splat_ablate.BWD_VARIANTS))
def test_backward_ablation_variants_apply_to_the_kernel_source(name):
    out = splat_ablate.bwd_variant_source(name, KERNEL_SRC)
    assert out is not None and (out == KERNEL_SRC) == (name == "kernel")


def test_backward_check_cases_cover_the_kernel_edges():
    """The card's cases: the training shape on all three fields, C above
    one d_flow chunk and even C, W off each mode's tile columns and H off
    the d_flow tile's rows."""
    shapes = [s for s, _, _ in BWD_CASES]
    assert {f for s, f, _ in BWD_CASES if s == splat_ablate.TRAIN_SPLAT} == {
        "random", "smooth", "non_finite"}
    assert any(s[3] > PITCH for s in shapes) and any(s[3] > 128 for s in shapes)
    assert any(s[3] % 2 == 0 for s in shapes)
    cols = [PIXELS // rows for rows in TILE_ROWS]
    assert all(any(s[2] % n for s in shapes) for n in cols)
    assert any(s[1] % TILE_ROWS[1] for s in shapes)


def test_backward_bound_counts_the_mode_bytes():
    vals = torch.zeros(splat_ablate.TRAIN_SPLAT)
    full, by = splat_ablate.splat_bwd_bound(vals)
    d_vals_only, _ = splat_ablate.splat_bwd_bound(vals, need_flow=False)
    px = 32 * 256 * 256
    assert by == "bytes"
    assert full == pytest.approx(4 * px * (17 * 3 + 4) / 3.35e12 * 1e3)
    assert d_vals_only == pytest.approx(4 * px * (17 * 2 + 2) / 3.35e12 * 1e3)


def test_backward_ablation_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        splat_ablate.main(["--backward"])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,field,std", BWD_CASES)
def test_backward_kernel_matches_plain_on_card(shape, field, std):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; run on the card")
    vals, flow, g = bwd_inputs(shape, field, std, seed=2)
    before = SPLAT_BACKWARD_KERNEL.launches
    d_vals, d_flow = SPLAT_BACKWARD_KERNEL(vals, flow, g)
    d_vals_only, none = SPLAT_BACKWARD_KERNEL(vals, flow, g, need_flow=False)
    torch.cuda.synchronize()
    assert SPLAT_BACKWARD_KERNEL.launches == before + 2
    assert none is None and torch.equal(d_vals_only, d_vals)
    ref_vals, ref_flow = splat_sum_backward_plain(vals, flow, g)
    for got, ref in ((d_vals, ref_vals), (d_flow, ref_flow)):
        err = float((got - ref).abs().max())
        assert err <= 1e-5 * max(1.0, float(ref.abs().max())), err


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["random", "non_finite"])
def test_backward_kernel_is_bitwise_deterministic_on_card(field):
    """Two calls on the same inputs give the same bits, d_flow included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; run on the card")
    vals, flow, g = bwd_inputs((4, 64, 96, 17), field, 8.0, seed=6)
    first = SPLAT_BACKWARD_KERNEL(vals, flow, g)
    second = SPLAT_BACKWARD_KERNEL(vals, flow, g)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.cuda
@pytest.mark.parametrize("needs", ["both", "vals", "flow"])
def test_splat_sum_gradients_on_card(needs):
    """`SplatSum` (both kernels) against autograd through `splat_sum_plain`
    on the same card inputs; d_flow only where flow needs it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; run on the card")
    vals, flow = splat_inputs((2, 40, 56, 17), "smooth", 4.0, seed=4)
    g = torch.randn(vals.shape, generator=torch.Generator().manual_seed(5)).cuda()
    grads = []
    for fn in (splat_sum, splat_sum_plain):
        v = vals.clone().requires_grad_(needs in ("both", "vals"))
        f = flow.clone().requires_grad_(needs in ("both", "flow"))
        fn(v, f).backward(g)
        grads.append((v.grad, f.grad))
    for got, ref in zip(*grads):
        assert (got is None) == (ref is None)
        if ref is not None:
            assert float((got - ref).abs().max()) <= 1e-5 * max(1.0, float(ref.abs().max()))
