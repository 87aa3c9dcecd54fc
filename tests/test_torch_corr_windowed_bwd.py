"""The windowed correlation lookup's backward, on the CPU.

Inputs come from a seeded numpy generator: f1 (N, P, C), the levels
(N, h_l, w_l, C) pooled from one map, coordinates (N, 2, H, W) and the
output's gradient g, fed to every side as they are (JAX's coordinates and
g channels-last). N = 2 and a 12x20 query map; C 32 and 40, radius 0, 2, 4
and 5, 1-4 and 6 levels, in-frame, smooth, border and far (finite)
coordinates, and an odd level size (13x23 pools to 6x11, 3x5, 1x2). Tolerances: float32
d_f1 and d_levels <= 1e-5 x max(1, max|ref|), d_coords <= 1e-4 x max(1,
max|ref|) (float32 sums taken in other orders; d_coords sums the blend's
differences of the dots over the window and the levels):
  * autograd of `windowed_corr_lookup_plain` against `jax.vjp` of JAX
    `windowed_corr_lookup` over (f1, levels, coords);
  * `windowed_corr_lookup_backward_plain`, the backward kernel's formula,
    against that autograd, also with non-finite coordinates (NaN at the
    same places: in d_f1 and d_coords, none in d_levels);
  * `WindowedCorrLookup` wired with the plain forward and backward in
    place of the kernels, against the plain autograd, for each input alone
    and all three needing grad (d_coords is asked for only when coords
    need it), with a misaligned g (copied before the kernel), and without
    grad (the forward alone, no graph);
  * `tools/windowed_ablate.py: bwd_order_model`, the kernel's partition
    and order in plain torch (query tiles, destination keys and runs,
    chunks of a few entries so that tiles take several), against the plain
    backward and against `jax.vjp` under the same bounds, and its order:
    sorted keys, each key's run in entry order, each tile's candidates its
    three key rows' runs, the chunks consecutive pieces of that list and
    the partials added in chunk order.
The backward kernel itself runs only on the card (`cuda` marker); its
`tools/windowed_ablate.py --bwd` ablations are checked here to apply to its
source.
"""

import functools

import jax
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


def _state(rng, n, hw, c, levels, hw2=None):
    """A float32 windowed state from seeded maps: f1 (N, H*W, C) and the
    levels pooled from an (N, C, h2, w2) map."""
    h, w = hw
    h2, w2 = hw2 or hw
    f1 = torch.from_numpy(rng.standard_normal((n, c, h, w), dtype=np.float32))
    f2 = torch.from_numpy(rng.standard_normal((n, c, h2, w2), dtype=np.float32))
    return tcorr.windowed_corr_pyramid(f1, f2, levels)


def _coords(rng, n, hw, hw2, kind) -> np.ndarray:
    """(N, 2, H, W) pixel coordinates into the (h2, w2) map: in the frame,
    the grid plus a smooth flow, around the border, far off it (finite), or
    far with NaN and inf mixed in."""
    (h, w), (h2, w2) = hw, hw2
    if kind == "in_frame":
        out = rng.random((n, 2, h, w)) * np.array([w2 - 1, h2 - 1]).reshape(1, 2, 1, 1)
    elif kind == "smooth":
        grid = np.stack(np.meshgrid(np.arange(w), np.arange(h), indexing="xy"))
        out = grid + smooth_flow(rng, n, h, w, 4.0, coarse=(2, 3)).transpose(0, 3, 1, 2)
    elif kind == "border":
        edge = rng.choice([-4.5, -1.25, -0.5, 0.0, 0.75], size=(n, 2, h, w))
        far = rng.random((n, 2, h, w)) < 0.5
        out = np.where(far, np.array([w2, h2]).reshape(1, 2, 1, 1) - 1 - edge, edge)
    elif kind in ("far", "non_finite"):
        out = rng.choice([-1e3, 1e3, -1e10, 1e10, 3.5, 2.25], size=(n, 2, h, w))
        if kind == "non_finite":
            bad = rng.random((n, 2, h, w)) < 0.1
            out[bad] = rng.choice([np.nan, np.inf, -np.inf], size=int(bad.sum()))
    else:
        raise ValueError(kind)
    return np.ascontiguousarray(out, dtype=np.float32)


# (C, radius, levels, coordinate kind, level-0 map (h2, w2)); the query map is 12x20
CASES = [
    (32, 4, 4, "in_frame", (12, 20)),
    (40, 2, 3, "smooth", (12, 20)),
    (32, 0, 1, "border", (12, 20)),
    (40, 4, 2, "far", (12, 20)),
    (40, 2, 4, "border", (13, 23)),
    (32, 4, 4, "smooth", (13, 23)),
    # the kernels' general case: radius 5 (tap tiles), and 6 levels (two
    # groups of levels) on a map whose smallest level is 2x2
    (32, 5, 4, "in_frame", (12, 20)),
    (40, 2, 6, "border", (64, 80)),
]
HW = (12, 20)


def _inputs(seed, c, radius, levels, kind, hw2):
    rng = np.random.default_rng(seed)
    wc = _state(rng, 2, HW, c, levels, hw2)
    coords = torch.from_numpy(_coords(rng, 2, HW, hw2, kind))
    g = torch.from_numpy(rng.standard_normal(
        (2, levels * (2 * radius + 1) ** 2, *HW), dtype=np.float32))
    return wc, coords, g


def _autograd(wc, coords, g, radius):
    """Autograd of the plain lookup: (d_f1, d_levels, d_coords)."""
    f1 = wc.f1.detach().clone().requires_grad_()
    levels = tuple(x.detach().clone().requires_grad_() for x in wc.f2_levels)
    xy = coords.detach().clone().requires_grad_()
    out = tcorr.windowed_corr_lookup_plain(tcorr.WindowedCorr(f1, levels, wc.shape_hw), xy, radius)
    d = torch.autograd.grad(out, (f1, *levels, xy), g)
    return d[0], d[1:-1], d[-1]


def _close(a, b, tol, what):
    """NaN at the same places, the rest within tol x max(1, max|b|)."""
    a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
    assert a.shape == b.shape, (what, a.shape, b.shape)
    nan = torch.isnan(b)
    assert torch.equal(torch.isnan(a), nan), what
    if bool((~nan).any()):
        scale = max(1.0, float(b[~nan].abs().max()))
        err = float((a[~nan] - b[~nan]).abs().max())
        assert err <= tol * scale, (what, err, scale)


def _hold(got, ref, what):
    """(d_f1, d_levels, d_coords) against the reference: d_f1 and d_levels
    within 1e-5 x max(1, max|ref|), d_coords within 1e-4 x max(1, max|ref|)."""
    assert len(got[1]) == len(ref[1]), what
    _close(got[0], ref[0], 1e-5, f"{what}: d_f1")
    for i, (a, b) in enumerate(zip(got[1], ref[1])):
        _close(a, b, 1e-5, f"{what}: d_level{i}")
    _close(got[2], ref[2], 1e-4, f"{what}: d_coords")


@functools.lru_cache(maxsize=None)
def _jax_grads(c, radius, levels, kind, hw2):
    """`jax.vjp` of JAX `windowed_corr_lookup` on `_inputs(0, ...)`: (output
    shape, (d_f1, d_levels, d_coords)) as numpy, d_coords channels first."""
    wc, coords, g = _inputs(0, c, radius, levels, kind, hw2)

    def lookup(f1, lv, xy):
        return jcorr.windowed_corr_lookup(jcorr.WindowedCorr(f1, lv, HW), xy, radius)

    @jax.jit
    def vjp(f1, lv, xy, ct):
        out, back = jax.vjp(lookup, f1, lv, xy)
        return out.shape, back(ct)

    out_shape, (d_f1, d_levels, d_coords) = vjp(
        jnp.asarray(wc.f1.numpy()), tuple(jnp.asarray(x.numpy()) for x in wc.f2_levels),
        jnp.asarray(coords.permute(0, 2, 3, 1).numpy()), jnp.asarray(g.permute(0, 2, 3, 1).numpy()))
    return out_shape, (np.array(d_f1), [np.array(x) for x in d_levels],
                       np.array(d_coords).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("c,radius,levels,kind,hw2", CASES)
def test_plain_autograd_matches_jax_vjp(c, radius, levels, kind, hw2):
    wc, coords, g = _inputs(0, c, radius, levels, kind, hw2)
    ref = _autograd(wc, coords, g, radius)
    out_shape, jax_grads = _jax_grads(c, radius, levels, kind, hw2)
    assert out_shape == (2, *HW, g.shape[1])
    _hold(ref, jax_grads, f"autograd vs JAX {c} r={radius} L={levels} {kind} {hw2}")
    assert float(ref[0].abs().max()) > 0 and float(ref[2].abs().max()) > 0


MODEL_CHUNK = 24  # entries a chunk in the order model's checks: tiles take several


@pytest.mark.parametrize("c,radius,levels,kind,hw2",
                         CASES + [(32, 4, 4, "non_finite", (12, 20)),
                                  (40, 2, 2, "non_finite", (13, 23))])
def test_order_model_matches_plain_and_jax(c, radius, levels, kind, hw2):
    """The kernel's partition and order in plain torch gives the plain
    backward's gradients, and JAX's, under `_hold`'s bounds (NaN at the same
    places); JAX's only on finite coordinates, as the JAX test above."""
    wc, coords, g = _inputs(0, c, radius, levels, kind, hw2)
    got, plan = windowed_ablate.bwd_order_model(wc, coords, g, radius, chunk_q=MODEL_CHUNK)
    what = f"order model {c} r={radius} L={levels} {kind} {hw2}"
    _hold(got, tcorr.windowed_corr_lookup_backward_plain(wc, coords, g, radius), f"{what} vs plain")
    if kind != "non_finite":
        _hold(got, _jax_grads(c, radius, levels, kind, hw2)[1], f"{what} vs JAX")
        assert any(len(t["chunks"]) > 1 for t in plan["tiles"])
    else:
        bad = ~torch.isfinite(coords).all(dim=1).reshape(2, -1)
        assert bool(torch.isnan(got[0][bad]).all()) and not any(bool(torch.isnan(d).any())
                                                                 for d in got[1])


def test_order_model_order():
    """The order the kernel sums d_levels in, as the model states it: keys
    sorted, each key's run in entry order; a live entry's key is its level
    base's 8x8 key tile (a dead one the sentinel, sorted last); each tile's
    candidates are its three key rows' runs in row order, the key tiles tx
    .. tx + 2, holding every entry whose window reaches the tile; the
    chunks are consecutive pieces of `chunk_q` entries (at least one);
    each tile's d_f2 is its partials added in chunk order, bitwise; and the
    kernel's chunk size and level split rules."""
    c, radius, levels, kind, hw2 = 32, 4, 4, "smooth", (13, 23)
    wc, coords, g = _inputs(7, c, radius, levels, kind, hw2)
    (_, d_levels, _), plan = windowed_ablate.bwd_order_model(wc, coords, g, radius,
                                                             chunk_q=MODEL_CHUNK)
    sizes, keys, order = plan["sizes"], plan["sorted_keys"], plan["order"]
    assert bool((keys[1:] >= keys[:-1]).all())
    same = keys[1:] == keys[:-1]
    assert bool((order[1:][same] > order[:-1][same]).all())
    assert int(keys[-1]) <= sizes.sentinel and sizes.tiles == len(plan["tiles"])
    p = HW[0] * HW[1]
    span = 2 * radius + 2
    multi = 0
    for t in plan["tiles"]:
        b, lvl, ty, tx = t["tile"]
        k0 = b * sizes.keys_per_image + sizes.key_base[lvl] + ty * sizes.kx[lvl] + tx
        parts = []
        for r, (s0, s1) in enumerate(t["runs"]):
            assert bool(((keys[s0:s1] >= k0 + r * sizes.kx[lvl])
                         & (keys[s0:s1] < k0 + r * sizes.kx[lvl] + 3)).all())
            parts.append(order[s0:s1])
        assert torch.equal(t["list"], torch.cat(parts))
        # every live entry of this image and level whose window reaches the tile
        hl, wl = wc.f2_levels[lvl].shape[1:3]
        x0, y0, *_, live, _, _, _, _ = windowed_ablate._level_windows(coords, radius, lvl, hl, wl)
        reach = (live[b] & (x0[b] <= 8 * tx + 7) & (x0[b] + span > 8 * tx)
                 & (y0[b] <= 8 * ty + 7) & (y0[b] + span > 8 * ty)).reshape(-1)
        want = set(((b * levels + lvl) * p + torch.nonzero(reach).reshape(-1)).tolist())
        assert want <= set(t["list"].tolist())
        m, q = len(t["list"]), plan["chunk_q"]
        assert t["chunks"] == [(i, min(i + q, m)) for i in range(0, max(1, m), q)]
        multi += len(t["chunks"]) > 1
        total = functools.reduce(lambda a, x: a + x, t["partials"])
        rows, cols = min(8, hl - 8 * ty), min(8, wl - 8 * tx)
        assert torch.equal(d_levels[lvl][b, 8 * ty:8 * ty + rows, 8 * tx:8 * tx + cols],
                           total[:rows, :cols])
    assert multi > 0
    assert [tcorr.bwd_chunk_queries(e) for e in (1, 12544, 58880, 278528, 10**8)] == [
        128, 128, 512, 1024, 1024]
    # the query side splits the levels only where its tiles are few: the
    # stage-2 step's (4, 28x28) lookups and 720p F's, not the 2K RAFT lookup
    assert [tcorr.bwd_split_levels(*s) for s in ((4, 28, 28), (1, 92, 160), (2, 136, 256))] == [
        True, True, False]


@pytest.mark.parametrize("c,radius,levels,kind,hw2",
                         CASES + [(32, 4, 4, "non_finite", (12, 20)),
                                  (40, 2, 2, "non_finite", (13, 23))])
def test_backward_plain_matches_autograd(c, radius, levels, kind, hw2):
    wc, coords, g = _inputs(1, c, radius, levels, kind, hw2)
    ref = _autograd(wc, coords, g, radius)
    got = tcorr.windowed_corr_lookup_backward_plain(wc, coords, g, radius)
    assert got[0].dtype == got[2].dtype == torch.float32
    _hold(got, ref, f"plain backward vs autograd {c} r={radius} L={levels} {kind} {hw2}")
    if kind == "non_finite":
        bad = ~torch.isfinite(coords).all(dim=1).reshape(2, -1)  # (N, P)
        assert bool(bad.any())
        assert bool(torch.isnan(got[0][bad]).all()) and not bool(torch.isnan(got[0][~bad]).any())
        assert not any(bool(torch.isnan(d).any()) for d in got[1])


class _PlainForward:
    """Stands in for a forward kernel object: the plain lookup, counted."""

    def __init__(self):
        self.launches = 0

    def __call__(self, wc, coords, radius=4):
        self.launches += 1
        assert not torch.is_grad_enabled()
        return tcorr.windowed_corr_lookup_plain(wc, coords, radius)


class _PlainBackward:
    """Stands in for `WINDOWED_CORR_BWD_KERNEL`: the plain backward, counted,
    with what the caller asked of d_coords kept; g must be what the kernel
    takes, contiguous and 16-byte aligned."""

    def __init__(self):
        self.launches, self.need_coords = 0, []

    def __call__(self, wc, coords, g, radius=4, need_coords=True):
        assert g.is_contiguous() and g.data_ptr() % 16 == 0
        self.launches += 1
        self.need_coords.append(need_coords)
        d_f1, d_levels, d_coords = tcorr.windowed_corr_lookup_backward_plain(wc, coords, g, radius)
        return d_f1, d_levels, d_coords if need_coords else None


@pytest.mark.parametrize("needs", ["f1", "levels", "coords", "all"])
def test_function_wiring_matches_plain_autograd(monkeypatch, needs):
    fwd, bwd = _PlainForward(), _PlainBackward()
    monkeypatch.setattr(tcorr, "WINDOWED_CORR_TF32_KERNEL", fwd)
    monkeypatch.setattr(tcorr, "WINDOWED_CORR_BWD_KERNEL", bwd)
    radius = 2
    wc, coords, g = _inputs(2, 32, radius, 3, "smooth", (13, 23))
    f1 = wc.f1.clone().requires_grad_(needs in ("f1", "all"))
    levels = tuple(x.clone().requires_grad_(needs in ("levels", "all")) for x in wc.f2_levels)
    xy = coords.clone().requires_grad_(needs in ("coords", "all"))
    out = tcorr.WindowedCorrLookup.apply(xy, f1, *levels, radius)
    inputs = [t for t in (f1, *levels, xy) if t.requires_grad]
    got = torch.autograd.grad(out, inputs, g)
    ref_all = _autograd(wc, coords, g, radius)
    ref = [t for t, on in zip((ref_all[0], *ref_all[1], ref_all[2]), (f1, *levels, xy))
           if on.requires_grad]
    assert fwd.launches == 1 and bwd.launches == 1
    assert bwd.need_coords == [needs in ("coords", "all")]
    assert torch.equal(out, tcorr.windowed_corr_lookup_plain(wc, coords, radius))
    for a, b in zip(got, ref, strict=True):
        tol = 1e-4 if a.shape == coords.shape else 1e-5
        assert float((a - b).abs().max()) <= tol * max(1.0, float(b.abs().max()))


def test_function_backward_aligns_g(monkeypatch):
    """torch.cat's backward hands a joined lookup's gradient on as a
    contiguous view at an offset (N = 1, as GIMMVFI_R joins its two
    lookups); with an odd H*W the view is not 16-byte aligned, and the
    backward copies it before the kernel sees it."""
    fwd, bwd = _PlainForward(), _PlainBackward()
    monkeypatch.setattr(tcorr, "WINDOWED_CORR_TF32_KERNEL", fwd)
    monkeypatch.setattr(tcorr, "WINDOWED_CORR_BWD_KERNEL", bwd)
    rng = np.random.default_rng(5)
    radius, hw = 1, (5, 7)
    wc = _state(rng, 1, hw, 16, 2)
    coords = torch.from_numpy(_coords(rng, 1, hw, hw, "in_frame"))
    lead = torch.zeros((1, 1, *hw))
    g = torch.from_numpy(rng.standard_normal((1, 1 + 2 * 9, *hw), dtype=np.float32))
    grads = []
    for lookup in (lambda f1: tcorr.WindowedCorrLookup.apply(coords, f1, *wc.f2_levels, radius),
                   lambda f1: tcorr.windowed_corr_lookup_plain(
                       tcorr.WindowedCorr(f1, wc.f2_levels, hw), coords, radius)):
        f1 = wc.f1.clone().requires_grad_()
        out = lookup(f1)
        offsets = []
        out.register_hook(lambda t: offsets.append(t.data_ptr() % 16))
        grads.append(torch.autograd.grad(torch.cat([lead, out], dim=1), f1, g)[0])
    assert offsets == [12] and bwd.launches == 1 and fwd.launches == 1
    assert float((grads[0] - grads[1]).abs().max()) <= 1e-5 * max(1.0, float(grads[1].abs().max()))


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "no_input_needs_grad"])
def test_function_without_grad_launches_the_forward_alone(monkeypatch, mode):
    """Every CUDA lookup goes through `WindowedCorrLookup`; where no
    gradient can be asked for, it launches the forward once, returns the
    plain lookup's output and records no graph."""
    fwd, bwd = _PlainForward(), _PlainBackward()
    monkeypatch.setattr(tcorr, "WINDOWED_CORR_TF32_KERNEL", fwd)
    monkeypatch.setattr(tcorr, "WINDOWED_CORR_BWD_KERNEL", bwd)
    wc, coords, _ = _inputs(6, 32, 2, 3, "smooth", (13, 23))
    needs = mode != "no_input_needs_grad"
    f1 = wc.f1.clone().requires_grad_(needs)
    context = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode}.get(
        mode, torch.enable_grad)
    with context():
        out = tcorr.WindowedCorrLookup.apply(coords, f1, *wc.f2_levels, 2)
    assert fwd.launches == 1 and bwd.launches == 0
    assert out.grad_fn is None and not out.requires_grad
    assert torch.equal(out, tcorr.windowed_corr_lookup_plain(wc, coords, 2))


@pytest.mark.parametrize("fault,match", [("shape", "g must have shape"),
                                         ("dtype", "g must be torch.bfloat16"),
                                         ("strided", "g must be contiguous"),
                                         ("none", "must be a CUDA tensor")])
def test_backward_wrapper_refuses_a_wrong_g(fault, match):
    """g must have the output's shape and the features' dtype, contiguous;
    the checks run before any build, so they hold on the CPU."""
    wc, coords, g = _inputs(4, 16, 1, 2, "in_frame", (12, 20))
    wc = tcorr.WindowedCorr(wc.f1.bfloat16(), tuple(x.bfloat16() for x in wc.f2_levels),
                            wc.shape_hw)
    g = {"shape": g[:, :9].bfloat16(), "dtype": g, "strided": g.bfloat16().transpose(2, 3).contiguous()
         .transpose(2, 3), "none": g.bfloat16()}[fault]
    before = tcorr.WINDOWED_CORR_BWD_KERNEL.launches
    with pytest.raises((TypeError, ValueError), match=match):
        tcorr.WINDOWED_CORR_BWD_KERNEL(wc, coords, g, 1)
    assert tcorr.WINDOWED_CORR_BWD_KERNEL.launches == before


@pytest.mark.parametrize("name", list(windowed_ablate.BWD_VARIANTS))
def test_bwd_variants_apply_to_the_kernel_source(name):
    """Each `--bwd` ablation's substitution occurs once in the kernel's
    source: `bwd_no_levels` launches none of the destination side's
    kernels, `bwd_no_stage` stages no window row; the source itself has no
    atomic."""
    src = (CSRC / "windowed_corr_bwd.cu").read_text()
    text = windowed_ablate.bwd_variant_source(name, src)
    assert text != src and "atomicAdd" not in src
    stages = text.count("cp_async16(smem_addr(dst + px * rs")
    assert (stages, "if (false)" in text) == {"bwd_no_levels": (1, True),
                                              "bwd_no_stage": (0, False)}[name]


def test_bwd_ablation_needs_the_card():
    """Off the card the `--bwd` ablation raises instead of running anything."""
    if torch.cuda.is_available():
        pytest.skip("runs on a CPU-only machine")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        windowed_ablate.main_bwd()


# (C, dtype, coordinate kind, radius, levels, map size) on the card
CARD_CASES = [
    (256, torch.float32, "in_frame", 4, 4, (20, 28)),
    (256, torch.bfloat16, "smooth", 4, 4, (20, 40)),
    (40, torch.float32, "non_finite", 2, 3, (13, 23)),
    (8, torch.bfloat16, "border", 0, 1, (7, 9)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("c,dtype,kind,radius,levels,hw", CARD_CASES)
def test_backward_kernel_matches_plain_on_card(c, dtype, kind, radius, levels, hw):
    """The backward kernel against its plain version, with d_coords and
    without (its d_f1 and d_levels): float32 as `_hold`; bf16 d_f1 and
    d_levels within one bf16 step (2**-7 |plain| + 1e-6 max|plain|),
    d_coords (float32) as `_hold`'s. One launch a call; two calls give
    bitwise equal d_levels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; run on the card")
    rng = np.random.default_rng(3)
    f1 = torch.from_numpy(rng.standard_normal((2, c, *hw), dtype=np.float32)).to(dtype)
    f2 = torch.from_numpy(rng.standard_normal((2, c, *hw), dtype=np.float32)).to(dtype)
    wc = tcorr.windowed_corr_pyramid(f1.cuda(), f2.cuda(), levels)
    coords = torch.from_numpy(_coords(rng, 2, hw, hw, kind)).cuda()
    g = torch.from_numpy(rng.standard_normal(
        (2, levels * (2 * radius + 1) ** 2, *hw), dtype=np.float32)).to(dtype).cuda()
    ref = tcorr.windowed_corr_lookup_backward_plain(wc, coords, g, radius)
    for need_coords in (True, False):
        before = tcorr.WINDOWED_CORR_BWD_KERNEL.launches
        got = tcorr.WINDOWED_CORR_BWD_KERNEL(wc, coords, g, radius, need_coords)
        again = tcorr.WINDOWED_CORR_BWD_KERNEL(wc, coords, g, radius, need_coords)
        torch.cuda.synchronize()
        assert tcorr.WINDOWED_CORR_BWD_KERNEL.launches == before + 2
        assert (got[2] is not None) == need_coords
        assert windowed_ablate.bitwise_equal(got[1], again[1])  # d_levels over two calls
        if dtype == torch.float32:
            _hold([got[0].cpu(), [d.cpu() for d in got[1]], ref[2].cpu() if got[2] is None
                   else got[2].cpu()],
                  [ref[0].cpu(), [d.cpu() for d in ref[1]], ref[2].cpu()], "kernel vs plain")
            continue
        for a, b in [(got[0], ref[0])] + list(zip(got[1], ref[1])):
            assert a.dtype == torch.bfloat16
            b = b.to(torch.bfloat16).float()
            a = a.float()
            nan = torch.isnan(b)
            assert torch.equal(torch.isnan(a), nan)
            scale = float(b[~nan].abs().max())
            assert bool(((a - b)[~nan].abs() <= 2.0**-7 * b[~nan].abs() + 1e-6 * scale).all())
        if need_coords:
            _close(got[2].cpu(), ref[2].cpu(), 1e-4, "kernel vs plain: d_coords")
