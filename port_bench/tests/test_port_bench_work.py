"""The copied work formulas and FLOP counter."""

import numpy as np
import pytest
import torch

from port_bench.flops import count
from port_bench.reference.gimmvfi import GIMMVFI, Precision, interpolate_padded
from port_bench.reference.ops import coords_grid, windowed_corr_lookup, windowed_corr_pyramid
from port_bench.weights import make_weights, state_shapes
from port_bench.work import softsplat_sorted, windowed_corr


def test_splat_bytes_at_720p():
    nbytes, ops, bound = softsplat_sorted.work(torch.zeros(1, 736, 1280, 17),
                                               torch.zeros(1, 736, 1280, 2))
    assert nbytes == 135_659_520 and ops == 0  # PERF.md section 6: 135.7 MB
    assert bound == pytest.approx(0.0405e-3, rel=2e-3)


def test_windowed_lookup_work_at_720p_f():
    f = torch.zeros(1, 256, 92, 160)
    wc = windowed_corr_pyramid(f, f, 4)
    nbytes, dots, bound = windowed_corr.work(wc, coords_grid(1, 92, 160, "cpu"), 4)
    assert nbytes == 54_277_120  # PERF.md section 6: 54.3 MB
    # every query at its own pixel: 2.54 GFLOP (section 6's 2.56 was on random in-frame taps)
    assert dots == 2_540_812_800
    assert bound == pytest.approx(max(nbytes / 3.35e12, 3 * dots / 495e12))


def test_windowed_taps_match_a_brute_count():
    """The dots count each tap on its level's map once: compare with taps
    enumerated one by one on a small map with coordinates off the edges."""
    g = torch.Generator().manual_seed(3)
    f = torch.randn(1, 8, 9, 13, generator=g)
    wc = windowed_corr_pyramid(f, f, 3)
    coords = coords_grid(1, 9, 13, "cpu") + 6 * torch.randn(1, 2, 9, 13, generator=g)
    _, dots, _ = windowed_corr.work(wc, coords, 2)
    taps = 0
    for i, f2 in enumerate(wc.f2_levels):
        hl, wl = f2.shape[1:3]
        for x, y in coords.reshape(2, -1).T.tolist():
            x0, y0 = int(np.floor(x / 2**i)) - 2, int(np.floor(y / 2**i)) - 2
            taps += sum(0 <= x0 + a < wl and 0 <= y0 + b < hl for a in range(6) for b in range(6))
    assert dots == 2 * 8 * taps


def test_windowed_lookup_is_the_volumes_lookup():
    from port_bench.reference.ops import all_pairs_corr, corr_lookup, pool_levels

    g = torch.Generator().manual_seed(4)
    f1, f2 = torch.randn(1, 16, 12, 20, generator=g), torch.randn(1, 16, 12, 20, generator=g)
    coords = coords_grid(1, 12, 20, "cpu") + 3 * torch.randn(1, 2, 12, 20, generator=g)
    a = windowed_corr_lookup(windowed_corr_pyramid(f1, f2, 3), coords, 4)
    b = corr_lookup(pool_levels(all_pairs_corr(f1, f2), 3), coords, 4)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", ["r", "f"])
def test_flop_count_equals_the_ports(kind):
    """The copied rules over the reference count what `bench.count_flops`
    counts over the port, at a small size on the CPU."""
    from gimmvfi_tpu_torch.bench import count_flops
    from gimmvfi_tpu_torch.models.gimmvfi_f import GIMMVFI_F
    from gimmvfi_tpu_torch.models.gimmvfi_r import GIMMVFI_R, interpolate_sequential

    names = {"compute": "bfloat16", "hyponet": "float32", "flow": "float32"}
    ref = GIMMVFI("raft" if kind == "r" else "flowformer", 2, Precision.named(names))
    port = (GIMMVFI_R(raft_iters=2, dtype=torch.bfloat16, device="cpu", remat=False)
            if kind == "r" else GIMMVFI_F(ff_iters=2, dtype=torch.bfloat16, device="cpu",
                                          remat=False))
    w = make_weights(state_shapes(ref), 3, "cpu")
    port.load_state_dict(w)
    ref.load_state_dict(w)
    ref.requires_grad_(False)
    rng = np.random.default_rng(0)
    a, b = (rng.random((128, 192, 3), dtype=np.float32) for _ in range(2))
    xs = torch.from_numpy(np.stack([a, b]))[None]
    ts = [0.25, 0.5]
    theirs = sum(count_flops(port, lambda: interpolate_sequential(port, xs, ts, None)).values())
    ours, log = count(lambda: interpolate_padded(ref, a, b, ts, None))
    assert ours == theirs
    assert [k for k, *_ in log] == ["softsplat_sorted"] * 4  # two splats a timestep
