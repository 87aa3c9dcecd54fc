"""The splat's PyTorch yardsticks (`tools/splat_ablate.py: library_calls`)
against the port's plain versions, on the CPU.

`chip_smoke.py` times one PyTorch call beside each splat kernel: the
forward splat is `aten.grid_sampler_2d_backward`'s input gradient,
d_vals is `F.grid_sample` and d_flow is the grid gradient of
`aten.grid_sampler_2d_backward`, scaled from normalized to pixel units,
all on the splat's geometry (bilinear, zeros padding, align_corners at
(j + u, i + v)). The port never calls them. This holds them to
`splat_sum_plain` and `splat_sum_backward_plain` where the card cannot be
reached, at C of 1, 17 and 33 on random and smooth fields whose flows
reach a few pixels off the frame. Tolerance: 1e-4 x max(1, max|plain|),
because the yardsticks take each position through normalized coordinates
and back (about 1e-6 of it relative, which moves the bilinear weights by
that much), and sum in another order. d_flow is held away from integer
positions (`near_integer`, 1e-3 px): at one it jumps between bilinear
cells, and the round trip may land on the other side.
"""

import numpy as np
import pytest
import torch

from gimmvfi_tpu_torch.ops.softsplat import splat_sum_backward_plain, splat_sum_plain
from gimmvfi_tpu_torch.tools.splat_ablate import (
    bwd_inputs,
    grid_sample_grid,
    kernel_layout,
    library_agreement,
    library_calls,
    library_tolerance,
    near_integer,
)

torch.set_num_threads(1)

# (N, H, W, C), flow field, flow std in px: the frames are a few std wide,
# so many positions land just off the frame
CASES = [
    ((2, 12, 16, 1), "random", 2.0),
    ((1, 14, 20, 1), "smooth", 4.0),
    ((2, 10, 13, 17), "random", 3.0),
    ((1, 16, 24, 17), "smooth", 5.0),
    ((2, 9, 11, 33), "random", 1.5),
    ((1, 12, 18, 33), "smooth", 6.0),
]


@pytest.mark.parametrize("shape,field,std", CASES)
def test_yardsticks_compute_the_splat_functions(shape, field, std):
    vals, flow, g = bwd_inputs(shape, field, std, seed=sum(shape), device="cpu")
    x = torch.arange(shape[2]).view(1, 1, -1) + flow[..., 0]
    assert bool(((x < 0) | (x > shape[2] - 1)).any())  # some positions leave the frame
    res = library_agreement(vals, flow, g)
    assert set(res) == {"forward", "d_vals", "d_flow"}
    for err, tol, _ in res.values():
        assert err <= tol


def test_yardstick_outputs_are_nchw_and_scaled():
    """The calls return NCHW (d_flow: the grid's (N, H, W, 2)); the
    kernels' layout comes from a permute, and d_flow from dividing the grid
    gradient by ((W - 1) / 2, (H - 1) / 2)."""
    shape = (1, 8, 12, 3)
    vals, flow, g = bwd_inputs(shape, "random", 1.0, seed=3, device="cpu")
    calls = library_calls(vals, flow, g)
    assert calls["d_vals"]().shape == (1, 3, 8, 12)
    assert calls["forward"]().shape == (1, 3, 8, 12)
    assert calls["d_flow"]().shape == (1, 8, 12, 2)
    out = {name: kernel_layout(name, call()) for name, call in calls.items()}
    ref_vals, ref_flow = splat_sum_backward_plain(vals, flow, g)
    grid_grad = calls["d_flow"]()
    assert torch.allclose(out["d_flow"] * torch.tensor([11 / 2, 7 / 2]), grid_grad)
    assert float((out["d_flow"] - ref_flow).abs().max()) <= library_tolerance(ref_flow)
    assert float((out["d_vals"] - ref_vals).abs().max()) <= library_tolerance(ref_vals)
    ref_fwd = splat_sum_plain(vals, flow)
    assert float((out["forward"] - ref_fwd).abs().max()) <= library_tolerance(ref_fwd)


def test_forward_yardstick_alone():
    vals, flow = bwd_inputs((1, 10, 14, 5), "smooth", 3.0, seed=4, device="cpu")[:2]
    calls = library_calls(vals, flow)
    assert set(calls) == {"forward"}
    err, tol, _ = library_agreement(vals, flow)["forward"]
    assert err <= tol


def test_grid_maps_pixels_and_non_finite_positions():
    """align_corners: pixel 0 is -1 and pixel W - 1 is 1; a non-finite
    position goes to (-10, -10) px, as in the kernels, so every corner is
    off the frame."""
    flow = torch.zeros(1, 3, 5, 2)
    flow[0, 1, 2] = torch.tensor([float("nan"), 0.0])
    grid = grid_sample_grid(flow)
    assert torch.allclose(grid[0, 0, 0], torch.tensor([-1.0, -1.0]))
    assert torch.allclose(grid[0, 2, 4], torch.tensor([1.0, 1.0]))
    assert torch.allclose(grid[0, 1, 2], torch.tensor([-10 * 2 / 4 - 1, -10 * 2 / 2 - 1]))
    assert np.isfinite(grid.numpy()).all()


def test_yardstick_refuses_a_disagreement(monkeypatch):
    """`library_agreement` raises where a call is off by more than its
    tolerance (here, a yardstick whose d_vals is shifted)."""
    from gimmvfi_tpu_torch.tools import splat_ablate

    real = splat_ablate.library_calls

    def shifted(vals, flow, g=None):
        calls = real(vals, flow, g)
        calls["d_vals"] = (lambda f: (lambda: f() + 1e-2))(calls["d_vals"])
        return calls

    monkeypatch.setattr(splat_ablate, "library_calls", shifted)
    vals, flow, g = bwd_inputs((1, 6, 7, 2), "random", 1.0, seed=5, device="cpu")
    with pytest.raises(AssertionError, match="yardstick d_vals"):
        splat_ablate.library_agreement(vals, flow, g)


def test_d_flow_is_held_away_from_integer_positions():
    """A position on an integer x makes d_flow's x component jump between
    cells: `near_integer` marks that component (and only it), and the
    agreement leaves it out and still holds the rest."""
    shape = (1, 6, 9, 4)
    vals, flow, g = bwd_inputs(shape, "random", 1.0, seed=6, device="cpu")
    flow[0, 2, 3, 0] = 2.0  # x = 5 exactly
    flow[0, 4, 5, 1] = -1.0 + 2e-4  # y within 1e-3 of 3
    mask = near_integer(flow)
    assert bool(mask[0, 2, 3, 0]) and bool(mask[0, 4, 5, 1])
    assert int(mask.sum()) < 0.1 * mask.numel()  # random positions are rarely that close
    err, tol, layout = library_agreement(vals, flow, g)["d_flow"]
    assert err <= tol and "left out" in layout
