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
what it does not take before it builds; the kernel itself and `SplatSum`
run only on the card (`cuda` marker).
"""

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
from gimmvfi_tpu_torch.tools.splat_ablate import CHECK_CASES, smooth_flow, splat_inputs

torch.set_num_threads(1)

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


@pytest.mark.cuda
@pytest.mark.parametrize("shape,field,std", CHECK_CASES)
def test_backward_kernel_matches_plain_on_card(shape, field, std):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; run on the card")
    vals, flow = splat_inputs(shape, field, std, seed=2)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(3)).cuda()
    before = SPLAT_BACKWARD_KERNEL.launches
    d_vals, d_flow = SPLAT_BACKWARD_KERNEL(vals, flow, g)
    torch.cuda.synchronize()
    assert SPLAT_BACKWARD_KERNEL.launches == before + 1
    ref_vals, ref_flow = splat_sum_backward_plain(vals, flow, g)
    for got, ref in ((d_vals, ref_vals), (d_flow, ref_flow)):
        err = float((got - ref).abs().max())
        assert err <= 1e-5 * max(1.0, float(ref.abs().max())), err


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
