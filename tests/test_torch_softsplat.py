"""The port's splat against the JAX reference, on the CPU.

The plain sum core (what a CPU tensor runs) is held against both the
reference's XLA scatter core and its Pallas sorted-window kernel in
interpret mode, at the shapes of tests/test_splat_pallas.py plus a
non-finite case; `softsplat` against the reference for every mode and eps
policy. Tolerance: rtol = atol = 1e-5 (float32 sums in another order).
The CUDA kernel itself runs only on the card (`cuda` marker).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gimmvfi_tpu.ops.softsplat import _splat_core_xla
from gimmvfi_tpu.ops.softsplat import softsplat as jax_softsplat
from gimmvfi_tpu.ops.splat_pallas import splat_corners_sorted
from gimmvfi_tpu_torch.ops.softsplat import SPLAT_KERNEL, softsplat, splat_sum, splat_sum_plain

torch.set_num_threads(1)

SHAPES = [((1, 16, 24, 5), 3.0), ((2, 24, 16, 3), 30.0), ((1, 8, 8, 1), 0.6)]


def _inputs(rng, shape, flow_scale, non_finite=False):
    n, h, w, _ = shape
    vals = rng.standard_normal(shape).astype(np.float32)
    flow = (rng.standard_normal((n, h, w, 2)) * flow_scale).astype(np.float32)
    if non_finite:
        flow[0, 3, 4, 0] = np.nan
        flow[0, 5, 6, 1] = np.inf
        flow[0, 7, 1, 0] = -np.inf
        flow[0, 2, 2, :] = 1e30
    return vals, flow


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
@pytest.mark.parametrize(
    "shape,flow_scale,non_finite",
    [(s, f, False) for s, f in SHAPES] + [((1, 16, 16, 2), 1.0, True)],
)
def test_plain_core_matches_reference(rng, reference, shape, flow_scale, non_finite):
    vals, flow = _inputs(rng, shape, flow_scale, non_finite)
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


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; run on the card")
    vals, flow = _inputs(rng, (1, 736, 1280, 17), 20.0)
    vals, flow = torch.from_numpy(vals).cuda(), torch.from_numpy(flow).cuda()
    before = SPLAT_KERNEL.launches
    got = splat_sum(vals, flow)
    torch.cuda.synchronize()
    assert SPLAT_KERNEL.launches == before + 1
    ref = splat_sum_plain(vals, flow)
    assert float((got - ref).abs().max()) <= 1e-5 * max(1.0, float(ref.abs().max()))
