"""The port's gather probe (`gimmvfi_tpu_torch/tools/gather_cost_probe.py`)
against the JAX probe's Pallas kernels (`tools/gather_cost_probe.py`), on
the CPU.

The JAX probe defines its three `pl.pallas_call` kernels inside `main()`,
so the test rebuilds the same bodies with `interpret=True` (and checks that
the probe's source still holds those bodies). Inputs are the probe's
shapes and index recipes, drawn with numpy from a seed, plus a case with
negative and out-of-range indices. The plain versions, what a CPU tensor
runs, must equal the interpreted kernels exactly, NaN fills included. The
CUDA kernels themselves run only on the card (`cuda` marker).
"""

import importlib.util
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gimmvfi_tpu_torch.tools.gather_cost_probe import (
    GATHERS,
    TILE,
    gather_tables,
    lanegather,
    subgather,
    subgather_grid,
)

torch.set_num_threads(1)
PROBE_PATH = Path(__file__).resolve().parents[1] / "tools" / "gather_cost_probe.py"
PUBLIC = {"subgather": subgather, "subgather_grid": subgather_grid, "lanegather": lanegather}


def _subgather_kernel(x_ref, idx_ref, o_ref):
    o_ref[:] = jnp.take_along_axis(x_ref[:], idx_ref[:], axis=0)


def _lanegather_kernel(x_ref, idx_ref, o_ref):
    o_ref[:] = jnp.take_along_axis(x_ref[:], idx_ref[:], axis=1)


def _jax_subgather(x, idx):
    return pl.pallas_call(_subgather_kernel, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
                          interpret=True)(x, idx)


def _jax_subgather_grid(x, idx):
    spec = pl.BlockSpec((TILE, x.shape[1]), lambda i: (i, 0))
    return pl.pallas_call(
        _subgather_kernel,
        grid=(x.shape[0] // TILE,),
        in_specs=[spec, spec],
        out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=True,
    )(x, idx % TILE)


def _jax_lanegather(x, idx):
    return pl.pallas_call(_lanegather_kernel, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
                          interpret=True)(x, idx)


JAX_KERNELS = {"subgather": _jax_subgather, "subgather_grid": _jax_subgather_grid,
               "lanegather": _jax_lanegather}


def _out_of_range(name, idx, rng):
    """5% of the indices replaced by negative and out-of-range values."""
    n = idx.shape[1] if name == "lanegather" else idx.shape[0]
    bad = idx.copy()
    pick = rng.random(idx.shape) < 0.05
    bad[pick] = rng.choice([-1, -n, n, n + 7, -n - 1, 2**31 - 1, -2**31], int(pick.sum()))
    return bad


def test_probe_still_holds_these_bodies():
    spec = importlib.util.spec_from_file_location("gather_cost_probe", PROBE_PATH)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    src = inspect.getsource(probe.main)
    assert src.count("o_ref[:] = jnp.take_along_axis(x_ref[:], idx_ref[:], axis=0)") == 2
    assert src.count("o_ref[:] = jnp.take_along_axis(x_ref[:], idx_ref[:], axis=1)") == 1
    assert "(x, (idx % 512))" in src and "grid=(bigr // 512,)" in src


@pytest.mark.parametrize("indices", ["probe", "out_of_range"])
@pytest.mark.parametrize("name", list(GATHERS))
def test_plain_equals_interpreted_pallas(rng, name, indices):
    x, idx = gather_tables(seed=0)[name]
    if indices == "out_of_range":
        idx = _out_of_range(name, idx, rng)
    ref = np.asarray(JAX_KERNELS[name](jnp.asarray(x), jnp.asarray(idx)))
    _, plain, _ = GATHERS[name]
    got = plain(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got, ref)  # NaN equals NaN here
    n_nan = int(np.isnan(got).sum())
    assert n_nan == 0 if indices == "probe" or name == "subgather_grid" else n_nan > 0


@pytest.mark.parametrize("name", list(GATHERS))
def test_cpu_tensor_takes_plain_version(name):
    x, idx = (torch.from_numpy(a) for a in gather_tables(seed=1)[name])
    kernel, plain, _ = GATHERS[name]
    before = kernel.launches
    got = PUBLIC[name](x, idx)
    assert kernel.launches == before
    assert torch.equal(got, plain(x, idx))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel(x, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GATHERS))
def test_kernel_matches_plain_on_card(rng, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; run on the card")
    x, idx = gather_tables(seed=2)[name]
    x, idx = torch.from_numpy(x).cuda(), torch.from_numpy(_out_of_range(name, idx, rng)).cuda()
    kernel, plain, _ = GATHERS[name]
    before = kernel.launches
    got = PUBLIC[name](x, idx)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), plain(x, idx).cpu().numpy())
