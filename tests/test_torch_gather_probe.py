"""The port's gather probe (`gimmvfi_tpu_torch/tools/gather_cost_probe.py`)
against the JAX probe's Pallas kernels (`tools/gather_cost_probe.py`), on
the CPU.

The JAX probe defines its three `pl.pallas_call` kernels inside `main()`,
so the test rebuilds the same bodies with `interpret=True` (and checks that
the probe's source still holds those bodies). Inputs are the probe's
shapes and index recipes, drawn with numpy from a seed, plus a case with
negative and out-of-range indices. The plain versions, what a CPU tensor
runs, must equal the interpreted kernels exactly, NaN fills included. The
subgather ablation's variants (`tools/gather_ablate.py`) must each apply to
the kernel source. The CUDA kernels themselves run only on the card
(`cuda` marker).
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

from gimmvfi_tpu_torch.tools import gather_ablate
from gimmvfi_tpu_torch.tools.gather_cost_probe import (
    GATHERS,
    TILE,
    gather_tables,
    lanegather,
    subgather,
    subgather_grid,
    subgather_plain,
)
from gimmvfi_tpu_torch.utils.kernel_build import CSRC

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


@pytest.mark.parametrize("name", sorted(gather_ablate.VARIANTS))
def test_subgather_variants_apply_to_the_kernel_source(name):
    """Each variant replaces the subgather kernel (and its launcher) once
    and leaves the other two gathers as they are."""
    src = (CSRC / "gather_probe.cu").read_text()
    out = gather_ablate.variant_source(name, src)
    assert (out == src) == (name == "kernel")
    for other in ("subgather_grid_kernel", "lanegather_kernel", 'extern "C" int lanegather_f32'):
        assert out.count(other) == src.count(other)
    assert out.count('extern "C" int subgather_f32(') == 1


def test_subgather_check_tables_hold_bad_and_ragged_indices():
    tables = gather_ablate.check_tables()
    x, bad = tables[1]
    assert ((bad < -x.shape[0]) | (bad >= x.shape[0])).any() and (bad < 0).any()
    assert {t[0].shape for t in tables[2:]} == set(gather_ablate.RAGGED)
    for xt, it in tables:
        got = subgather_plain(torch.from_numpy(xt), torch.from_numpy(it))
        assert got.shape == xt.shape


def test_gather_ablation_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        gather_ablate.main([])


@pytest.mark.cuda
@pytest.mark.parametrize("table", range(5))
def test_subgather_on_card_with_bad_and_ragged_indices(table):
    """The subgather kernel on the probe's table with negative and
    out-of-range indices and on ragged tables: equal to the plain version,
    NaN at the same places."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; run on the card")
    xn, idxn = gather_ablate.check_tables()[table]
    x, idx = torch.from_numpy(xn).cuda(), torch.from_numpy(idxn).cuda()
    got = subgather(x, idx)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), subgather_plain(x, idx).cpu().numpy())
