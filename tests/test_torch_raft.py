"""Port RAFT against the JAX RAFT, bidirectional, 2 iterations, 128x128, CPU.

Weights come from the JAX `model.init` and go through
`jax_raft_params_to_torch`. Tolerance: max-abs <= 1e-4 * max(1, max|ref|)
(float32 convolutions summed in another order, through 2 GRU iterations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gimmvfi_tpu.flow.raft import RAFT as JaxRAFT
from gimmvfi_tpu.utils.convert import convert_raft
from gimmvfi_tpu_torch.flow.raft import RAFT
from gimmvfi_tpu_torch.utils.convert import jax_raft_params_to_torch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def raft_pair():
    rng = np.random.default_rng(0)
    img1 = (rng.random((1, 128, 128, 3)) * 255).astype(np.float32)
    img2 = (rng.random((1, 128, 128, 3)) * 255).astype(np.float32)
    model = JaxRAFT(iters=2)
    variables = jax.jit(lambda r, a, b: model.init(r, a, b, bidir=True))(
        jax.random.PRNGKey(0), jnp.asarray(img1), jnp.asarray(img2)
    )
    ref = jax.jit(lambda v, a, b: model.apply(v, a, b, bidir=True))(
        variables, jnp.asarray(img1), jnp.asarray(img2)
    )
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    return img1, img2, params, stats, jax.tree_util.tree_map(np.asarray, ref)


def _bound(ref):
    return 1e-4 * max(1.0, float(np.abs(ref).max()))


def test_raft_bidir_matches_jax(raft_pair):
    img1, img2, params, stats, (ref_flow, ref_feats, ref_fmaps) = raft_pair
    model = RAFT(iters=2)
    model.load_state_dict(jax_raft_params_to_torch(params, stats), strict=True)
    with torch.inference_mode():
        flow, feats, fmaps = model(
            torch.from_numpy(img1).permute(0, 3, 1, 2),
            torch.from_numpy(img2).permute(0, 3, 1, 2),
        )
    pairs = [(flow, ref_flow), (fmaps, ref_fmaps)] + list(zip(feats, ref_feats))
    for got, ref in pairs:
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= _bound(ref)


def test_raft_weight_round_trip_is_exact(raft_pair):
    _, _, params, stats, _ = raft_pair
    back_p, back_s = convert_raft(jax_raft_params_to_torch(params, stats))
    for a, b in ((back_p, params), (back_s, stats)):
        fa, ta = jax.tree_util.tree_flatten(a)
        fb, tb = jax.tree_util.tree_flatten(b)
        assert ta == tb
        for x, y in zip(fa, fb):
            assert x.dtype == y.dtype and np.array_equal(x, y)
