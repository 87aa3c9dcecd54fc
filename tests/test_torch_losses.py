"""The port's stage-2 losses against `gimmvfi_tpu/train/losses.py`, on the CPU.

Each loss and `psnr` on the same seeded channels-last inputs, at even and
odd sizes: values <= 1e-6 relative, input gradients <= 1e-5 x max|g| (JAX's
`jax.grad` against autograd). The census covers its zero border and
carries no gradient into the target; the Laplacian pyramid covers the
odd-size crop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gimmvfi_tpu.train import losses as jax_losses
from gimmvfi_tpu_torch.train import losses

torch.set_num_threads(1)
SHAPES = [(2, 64, 64, 3), (1, 45, 37, 3), (2, 33, 50, 3)]


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.random(shape, dtype=np.float32), rng.random(shape, dtype=np.float32)


def _both(name, pred, target, **kw):
    """(value, d/dpred, d/dtarget) from JAX and from the port."""
    jf = getattr(jax_losses, name)
    jv, (jgp, jgt) = jax.value_and_grad(lambda a, b: jf(a, b, **kw), argnums=(0, 1))(
        jnp.asarray(pred), jnp.asarray(target))
    p = torch.tensor(pred, requires_grad=True)
    t = torch.tensor(target, requires_grad=True)
    tv = getattr(losses, name)(p, t, **kw)
    tv.backward()
    return (float(jv), np.asarray(jgp), np.asarray(jgt)), (float(tv.detach()), p.grad.numpy(), t.grad)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", ["lap_loss", "census_loss", "charbonnier_l1"])
def test_loss_matches_jax(name, shape):
    pred, target = _pair(shape, sum(shape))
    (jv, jgp, jgt), (tv, tgp, tgt) = _both(name, pred, target)
    assert abs(tv - jv) <= 1e-6 * abs(jv), (tv, jv)
    assert np.abs(tgp - jgp).max() <= 1e-5 * np.abs(jgp).max()
    if name == "census_loss":
        # the target's transform is detached, in JAX by stop_gradient
        assert not np.abs(jgt).any() and (tgt is None or not tgt.abs().any())
    else:
        assert np.abs(tgt.numpy() - jgt).max() <= 1e-5 * np.abs(jgt).max()


def test_census_border_counts_zero():
    """Pixels within 3 of the edge count zero: the loss is the inner pixels'
    distance summed over the whole image's pixel count."""
    pred, target = _pair((2, 32, 40, 3), 9)
    got = float(losses.census_loss(torch.from_numpy(pred), torch.from_numpy(target)))
    d = losses._census_transform(torch.from_numpy(pred)) - losses._census_transform(
        torch.from_numpy(target))
    dist = (d**2 / (0.1 + d**2)).mean(dim=-1)
    inner = float(dist[:, 3:-3, 3:-3].sum()) / dist.numel()
    assert abs(inner - got) <= 1e-6 * got and float(dist[:, :3].sum()) > 0


@pytest.mark.parametrize("hw", [(64, 64), (45, 37), (66, 34)], ids=lambda s: "x".join(map(str, s)))
def test_laplacian_pyramid_levels_match_jax(hw):
    """Each level of the 5-level pyramid, odd sizes cropped as JAX crops
    them: same shapes, values <= 1e-6 x max|ref|."""
    img, _ = _pair((1, *hw, 3), hw[0])
    ref = jax_losses.laplacian_pyramid(jnp.asarray(img), 5)
    got = losses.laplacian_pyramid(torch.from_numpy(img).permute(0, 3, 1, 2), 5)
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        r = np.asarray(r).transpose(0, 3, 1, 2)
        assert g.shape == r.shape
        assert np.abs(g.numpy() - r).max() <= 1e-6 * max(1.0, np.abs(r).max())


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_psnr_matches_jax(shape):
    pred, target = _pair(shape, sum(shape) + 1)
    ref = float(jax_losses.psnr(jnp.asarray(pred), jnp.asarray(target)))
    got = float(losses.psnr(torch.from_numpy(pred), torch.from_numpy(target)))
    assert abs(got - ref) <= 1e-6 * abs(ref), (got, ref)
