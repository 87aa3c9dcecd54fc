"""All-pairs correlation pyramids and window lookups (`gimmvfi_tpu/ops/corr.py`).

Materialized path only: the volume corr[n, p, q] = <fmap1[n, :, p],
fmap2[n, :, q]> / sqrt(C) is one batched matmul, stored in the feature
dtype (bf16 halves it), pooled 2x2 over the target dims per level. A lookup
samples a (2r+1)^2 window per level with `F.grid_sample` (zeros padding,
align_corners=True). The windowed path for volumes over the size limit is
not ported yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .interp import bilinear_sampler

MAX_VOLUME_BYTES = 2 << 30


def all_pairs_corr(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """corr (N, H1*W1, H2, W2) from NCHW feature maps, scaled by 1/sqrt(C)."""
    n, c, h1, w1 = fmap1.shape
    h2, w2 = fmap2.shape[-2:]
    a = fmap1.reshape(n, c, h1 * w1).transpose(1, 2)
    b = fmap2.reshape(n, c, h2 * w2)
    corr = torch.bmm(a, b)
    corr.div_(math.sqrt(c))
    return corr.view(n, h1 * w1, h2, w2)


def _pool_levels(corr: torch.Tensor, num_levels: int) -> tuple[torch.Tensor, ...]:
    """2x2/stride-2 average pools of (N, P, h, w) over (h, w); floors odd sizes."""
    levels = [corr]
    for _ in range(num_levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        levels.append(corr)
    return tuple(levels)


def corr_pyramid(fmap1, fmap2, num_levels: int = 4) -> tuple[torch.Tensor, ...]:
    """RAFT correlation pyramid: levels[i] is (N, P, h_i, w_i)."""
    return _pool_levels(all_pairs_corr(fmap1, fmap2), num_levels)


def bidir_corr_pyramid(fmap1, fmap2, num_levels: int = 4):
    """Forward and transposed pyramids from one all-pairs matmul: the
    transposed volume corr_T[n, q, h1, w1] = corr[n, p(h1, w1), q]."""
    n, _, h1, w1 = fmap1.shape
    h2, w2 = fmap2.shape[-2:]
    corr = all_pairs_corr(fmap1, fmap2)
    corr_t = corr.reshape(n, h1 * w1, h2 * w2).transpose(1, 2).reshape(n, h2 * w2, h1, w1)
    return _pool_levels(corr, num_levels), _pool_levels(corr_t, num_levels)


def _check_volume(fmap1, fmap2, copies: int, max_volume_bytes: int):
    n, _, h1, w1 = fmap1.shape
    h2, w2 = fmap2.shape[-2:]
    vol = copies * n * h1 * w1 * h2 * w2 * fmap1.element_size() * 4 // 3
    if vol > max_volume_bytes:
        raise NotImplementedError("windowed correlation not yet ported")


def corr_pyramid_auto(fmap1, fmap2, num_levels: int = 4,
                      max_volume_bytes: int = MAX_VOLUME_BYTES):
    """`corr_pyramid`, after the reference's size check."""
    _check_volume(fmap1, fmap2, 1, max_volume_bytes)
    return corr_pyramid(fmap1, fmap2, num_levels)


def bidir_corr_pyramid_auto(fmap1, fmap2, num_levels: int = 4,
                            max_volume_bytes: int = MAX_VOLUME_BYTES):
    """`bidir_corr_pyramid`, after the reference's size check (both volumes)."""
    _check_volume(fmap1, fmap2, 2, max_volume_bytes)
    return bidir_corr_pyramid(fmap1, fmap2, num_levels)


def corr_lookup(pyramid, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Sample (2r+1)^2 windows at `coords` (N, 2, H, W), pixel (x, y) in
    level-0 target space, from every level.

    Returns (N, levels*(2r+1)^2, H, W) in the volume's dtype. Channel
    k = i*(2r+1) + j of a level samples (x + d[i], y + d[j]): the x offset
    is the outer index, as converted weights expect.
    """
    n, _, h, w = coords.shape
    win = 2 * radius + 1
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=coords.device)
    centre = coords.float().permute(0, 2, 3, 1).reshape(n * h * w, 1, 1, 2)
    out = []
    for i, corr in enumerate(pyramid):
        c = centre / (2.0**i)
        gx = (c[..., 0] + d.view(1, win, 1)).expand(-1, win, win)
        gy = (c[..., 1] + d.view(1, 1, win)).expand(-1, win, win)
        grid = torch.stack([gx, gy], dim=-1)  # (N*H*W, x offset, y offset, 2)
        level = corr.reshape(n * h * w, 1, *corr.shape[-2:])
        vals = bilinear_sampler(level, grid)  # (N*H*W, 1, win, win)
        out.append(vals.view(n, h, w, win * win).permute(0, 3, 1, 2))
    return torch.cat(out, dim=1)


def bidir_corr_lookup(pyramids, coords0, coords1, radius: int = 4):
    """Look up the forward pyramid at coords0 and the transposed one at coords1."""
    fwd, bwd = pyramids
    return corr_lookup(fwd, coords0, radius), corr_lookup(bwd, coords1, radius)
