"""Coordinate grids and flow normalization (`gimmvfi_tpu/ops/coords.py`).

Grids are NCHW here; `sample_coords_3d` stays channels-last because its
output feeds the HypoNet MLP as per-point (t, y, x) rows.
"""

from __future__ import annotations

import torch


def coords_grid(batch: int, ht: int, wd: int, device, x0: int = 0) -> torch.Tensor:
    """(N, 2, H, W) float32 grid of (x, y) pixel coordinates; `x0` is the
    first column's x (a window of a wider frame)."""
    y, x = torch.meshgrid(
        torch.arange(ht, dtype=torch.float32, device=device),
        torch.arange(x0, x0 + wd, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return torch.stack([x, y], dim=0)[None].expand(batch, 2, ht, wd)


def normalize_flow(flows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample max-abs normalize flows to [0, 1].

    flows: (N, T, 2, H, W). Returns (normalized flows, scaler (N, 1, 1, 1, 1)).
    """
    n = flows.shape[0]
    scaler = flows.reshape(n, -1).abs().amax(dim=-1).view(n, 1, 1, 1, 1)
    return (flows / scaler + 1.0) / 2.0, scaler


def unnormalize_flow(flows: torch.Tensor, flow_scaler: torch.Tensor) -> torch.Tensor:
    """Inverse of `normalize_flow`."""
    return (flows * 2.0 - 1.0) * flow_scaler


def sample_coords_3d(
    batch_size: int,
    spatial_shape: tuple[int, int],
    t_values,
    device,
    coord_range: tuple[float, float] = (-1.0, 1.0),
    cols: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Normalized (t, y, x) coordinates for the motion INR, (B, T, H, W, 3).

    Spatial coordinates are pixel-centred, `lo + (hi - lo) * (0.5 + i) / n`;
    the t channel comes first and carries the raw timestep. `cols` (a, b)
    keeps the columns [a, b) of the (H, W) grid: (B, T, H, b - a, 3).
    """
    h, w = spatial_shape
    lo, hi = coord_range
    a, b = (0, w) if cols is None else cols
    ys = lo + (hi - lo) * (0.5 + torch.arange(h, dtype=torch.float32, device=device)) / h
    xs = lo + (hi - lo) * (0.5 + torch.arange(a, b, dtype=torch.float32, device=device)) / w
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    tv = torch.as_tensor(t_values, dtype=torch.float32, device=device).reshape(-1)
    tt = tv[:, None, None].expand(tv.shape[0], h, b - a)
    coords = torch.stack([tt, yy.expand_as(tt), xx.expand_as(tt)], dim=-1)
    return coords[None].expand(batch_size, *coords.shape)


def sample_coords_3d_per_sample(
    t_values: torch.Tensor,
    spatial_shape: tuple[int, int],
    coord_range: tuple[float, float] = (-1.0, 1.0),
) -> torch.Tensor:
    """Per-sample timesteps: t_values (B,) -> coords (B, 1, H, W, 3), the
    t channel of the t = 1 grid scaled by each sample's t."""
    b = t_values.shape[0]
    base = sample_coords_3d(b, spatial_shape, 1.0, t_values.device, coord_range)
    t = t_values.reshape(b, 1, 1, 1, 1).float()
    return torch.cat([base[..., :1] * t, base[..., 1:]], dim=-1)
