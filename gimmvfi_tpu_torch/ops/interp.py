"""Bilinear warping, sampling and resizing (`gimmvfi_tpu/ops/interp.py`), NCHW.

Conventions, as in the reference:

  * backward warp          : grid_sample, bilinear, border padding, align_corners=True
  * correlation lookup     : grid_sample, bilinear, zeros padding, align_corners=True
  * resize (decoders)      : interpolate, bilinear, align_corners=False, scale_factor=
  * hyponet latent resample: interpolate, bilinear, align_corners=False, size=

Sampling positions and bilinear weights are float32 in both compute modes:
a bf16 payload is sampled in float32 and returned in bf16 (grid_sample
needs the grid in the payload's dtype, and a bf16 grid would round
pixel positions).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pixel_grid(x: torch.Tensor, y: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Pixel positions -> grid_sample's align_corners=True coordinates."""
    return torch.stack([2.0 * x / (w - 1) - 1.0, 2.0 * y / (h - 1) - 1.0], dim=-1)


def _sample(img: torch.Tensor, grid: torch.Tensor, padding_mode: str) -> torch.Tensor:
    out = F.grid_sample(
        img.float(), grid, mode="bilinear", padding_mode=padding_mode,
        align_corners=True,
    )
    return out.to(img.dtype)


def warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp `img` (N, C, H, W) by `flow` (N, 2, H, W).

    Output pixel (i, j) samples (j + u, i + v); taps clamp to the border.
    """
    n, _, h, w = img.shape
    jj = torch.arange(w, dtype=torch.float32, device=img.device).view(1, 1, w)
    ii = torch.arange(h, dtype=torch.float32, device=img.device).view(1, h, 1)
    flow = flow.float()
    grid = _pixel_grid(jj + flow[:, 0], ii + flow[:, 1], h, w)
    return _sample(img, grid, "border")


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """RAFT's sampler: img (N, C, H, W) at pixel coords (N, Hg, Wg, 2) = (x, y),
    zeros padding. Returns (N, C, Hg, Wg)."""
    h, w = img.shape[-2:]
    coords = coords.float()
    return _sample(img, _pixel_grid(coords[..., 0], coords[..., 1], h, w), "zeros")


def resize_bilinear(
    img: torch.Tensor, out_hw: tuple[int, int], align_corners: bool = False
) -> torch.Tensor:
    """F.interpolate(size=out_hw, mode="bilinear") computed in float32."""
    if tuple(out_hw) == tuple(img.shape[-2:]):
        return img
    out = F.interpolate(
        img.float(), size=tuple(out_hw), mode="bilinear", align_corners=align_corners
    )
    return out.to(img.dtype)


def resize(img: torch.Tensor, scale_factor: float) -> torch.Tensor:
    """Scale-factor bilinear resize (align_corners=False), computed in float32.

    Passes `scale_factor=` and not `size=`: torch then maps output pixel o
    to `(o + 0.5) / scale_factor - 0.5`, which the reference matches with
    `scale=1/scale_factor`; `size=` would use in/out instead.
    """
    if scale_factor == 1:
        return img
    out = F.interpolate(
        img.float(), scale_factor=scale_factor, mode="bilinear", align_corners=False
    )
    return out.to(img.dtype)
