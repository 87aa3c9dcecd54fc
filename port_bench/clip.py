"""A seeded clip of frames: a smooth random texture seen through a window
that moves a little from frame to frame, as consecutive video frames do.
Made on the device in a few calls, returned as float32 (H, W, 3) numpy
frames in [0, 1], as the video CLI reads them."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .weights import generator


@torch.no_grad()
def make_clip(seed: int, frames: int, height: int, width: int, max_shift: float,
              octaves: int, device) -> list[np.ndarray]:
    """`frames` frames of height x width. The texture is a sum of `octaves`
    bicubically upsampled noise grids (cells of 64, 32, ... pixels), its
    canvas `max_shift` pixels larger on each side; frame j is the canvas
    sampled at a cumulative random shift of at most `max_shift` a step in x
    and y, bilinearly, so flows are subpixel and differ from pair to pair."""
    gen = generator(seed, device)
    m = int(np.ceil(max_shift * frames)) + 2
    ch, cw = height + 2 * m, width + 2 * m
    canvas = torch.zeros(1, 3, ch, cw, device=device)
    for o in range(octaves):
        cell = 64 >> o
        grid = torch.rand(1, 3, ch // cell + 4, cw // cell + 4, generator=gen, device=device)
        up = F.interpolate(grid, scale_factor=cell, mode="bicubic", align_corners=False)
        canvas += up[..., :ch, :cw] * 0.5**o
    canvas = (canvas - canvas.amin()) / (canvas.amax() - canvas.amin())
    steps = (torch.rand(frames, 2, generator=gen, device=device) * 2 - 1) * max_shift
    shifts = torch.cumsum(steps, dim=0) - steps[:1]
    ys = torch.arange(height, device=device, dtype=torch.float32)
    xs = torch.arange(width, device=device, dtype=torch.float32)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    out = []
    for j in range(frames):
        gx = 2.0 * (xx + m + shifts[j, 0]) / (cw - 1) - 1.0
        gy = 2.0 * (yy + m + shifts[j, 1]) / (ch - 1) - 1.0
        grid = torch.stack([gx, gy], dim=-1)[None]
        frame = F.grid_sample(canvas, grid, mode="bilinear", align_corners=True)
        out.append(frame[0].permute(1, 2, 0).clamp(0, 1).contiguous())
    return [f.cpu().numpy() for f in out]
