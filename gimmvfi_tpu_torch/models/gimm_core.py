"""Shared GIMM machinery (`gimmvfi_tpu/models/gimm_core.py`), NCHW: motion
encoder, latent refiner, splatting weights and the latent splat. With
`remat` the refiner is a remat unit (`nn/layers.py: remat_call`); the
splat before it is not."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import conv, remat_call
from ..ops.interp import warp
from ..ops.softsplat import softsplat
from .synthesis import LateralBlock

_GAUSS3 = np.array(
    [
        [1.0 / 16.0, 1.0 / 8.0, 1.0 / 16.0],
        [1.0 / 8.0, 1.0 / 4.0, 1.0 / 8.0],
        [1.0 / 16.0, 1.0 / 8.0, 1.0 / 16.0],
    ],
    dtype=np.float32,
)


def gaussian_blur3x3(x: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 gaussian with reflect padding (the reference's fixed
    `g_filter`), as a grouped conv."""
    c = x.shape[1]
    k = torch.from_numpy(_GAUSS3).to(x.device, x.dtype).expand(c, 1, 3, 3)
    return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), k, groups=c)


def motion_encoder(dtype=None) -> nn.Sequential:
    """`cnn_encoder`: 2-channel flow -> 16-channel latent."""
    return nn.Sequential(
        conv(2, 16, 3, 1, 1, dtype),
        conv(16, 32, 3, 1, 1, dtype),
        nn.LeakyReLU(0.1),
        LateralBlock(32, dtype),
        LateralBlock(32, dtype),
        LateralBlock(32, dtype),
        nn.LeakyReLU(0.1),
        conv(32, 16, 3, 1, 1, dtype, padding_mode="reflect"),
    )


def latent_refiner(dtype=None) -> nn.Sequential:
    """`res_conv`: fuse the splatted latents with a residual."""
    return nn.Sequential(
        conv(64, 32, 3, 1, 1, dtype),
        conv(32, 64, 3, 1, 1, dtype),
        nn.LeakyReLU(0.1),
        LateralBlock(64, dtype),
        nn.LeakyReLU(0.1),
        conv(64, 32, 3, 1, 1, dtype, padding_mode="reflect"),
    )


def splatting_weights(flow01, flow10, alpha_v, alpha_fe):
    """Splat importance from local flow variance and forward/backward warp
    consistency. flow01/flow10 (N, 2, H, W); returns two (N, 1, H, W)."""
    flows = torch.cat([flow01, flow10], dim=0)
    blurred = gaussian_blur3x3(torch.cat([flows**2, flows], dim=1))
    sq_mean, mean = blurred[:, :2], blurred[:, 2:]
    var = torch.sqrt(torch.clamp_min(sq_mean - mean**2, 1e-9)).mean(1, keepdim=True)
    n = flow01.shape[0]
    var01, var10 = var[:n], var[n:]

    err01 = (-warp(flow10, flow01) - flow01).abs().mean(1, keepdim=True)
    err10 = (-warp(flow01, flow10) - flow10).abs().mean(1, keepdim=True)
    a_v = alpha_v.view(1, 1, 1, 1)
    a_fe = alpha_fe.view(1, 1, 1, 1)
    w1 = 1.0 / (1.0 + err01 * a_fe) + 1.0 / (1.0 + var01 * a_v)
    w2 = 1.0 / (1.0 + err10 * a_fe) + 1.0 / (1.0 + var10 * a_v)
    return w1, w2


def _splat_nchw(x, flow, metric, mode):
    """softsplat on NCHW tensors (the op itself is channels-last)."""
    out = softsplat(
        x.permute(0, 2, 3, 1), flow.permute(0, 2, 3, 1), metric.permute(0, 2, 3, 1), mode
    )
    return out.permute(0, 3, 1, 2)


FWARP_TYPES = ("linear", "softmax")  # the splat modes that take a metric


def check_fwarp_type(fwarp_type: str) -> str:
    """`fwarp_type` if the latent splat can run it, else a ValueError:
    the splat passes the splat weights as its metric, and "sum" and "avg"
    take none (JAX's `softsplat` asserts the same)."""
    if fwarp_type not in FWARP_TYPES:
        raise ValueError(f"fwarp_type {fwarp_type!r}: the latent splat takes one of "
                         f"{FWARP_TYPES} (its metric is the splat weights)")
    return fwarp_type


def splat_latents(latent0, latent1, flow01, flow10, w1, w2, t, fwarp_type="linear"):
    """Forward-splat both latents to time t (two `fwarp_type`-zeroeps splat
    calls, one per direction). t (N,). Returns the splatted pair, (N, 32,
    H, W)."""
    t = t.view(-1, 1, 1, 1)
    mode = check_fwarp_type(fwarp_type) + "-zeroeps"
    s0 = _splat_nchw(latent0, flow01 * t, w1, mode)
    s1 = _splat_nchw(latent1, flow10 * (1.0 - t), w2, mode)
    return torch.cat([s0, s1], dim=1)


def refine_latents(refiner, latent0, latent1, fused, lo=0, hi=None, remat=False):
    """The fused latent, `fused` plus the refiner's residual, on the columns
    [lo, hi) of the (N, C, H, W) inputs (all of them by default); the
    refiner is a remat unit under `remat`. The refiner reads zeros (its
    reflect conv, reflections) past the window's edges, so a narrower
    window is exact only as far from its inner edges as the refiner's
    receptive radius (`parallel/spatial.py`)."""
    cols = slice(lo, hi)
    x = torch.cat([latent0[..., cols], latent1[..., cols], fused[..., cols]], dim=1)
    return fused[..., cols] + remat_call(refiner, x, remat=remat)


def splat_fuse_latents(refiner, latent0, latent1, flow01, flow10, w1, w2, t,
                       fwarp_type="linear", remat=False):
    """Forward-splat both latents to time t (`splat_latents`) and fuse them
    (`refine_latents`, its `remat`). t (N,). Returns the (N, 32, H, W) latent."""
    fused = splat_latents(latent0, latent1, flow01, flow10, w1, w2, t, fwarp_type)
    return refine_latents(refiner, latent0, latent1, fused, remat=remat)
