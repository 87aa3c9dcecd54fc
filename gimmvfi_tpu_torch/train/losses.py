"""Stage-2 training losses (`gimmvfi_tpu/train/losses.py`, the reference's
`src/utils/loss.py`): Laplacian pyramid L1, ternary census, Charbonnier
and PSNR.

Images are channels-last (N, H, W, C), as the batches and `train_forward`'s
outputs are; the filters run on NCHW views. Plain PyTorch, float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_GAUSS5 = np.outer([1.0, 4.0, 6.0, 4.0, 1.0], [1.0, 4.0, 6.0, 4.0, 1.0]).astype(np.float32) / 256.0


def _conv_gauss(img: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Depthwise 5x5 gaussian with reflect padding, NCHW."""
    c = img.shape[1]
    k = torch.from_numpy(_GAUSS5 * scale).to(img.device, img.dtype).expand(c, 1, 5, 5)
    return F.conv2d(F.pad(img, (2, 2, 2, 2), mode="reflect"), k, groups=c)


def _lap_upsample(x: torch.Tensor) -> torch.Tensor:
    """Zero-interleave 2x upsample, then the gaussian times 4, NCHW."""
    n, c, h, w = x.shape
    up = x.new_zeros((n, c, 2 * h, 2 * w))
    up[:, :, ::2, ::2] = x
    return _conv_gauss(up, scale=4.0)


def laplacian_pyramid(img: torch.Tensor, max_levels: int) -> list[torch.Tensor]:
    """The pyramid's band-pass levels of an NCHW image. An odd level size
    makes the 2x upsample one row or column too large: it is cropped."""
    pyr, current = [], img
    for _ in range(max_levels):
        down = _conv_gauss(current)[:, :, ::2, ::2]
        up = _lap_upsample(down)[:, :, : current.shape[2], : current.shape[3]]
        pyr.append(current - up)
        current = down
    return pyr


def lap_loss(pred: torch.Tensor, target: torch.Tensor, max_levels: int = 5) -> torch.Tensor:
    """5-level Laplacian pyramid L1, the levels' means summed."""
    pa = laplacian_pyramid(pred.permute(0, 3, 1, 2), max_levels)
    pb = laplacian_pyramid(target.permute(0, 3, 1, 2), max_levels)
    return sum((a - b).abs().mean() for a, b in zip(pa, pb))


def _census_transform(x: torch.Tensor, patch_size: int = 7) -> torch.Tensor:
    """The soft sign of each pixel's differences to its patch_size^2
    neighbours in the grayscale image (zero padding): (N, H, W, P^2)."""
    gray = x.mean(dim=-1)
    p = patch_size // 2
    h, w = gray.shape[1:]
    gp = F.pad(gray, (p, p, p, p))
    patches = torch.stack([gp[:, dy:dy + h, dx:dx + w]
                           for dy in range(patch_size) for dx in range(patch_size)], dim=-1)
    loc_diff = patches - gray[..., None]
    return loc_diff / torch.sqrt(0.81 + loc_diff**2)


def census_loss(pred: torch.Tensor, target: torch.Tensor, patch_size: int = 7) -> torch.Tensor:
    """Ternary census loss; the target's transform carries no gradient and
    the border of patch_size // 2 pixels counts 0."""
    dx = _census_transform(pred, patch_size)
    dy = _census_transform(target, patch_size).detach()
    diff = dx - dy
    dist = (diff**2 / (0.1 + diff**2)).mean(dim=-1)
    p = patch_size // 2
    h, w = pred.shape[1:3]
    mask = pred.new_zeros((1, h, w))
    mask[:, p:h - p, p:w - p] = 1.0
    return (dist * mask).mean()


def charbonnier_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Charbonnier L1, sqrt(diff^2 + 1e-6), averaged."""
    return torch.sqrt((pred - target) ** 2 + 1e-6).mean()


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The mean over the batch of each sample's PSNR, images in [0, 1]."""
    n = pred.shape[0]
    return (-10.0 * torch.log10(((pred - target) ** 2).reshape(n, -1).mean(dim=-1))).mean()
