"""NCHW layers with the reference's dtype policy (`gimmvfi_tpu/nn/layers.py`).

`compute_dtype=None` computes in float32; `torch.bfloat16` casts a conv's
input, weight and bias to bf16. Parameters always stay float32, and
normalization statistics are computed in float32 in both modes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose input, weight and bias are cast to `compute_dtype`.

    `padding_mode="reflect"` pads like the reference's `pad_mode="reflect"`.
    Weights are OIHW, so converted reference weights load directly.
    """

    def __init__(self, *args, compute_dtype: torch.dtype | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.float32
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class GemmConv2d(Conv2d):
    """A stride-1, ungrouped Conv2d computed as unfold + one matmul, with
    Conv2d's weights, keys and dtype policy. cuDNN 9.2 sends some float32
    3x3 convs (256 input channels at 92x160, as in FlowFormer's motion
    encoder at 720p) to an FFT path that takes 390-450 ms a call on an
    H100; as a GEMM the same conv takes 0.7-1 ms."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.stride != (1, 1) or self.groups != 1 or self.padding_mode != "zeros":
            raise ValueError("GemmConv2d takes stride 1, groups 1 and zero padding")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.float32
        n, _, h, w = x.shape
        (kh, kw), (ph, pw), (dh, dw) = self.kernel_size, self.padding, self.dilation
        cols = F.unfold(x.to(dt), self.kernel_size, self.dilation, self.padding)
        out = self.weight.to(dt).flatten(1) @ cols  # (N, Cout, H' * W')
        if self.bias is not None:
            out = out + self.bias.to(dt).view(1, -1, 1)
        return out.view(n, -1, h + 2 * ph - dh * (kh - 1), w + 2 * pw - dw * (kw - 1))


class PReLU(nn.Module):
    """Per-channel PReLU that keeps the input's dtype (state key `weight`)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = self.weight.to(x.dtype).view(1, -1, 1, 1)
        return torch.clamp_min(x, 0) + alpha * torch.clamp_max(x, 0)


class FrozenBatchNorm2d(nn.Module):
    """Eval-mode BatchNorm2d: running statistics, affine, float32 arithmetic.

    Computes `(x - mean) * (rsqrt(var + eps) * weight) + bias` in float32,
    as flax's BatchNorm does, and returns `compute_dtype` (float32 if None).
    """

    def __init__(self, channels: int, eps: float = 1e-5,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.eps = eps
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1)
        y = y + self.bias.view(1, -1, 1, 1)
        return y.to(self.compute_dtype or torch.float32)


class InstanceNorm(nn.Module):
    """Parameter-free InstanceNorm2d (biased variance, float32 statistics)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch InstanceNorm2d default; statistics in float32, result in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.1) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def pixel_shuffle(x: torch.Tensor, upscale: int) -> torch.Tensor:
    """nn.PixelShuffle on NCHW: out[b, c, h*r+i, w*r+j] = in[b, c*r*r+i*r+j, h, w]."""
    return F.pixel_shuffle(x, upscale)


def sine(x: torch.Tensor, w0: float = 1.0) -> torch.Tensor:
    """SIREN activation."""
    return torch.sin(w0 * x)


def conv(cin: int, cout: int, k=3, stride=1, padding=0, dtype=None, **kw) -> Conv2d:
    """Shorthand for a biased `Conv2d` with the given compute dtype."""
    return Conv2d(cin, cout, k, stride, padding, compute_dtype=dtype, **kw)


def conv_prelu(cin: int, cout: int, k=3, stride=1, padding=1, dtype=None) -> nn.Sequential:
    """The reference's `convrelu`: Sequential(Conv2d, PReLU) (keys `.0`, `.1`)."""
    return nn.Sequential(conv(cin, cout, k, stride, padding, dtype), PReLU(cout))


@torch.no_grad()
def init_normal_(module: nn.Module, seed: int, std: float = 0.02) -> nn.Module:
    """Fill every parameter with N(0, std) drawn from a seeded CPU generator.

    The draws happen on the CPU, so the same seed gives the same weights on
    any device. BatchNorm running statistics are set to mean 0 / var 1: a
    random running variance could be negative and make rsqrt(var + eps) NaN.
    """
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for p in module.parameters():
        p.copy_(torch.randn(p.shape, generator=gen) * std)
    for m in module.modules():
        if isinstance(m, FrozenBatchNorm2d):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return module
