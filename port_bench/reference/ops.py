"""Plain float32 operations of the reference: layers with a dtype policy,
bilinear warps and resizes, coordinate grids, edge padding, the forward
splat and the correlation pyramids and lookups.

A frozen copy of the mathematics of GIMM-VFI as the PyTorch port computes
it, in plain `torch` operations, with no hand kernel and no import of the
port. Layouts are NCHW unless a function says otherwise.

Precision: `Conv2d(compute_dtype=None)` computes in float32, `bfloat16`
casts its input, weight and bias to bf16. `Conv2d.fp8` (set by
`quantize_convs_fp8`) rounds input and weight to float8 e4m3 with a
per-tensor scale before a bf16 conv: the lower precision that the
benchmark's control takes.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0  # the largest finite float8 e4m3 value


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude maps to 448), returned in bf16."""
    scale = x.detach().abs().amax().float().clamp_min(1e-12) / FP8_MAX
    q = (x.float() / scale).to(torch.float8_e4m3fn)
    return (q.float() * scale).to(torch.bfloat16)


class Conv2d(nn.Conv2d):
    """nn.Conv2d computed in `compute_dtype` (float32 if None); with `fp8`
    the input and weight are rounded to float8 first (`fp8_round`)."""

    def __init__(self, *args, compute_dtype: torch.dtype | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype
        self.fp8 = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            bias = None if self.bias is None else self.bias.to(torch.bfloat16)
            return self._conv_forward(fp8_round(x), fp8_round(self.weight), bias)
        dt = self.compute_dtype or torch.float32
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


def quantize_convs_fp8(model: nn.Module) -> nn.Module:
    """Turn on `fp8` in every reduced-precision `Conv2d` of `model` (those
    with a compute dtype): the control's step below bf16."""
    for m in model.modules():
        if isinstance(m, Conv2d) and m.compute_dtype is not None:
            m.fp8 = True
    return model


class GemmConv2d(Conv2d):
    """A stride-1 ungrouped Conv2d as unfold + one matmul (cuDNN sends some
    float32 3x3 convs to a slow FFT path; the arithmetic is the same)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fp8 or self.compute_dtype is not None:
            return super().forward(x)
        n, _, h, w = x.shape
        (kh, kw), (ph, pw), (dh, dw) = self.kernel_size, self.padding, self.dilation
        cols = F.unfold(x.float(), self.kernel_size, self.dilation, self.padding)
        out = self.weight.float().flatten(1) @ cols
        if self.bias is not None:
            out = out + self.bias.float().view(1, -1, 1)
        return out.view(n, -1, h + 2 * ph - dh * (kh - 1), w + 2 * pw - dw * (kw - 1))


class PReLU(nn.Module):
    """Per-channel PReLU in the input's dtype."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x):
        alpha = self.weight.to(x.dtype).view(1, -1, 1, 1)
        return torch.clamp_min(x, 0) + alpha * torch.clamp_max(x, 0)


class BatchNorm2d(nn.Module):
    """Inference BatchNorm: running statistics, float32 arithmetic, the
    result in `compute_dtype`."""

    def __init__(self, channels: int, eps: float = 1e-5, compute_dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.eps = eps
        self.compute_dtype = compute_dtype

    def forward(self, x):
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1)
        return (y + self.bias.view(1, -1, 1, 1)).to(self.compute_dtype or torch.float32)


class InstanceNorm(nn.Module):
    """Parameter-free InstanceNorm2d, float32 statistics, input's dtype."""

    def forward(self, x, eps: float = 1e-5):
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = ((xf - mean) ** 2).mean(dim=(2, 3), keepdim=True)
        return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def conv(cin, cout, k=3, stride=1, padding=0, dtype=None, **kw) -> Conv2d:
    return Conv2d(cin, cout, k, stride, padding, compute_dtype=dtype, **kw)


def conv_prelu(cin, cout, k=3, stride=1, padding=1, dtype=None) -> nn.Sequential:
    return nn.Sequential(conv(cin, cout, k, stride, padding, dtype), PReLU(cout))


def leaky_relu(x, slope: float = 0.1):
    return F.leaky_relu(x, slope)


# ------------------------------------------------------------ interpolation
def _pixel_grid(x, y, h, w):
    return torch.stack([2.0 * x / (w - 1) - 1.0, 2.0 * y / (h - 1) - 1.0], dim=-1)


def _sample(img, grid, padding_mode):
    out = F.grid_sample(img.float(), grid, mode="bilinear", padding_mode=padding_mode,
                        align_corners=True)
    return out.to(img.dtype)


def warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward warp: output (i, j) samples img at (j + u, i + v), border
    padding, positions in float32."""
    _, _, h, w = img.shape
    jj = torch.arange(w, dtype=torch.float32, device=img.device).view(1, 1, w)
    ii = torch.arange(h, dtype=torch.float32, device=img.device).view(1, h, 1)
    flow = flow.float()
    return _sample(img, _pixel_grid(jj + flow[:, 0], ii + flow[:, 1], h, w), "border")


def bilinear_sampler(img, coords):
    """img (N, C, H, W) at pixel coords (N, Hg, Wg, 2) = (x, y), zeros padding."""
    h, w = img.shape[-2:]
    coords = coords.float()
    return _sample(img, _pixel_grid(coords[..., 0], coords[..., 1], h, w), "zeros")


def resize_bilinear(img, out_hw):
    if tuple(out_hw) == tuple(img.shape[-2:]):
        return img
    return F.interpolate(img.float(), size=tuple(out_hw), mode="bilinear",
                         align_corners=False).to(img.dtype)


def resize(img, scale_factor: float):
    """Scale-factor bilinear resize (align_corners False), in float32."""
    if scale_factor == 1:
        return img
    return F.interpolate(img.float(), scale_factor=scale_factor, mode="bilinear",
                         align_corners=False).to(img.dtype)


# ---------------------------------------------------------------- coords
def coords_grid(batch, ht, wd, device):
    y, x = torch.meshgrid(torch.arange(ht, dtype=torch.float32, device=device),
                          torch.arange(wd, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([x, y], dim=0)[None].expand(batch, 2, ht, wd)


def normalize_flow(flows):
    """flows (N, T, 2, H, W) to [0, 1] by the per-sample largest magnitude."""
    n = flows.shape[0]
    scaler = flows.reshape(n, -1).abs().amax(dim=-1).view(n, 1, 1, 1, 1)
    return (flows / scaler + 1.0) / 2.0, scaler


def unnormalize_flow(flows, scaler):
    return (flows * 2.0 - 1.0) * scaler


def sample_coords_3d(batch, hw, tv, device, coord_range=(-1.0, 1.0)):
    """(B, 1, H, W, 3) (t, y, x) coordinates, pixel centred."""
    h, w = hw
    lo, hi = coord_range
    ys = lo + (hi - lo) * (0.5 + torch.arange(h, dtype=torch.float32, device=device)) / h
    xs = lo + (hi - lo) * (0.5 + torch.arange(w, dtype=torch.float32, device=device)) / w
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    tt = torch.full((1, h, w), float(tv), dtype=torch.float32, device=device)
    coords = torch.stack([tt, yy.expand_as(tt), xx.expand_as(tt)], dim=-1)
    return coords[None].expand(batch, *coords.shape)


# ----------------------------------------------------------------- padding
class InputPadder:
    """Edge-pad the last two dims to a multiple of `divisor`, split between
    both sides ("sintel" mode)."""

    def __init__(self, dims, divisor: int = 32):
        self.ht, self.wd = (int(d) for d in tuple(dims)[-2:])
        pad_ht = (divisor - self.ht % divisor) % divisor
        pad_wd = (divisor - self.wd % divisor) % divisor
        self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, pad_ht // 2, pad_ht - pad_ht // 2]

    def pad(self, x):
        flat = x.reshape(-1, *x.shape[-3:])
        out = F.pad(flat, self._pad, mode="replicate")
        return out.reshape(*x.shape[:-2], *out.shape[-2:])

    def unpad(self, x):
        l, r, t, b = self._pad
        ht, wd = x.shape[-2:]
        return x[..., t:ht - b, l:wd - r]


# ------------------------------------------------------------------ splat
def splat_sum(vals: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear forward splat of vals (N, H, W, C) by flow (N, H, W, 2):
    four masked `index_add_` calls in float32. Positions clamp to [-2,
    size] before the integer conversion; non-finite ones fall off the frame."""
    n, h, w, c = vals.shape
    p = n * h * w
    jj = torch.arange(w, dtype=torch.float32, device=flow.device).view(1, 1, w)
    ii = torch.arange(h, dtype=torch.float32, device=flow.device).view(1, h, 1)
    x = jj + flow[..., 0].float()
    y = ii + flow[..., 1].float()
    finite = torch.isfinite(x) & torch.isfinite(y)
    x = torch.where(finite, x, -10.0)
    y = torch.where(finite, y, -10.0)
    x0f, y0f = torch.floor(x), torch.floor(y)
    ix0, iy0 = x0f.clamp(-2, w).to(torch.int64), y0f.clamp(-2, h).to(torch.int64)
    wx1, wy1 = x - x0f, y - y0f
    flat = vals.reshape(p, c).float()
    img = torch.arange(n, device=vals.device).view(n, 1, 1) * (h * w)
    out = torch.zeros(p + 1, c, dtype=torch.float32, device=vals.device)
    for dx, dy, wgt in ((0, 0, (1.0 - wx1) * (1.0 - wy1)), (1, 0, wx1 * (1.0 - wy1)),
                        (0, 1, (1.0 - wx1) * wy1), (1, 1, wx1 * wy1)):
        ix, iy = ix0 + dx, iy0 + dy
        ok = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        idx = torch.where(ok, img + iy * w + ix, p).reshape(p)
        out.index_add_(0, idx, flat * wgt.reshape(p, 1))
    return out[:p].reshape(n, h, w, c)


def softsplat_linear_zeroeps(ten_in, flow, metric):
    """The latent splat's mode, "linear-zeroeps", channels last: splat
    [x * m, m] and divide by the splatted m, a zero weight dividing by 1."""
    x = torch.cat([ten_in * metric, metric], dim=-1)
    out = splat_sum(x.float().contiguous(), flow.float().contiguous()).to(x.dtype)
    norm = out[..., -1:]
    return out[..., :-1] / torch.where(norm == 0.0, 1.0, norm)


_GAUSS3 = np.array([[1 / 16, 1 / 8, 1 / 16], [1 / 8, 1 / 4, 1 / 8], [1 / 16, 1 / 8, 1 / 16]],
                   dtype=np.float32)


def gaussian_blur3x3(x):
    c = x.shape[1]
    k = torch.from_numpy(_GAUSS3).to(x.device, x.dtype).expand(c, 1, 3, 3)
    return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), k, groups=c)


# ------------------------------------------------------------- correlation
def all_pairs_corr(fmap1, fmap2):
    """(N, H1*W1, H2, W2) = <fmap1[p], fmap2[q]> / sqrt(C)."""
    n, c, h1, w1 = fmap1.shape
    h2, w2 = fmap2.shape[-2:]
    corr = torch.bmm(fmap1.reshape(n, c, h1 * w1).transpose(1, 2), fmap2.reshape(n, c, h2 * w2))
    return (corr / math.sqrt(c)).view(n, h1 * w1, h2, w2)


def pool_levels(corr, num_levels):
    levels = [corr]
    for _ in range(num_levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        levels.append(corr)
    return tuple(levels)


def corr_lookup(pyramid, coords, radius: int = 4):
    """(2r+1)^2 windows at coords (N, 2, H, W) from every level, x offset
    outer: (N, levels*(2r+1)^2, H, W) in the volume's dtype."""
    n, _, h, w = coords.shape
    win = 2 * radius + 1
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=coords.device)
    centre = coords.float().permute(0, 2, 3, 1).reshape(n * h * w, 1, 1, 2)
    out = []
    for i, corr in enumerate(pyramid):
        c = centre / (2.0**i)
        gx = (c[..., 0] + d.view(1, win, 1)).expand(-1, win, win)
        gy = (c[..., 1] + d.view(1, 1, win)).expand(-1, win, win)
        level = corr.reshape(n * h * w, 1, *corr.shape[-2:])
        vals = bilinear_sampler(level, torch.stack([gx, gy], dim=-1))
        out.append(vals.view(n, h, w, win * win).permute(0, 3, 1, 2))
    return torch.cat(out, dim=1)


class WindowedCorr(NamedTuple):
    """The volume held as features: f1 (N, P, C) pre-scaled by 1/sqrt(C),
    the pooled target maps (N, h_l, w_l, C)."""

    f1: torch.Tensor
    f2_levels: tuple
    shape_hw: tuple


def windowed_corr_pyramid(fmap1, fmap2, num_levels: int = 4) -> WindowedCorr:
    n, c, h1, w1 = fmap1.shape
    f1 = (fmap1.float() / math.sqrt(c)).to(fmap1.dtype)
    f1 = f1.reshape(n, c, h1 * w1).transpose(1, 2).contiguous()
    levels = [fmap2.permute(0, 2, 3, 1).contiguous()]
    for _ in range(num_levels - 1):
        x = levels[-1]
        nn_, h, w, cc = x.shape
        xf = x[:, :h // 2 * 2, :w // 2 * 2].float().reshape(nn_, h // 2, 2, w // 2, 2, cc)
        levels.append((xf.sum(dim=(2, 4)) / 4.0).to(x.dtype))
    return WindowedCorr(f1, tuple(levels), (h1, w1))


def window_base(c, radius, size):
    """Integer window start floor(c) - r (clamped; a non-finite c takes the
    low end) and the fractional offset."""
    span = 2 * radius + 2
    fl = torch.floor(c)
    start = torch.where(torch.isfinite(fl), fl - radius, -span - 1.0)
    return start.clamp(-span - 1, size + 1).long(), c - fl


def windowed_corr_lookup(wc: WindowedCorr, coords, radius: int = 4):
    """`corr_lookup` over the volume that `wc` holds, without forming it:
    per level, gather each query's (2r+2)^2 integer taps, dot them with f1
    in float32, tent-blend to the (2r+1)^2 taps, cast once to the feature
    dtype. Taps off the map count zero."""
    n, _, h, w = coords.shape
    p = h * w
    win, span = 2 * radius + 1, 2 * radius + 2
    m = span + 1
    f1 = wc.f1.float()
    c = f1.shape[-1]
    flat = coords.float().reshape(n, 2, p)
    rows = torch.arange(span, device=coords.device)
    out = []
    for i, f2 in enumerate(wc.f2_levels):
        _, hl, wl, _ = f2.shape
        x0, fx = window_base(flat[:, 0] / 2.0**i, radius, wl)
        y0, fy = window_base(flat[:, 1] / 2.0**i, radius, hl)
        f2p = F.pad(f2, (0, 0, m, m, m, m))
        wlp = wl + 2 * m
        rows_total = (hl + 2 * m) * wlp
        bands = f2p.reshape(n, rows_total * c).as_strided(
            (n, rows_total - span + 1, span * c), (rows_total * c, c, 1))
        idx = ((y0 + m).unsqueeze(-1) + rows) * wlp + (x0 + m).unsqueeze(-1)
        g = bands[torch.arange(n, device=coords.device).view(n, 1), idx.reshape(n, p * span)]
        g = g.reshape(n, p, span, span, c).float()
        s = torch.einsum("npyxc,npc->npyx", g, f1)
        fy_, fx_ = fy.reshape(n, p, 1, 1), fx.reshape(n, p, 1, 1)
        sy = s[:, :, :win] * (1.0 - fy_) + s[:, :, 1:] * fy_
        v = sy[..., :win] * (1.0 - fx_) + sy[..., 1:] * fx_
        v = v.transpose(2, 3).to(wc.f1.dtype)
        out.append(v.reshape(n, h, w, win * win).permute(0, 3, 1, 2))
    return torch.cat(out, dim=1)


def lookup(state, coords, radius: int = 4):
    if isinstance(state, WindowedCorr):
        return windowed_corr_lookup(state, coords, radius)
    return corr_lookup(state, coords, radius)
