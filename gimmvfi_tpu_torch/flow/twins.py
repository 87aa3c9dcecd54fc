"""Twins-SVT encoder, truncated to 2 stages, for FlowFormer
(`gimmvfi_tpu/flow/twins.py`).

twins_svt_large's first two stages: patch 4 then 2, dims (128, 256), heads
(4, 8), depth 2 a stage, alternating locally grouped (LSA, 7x7 windows) and
global sub-sampled (GSA, sr 8 then 4) attention, a PEG after each stage's
first block. The blocks work on channels-last token grids (B, H, W, C), as
timm's do; the encoder takes and returns NCHW. Parameter names follow the
reference state dict (`svt.patch_embeds.{i}`, `svt.blocks.{i}.{j}`,
`svt.pos_block.{i}.proj.0`); the final stage norm is dead in the reference
and has no parameter here. Every LayerNorm uses eps 1e-6.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6


def pad_hw(x: torch.Tensor, mult: int) -> torch.Tensor:
    """Zero-pad (B, H, W, C) bottom/right so H and W divide `mult`."""
    _, h, w, _ = x.shape
    ph, pw = (mult - h % mult) % mult, (mult - w % mult) % mult
    return F.pad(x, (0, 0, 0, pw, 0, ph)) if ph or pw else x


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """An NCHW conv applied to a channels-last (B, H, W, C) grid."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over the last two dims."""
    return torch.softmax((q @ k.transpose(-2, -1)).mul_(scale), dim=-1) @ v


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class LocallyGroupedAttn(nn.Module):
    """LSA: softmax attention within ws x ws windows, fused qkv. The zero
    pad to a multiple of ws takes part in the softmax (no mask), as in the
    reference, and is cropped afterwards."""

    def __init__(self, dim: int, num_heads: int, ws: int = 7):
        super().__init__()
        self.num_heads, self.ws = num_heads, ws
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, h, w, c = x.shape
        nh, ws = self.num_heads, self.ws
        hd = c // nh
        xp = pad_hw(x, ws)
        hp, wp = xp.shape[1:3]
        gh, gw = hp // ws, wp // ws
        # (B, gh, ws, gw, ws, 3, heads, hd) -> (3, B, groups, heads, ws*ws, hd)
        qkv = self.qkv(xp).view(b, gh, ws, gw, ws, 3, nh, hd)
        qkv = qkv.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b, gh * gw, nh, ws * ws, hd)
        out = attend(qkv[0], qkv[1], qkv[2], hd**-0.5)
        out = out.view(b, gh, gw, nh, ws, ws, hd).permute(0, 1, 4, 2, 5, 3, 6)
        out = out.reshape(b, hp, wp, c)[:, :h, :w]
        return self.proj(out)


class GlobalSubSampleAttn(nn.Module):
    """GSA: every query attends to keys and values sub-sampled by a VALID
    sr x sr conv (which floors a ragged edge), fused kv."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x):
        b, h, w, c = x.shape
        nh = self.num_heads
        hd = c // nh
        q = self.q(x).view(b, h * w, nh, hd).transpose(1, 2)
        kv_in = self.norm(conv_nhwc(self.sr, x)) if self.sr_ratio > 1 else x
        m = kv_in.shape[1] * kv_in.shape[2]
        kv = self.kv(kv_in).view(b, m, 2, nh, hd).permute(2, 0, 3, 1, 4)
        out = attend(q, kv[0], kv[1], hd**-0.5)
        return self.proj(out.transpose(1, 2).reshape(b, h, w, c))


class TwinsBlock(nn.Module):
    """Pre-norm attention (LSA if ws > 1, else GSA) + MLP, both residual."""

    def __init__(self, dim: int, num_heads: int, ws: int, sr_ratio: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = (LocallyGroupedAttn(dim, num_heads, ws) if ws > 1
                     else GlobalSubSampleAttn(dim, num_heads, sr_ratio))
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    """VALID patch x patch conv, stride patch, then LayerNorm; NCHW in,
    channels-last out."""

    def __init__(self, cin: int, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, dim, patch, patch)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x):
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class PosConv(nn.Module):
    """PEG: depthwise 3x3 conv plus the residual (key `proj.0`)."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Sequential(nn.Conv2d(dim, dim, 3, 1, 1, groups=dim))

    def forward(self, x):
        return conv_nhwc(self.proj, x) + x


class TwinsSVTLarge2Stage(nn.Module):
    """twins_svt_large truncated to stages 0-1. forward(x): x (B, 3, H, W)
    normalized to [-1, 1]; returns (the 1/8 map, [the 1/4 map (128 ch),
    the 1/8 map (256 ch)]), NCHW."""

    def __init__(self, embed_dims=(128, 256), num_heads=(4, 8), depths=(2, 2),
                 sr_ratios=(8, 4), ws: int = 7):
        super().__init__()
        cins = (3,) + tuple(embed_dims[:-1])
        self.svt = nn.ModuleDict({
            "patch_embeds": nn.ModuleList(
                PatchEmbed(cin, dim, 4 if i == 0 else 2)
                for i, (cin, dim) in enumerate(zip(cins, embed_dims))),
            # even blocks LSA, odd blocks GSA
            "blocks": nn.ModuleList(
                nn.ModuleList(TwinsBlock(dim, heads, ws if j % 2 == 0 else 1, sr)
                              for j in range(depth))
                for dim, heads, depth, sr in zip(embed_dims, num_heads, depths, sr_ratios)),
            "pos_block": nn.ModuleList(PosConv(dim) for dim in embed_dims),
        })

    def forward(self, x):
        feats = []
        svt = self.svt
        for embed, blocks, pos in zip(svt["patch_embeds"], svt["blocks"], svt["pos_block"]):
            x = embed(x)
            for j, block in enumerate(blocks):
                x = block(x)
                if j == 0:
                    x = pos(x)
            x = x.permute(0, 3, 1, 2)
            feats.append(x)
        return x, feats
