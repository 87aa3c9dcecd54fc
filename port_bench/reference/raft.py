"""RAFT-Large, inference, both directions in one batched pass (the
reference's `bidir=True`): plain float32 copy of the port's mathematics.
Parameter names follow the RAFT state dict (`fnet.*`, `cnet.*`,
`update_block.*`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .ops import (
    BatchNorm2d,
    Conv2d,
    GemmConv2d,
    InstanceNorm,
    all_pairs_corr,
    conv,
    coords_grid,
    lookup,
    pool_levels,
    windowed_corr_pyramid,
)


def _norm(norm_fn, planes, dtype):
    return InstanceNorm() if norm_fn == "instance" else BatchNorm2d(planes, compute_dtype=dtype)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes, planes, norm_fn="instance", stride=1, dtype=None):
        super().__init__()
        self.conv1 = conv(in_planes, planes, 3, stride, 1, dtype)
        self.conv2 = conv(planes, planes, 3, 1, 1, dtype)
        self.norm1 = _norm(norm_fn, planes, dtype)
        self.norm2 = _norm(norm_fn, planes, dtype)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(conv(in_planes, planes, 1, stride, 0, dtype),
                                            _norm(norm_fn, planes, dtype))

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, output_dim=256, norm_fn="instance", dtype=None):
        super().__init__()
        self.conv1 = conv(3, 64, 7, 2, 3, dtype)
        self.norm1 = _norm(norm_fn, 64, dtype)
        planes = 64
        for li, (out, stride) in enumerate(((64, 1), (96, 2), (128, 2)), start=1):
            setattr(self, f"layer{li}", nn.Sequential(ResidualBlock(planes, out, norm_fn, stride, dtype),
                                                      ResidualBlock(out, out, norm_fn, 1, dtype)))
            planes = out
        self.conv2 = conv(128, output_dim, 1, 1, 0, dtype)

    def forward(self, x):
        h = F.relu(self.norm1(self.conv1(x)))
        feats = []
        for layer in (self.layer1, self.layer2, self.layer3):
            h = layer(h)
            feats.append(h)
        return self.conv2(h), feats[1:]


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_planes=4 * 81, dtype=None):
        super().__init__()
        self.dtype = dtype
        wide = GemmConv2d if dtype is None else Conv2d
        self.convc1 = conv(corr_planes, 256, 1, 1, 0, dtype)
        self.convc2 = wide(256, 192, 3, 1, 1, compute_dtype=dtype)
        self.convf1 = conv(2, 128, 7, 1, 3, dtype)
        self.convf2 = conv(128, 64, 3, 1, 1, dtype)
        self.conv = wide(64 + 192, 128 - 2, 3, 1, 1, compute_dtype=dtype)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        if self.dtype is not None:
            flow = flow.to(self.dtype)
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim=128, input_dim=256, dtype=None):
        super().__init__()
        cin = hidden_dim + input_dim
        for suffix, ks, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{suffix}", conv(cin, hidden_dim, ks, 1, pad, dtype))

    def forward(self, h, x):
        for s in "12":
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{s}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{s}")(hx))
            q = torch.tanh(getattr(self, f"convq{s}")(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, input_dim=128, hidden_dim=256, dtype=None):
        super().__init__()
        self.conv1 = conv(input_dim, hidden_dim, 3, 1, 1, dtype)
        self.conv2 = conv(hidden_dim, 2, 3, 1, 1, dtype)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x))).float()


class BasicUpdateBlock(nn.Module):
    def __init__(self, hidden_dim=128, dtype=None, corr_planes=4 * 81):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes, dtype)
        self.gru = SepConvGRU(hidden_dim, 128 + hidden_dim, dtype)
        self.flow_head = FlowHead(hidden_dim, 256, dtype)
        self.mask = nn.Sequential(conv(128, 256, 3, 1, 1, dtype), nn.ReLU(),
                                  conv(256, 64 * 9, 1, 1, 0, dtype))

    def forward(self, net, inp, corr, flow):
        net = self.gru(net, torch.cat([inp, self.encoder(flow, corr)], dim=1))
        return net, self.flow_head(net)


def convex_upsample_8x(flow, mask):
    """flow (N, 2, H, W) to 8x by a softmax-weighted 3x3 neighbourhood;
    mask channel (k*8 + i)*8 + j."""
    n, _, h, w = flow.shape
    mask = torch.softmax(mask.float().view(n, 1, 9, 8, 8, h, w), dim=2)
    neighbors = F.unfold(8.0 * flow, [3, 3], padding=1).view(n, 2, 9, 1, 1, h, w)
    up = (mask * neighbors).sum(dim=2)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(n, 2, 8 * h, 8 * w)


class RAFT(nn.Module):
    """forward(image1, image2), images (N, 3, H, W) in [0, 255]: both
    directions, forward rows :N, backward N:. Returns (flow_up, [cnet
    features at 1/4, 1/8], fnet map). The volume is the route the program
    takes at `route_esize` bytes an element (`ops.corr_state`)."""

    def __init__(self, iters=20, dtype=None, max_volume_bytes=2 << 30, route_esize=2):
        super().__init__()
        self.iters, self.dtype = iters, dtype
        self.max_volume_bytes, self.route_esize = max_volume_bytes, route_esize
        self.fnet = BasicEncoder(256, "instance", dtype)
        self.cnet = BasicEncoder(256, "batch", dtype)
        self.update_block = BasicUpdateBlock(128, dtype, 4 * 81)

    def forward(self, image1, image2):
        image1 = 2 * (image1 / 255.0) - 1.0
        image2 = 2 * (image2 / 255.0) - 1.0
        n = image1.shape[0]
        fmaps, _ = self.fnet(torch.cat([image1, image2], dim=0))
        fmaps = fmaps.to(self.dtype or torch.float32)
        fmap1, fmap2 = fmaps[:n], fmaps[n:]
        h1, w1 = fmap1.shape[2:]
        if 2 * (n * (h1 * w1) ** 2 * self.route_esize * 4 // 3) > self.max_volume_bytes:
            state = windowed_corr_pyramid(fmaps, torch.cat([fmap2, fmap1], dim=0), 4)
        else:
            corr = all_pairs_corr(fmap1, fmap2)
            corr_t = corr.reshape(n, h1 * w1, h1 * w1).transpose(1, 2).reshape(n, h1 * w1, h1, w1)
            state = tuple(torch.cat(fb, dim=0) for fb in zip(pool_levels(corr, 4),
                                                               pool_levels(corr_t, 4)))
        images = torch.cat([image1, image2], dim=0)
        cnet, feats = self.cnet(images)
        net = torch.tanh(cnet[:, :128])
        inp = F.relu(cnet[:, 128:])
        coords0 = coords_grid(2 * n, image1.shape[2] // 8, image1.shape[3] // 8, image1.device)
        coords1 = coords0
        for _ in range(self.iters):
            net, delta = self.update_block(net, inp, lookup(state, coords1, 4), coords1 - coords0)
            coords1 = coords1 + delta
        mask = 0.25 * self.update_block.mask(net)
        return convex_upsample_8x(coords1 - coords0, mask), feats, fmaps
