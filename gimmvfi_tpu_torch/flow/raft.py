"""RAFT optical flow (`gimmvfi_tpu/flow/raft.py`), NCHW.

Module and parameter names follow the reference RAFT state dict
(`fnet.*`, `cnet.*`, `update_block.*`). The refinement scan is a Python
loop; the upsample-mask head runs once on the final hidden state. `train`
switches `cnet`'s BatchNorm to batch statistics (stage-2 training); every
other path keeps the running ones.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import BatchNorm2d, Conv2d, GemmConv2d, InstanceNorm, conv
from ..ops import corr as corr_ops
from ..ops.coords import coords_grid


def _norm(norm_fn: str, planes: int, dtype) -> nn.Module:
    if norm_fn == "instance":
        return InstanceNorm()
    if norm_fn == "batch":
        return BatchNorm2d(planes, compute_dtype=dtype)
    raise ValueError(f"unknown norm {norm_fn}")


class ResidualBlock(nn.Module):
    """Two 3x3 convs + norm, with a strided 1x1 downsample when stride > 1."""

    def __init__(self, in_planes, planes, norm_fn="instance", stride=1, dtype=None):
        super().__init__()
        self.conv1 = conv(in_planes, planes, 3, stride, 1, dtype)
        self.conv2 = conv(planes, planes, 3, 1, 1, dtype)
        self.norm1 = _norm(norm_fn, planes, dtype)
        self.norm2 = _norm(norm_fn, planes, dtype)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                conv(in_planes, planes, 1, stride, 0, dtype), _norm(norm_fn, planes, dtype)
            )

    def forward(self, x, train=False):
        y = F.relu(self.norm1(self.conv1(x), train))
        y = F.relu(self.norm2(self.conv2(y), train))
        if self.downsample is not None:
            x = self.downsample[1](self.downsample[0](x), train)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """7x7/s2 stem + residual stages (64, 96, 128) + 1x1 head."""

    def __init__(self, output_dim=256, norm_fn="instance", dtype=None):
        super().__init__()
        self.conv1 = conv(3, 64, 7, 2, 3, dtype)
        self.norm1 = _norm(norm_fn, 64, dtype)
        planes = 64
        for li, (out, stride) in enumerate(((64, 1), (96, 2), (128, 2)), start=1):
            layer = nn.Sequential(
                ResidualBlock(planes, out, norm_fn, stride, dtype),
                ResidualBlock(out, out, norm_fn, 1, dtype),
            )
            setattr(self, f"layer{li}", layer)
            planes = out
        self.conv2 = conv(128, output_dim, 1, 1, 0, dtype)

    def forward(self, x, train=False):
        """Returns (head output, [layer2 output, layer3 output])."""
        h = F.relu(self.norm1(self.conv1(x), train))
        feats = []
        for layer in (self.layer1, self.layer2, self.layer3):
            for block in layer:
                h = block(h, train)
            feats.append(h)
        return self.conv2(h), feats[1:]


class BasicMotionEncoder(nn.Module):
    """In float32 (`dtype` None) the two 3x3 convs over 256 channels,
    `convc2` and `conv`, are GEMMs (`GemmConv2d`, same keys): at 720p cuDNN
    sends them to its FFT path, as it does FlowFormer's. bf16 keeps cuDNN."""

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
    """Separable 1x5 + 5x1 ConvGRU."""

    def __init__(self, hidden_dim=128, input_dim=128 + 128, dtype=None):
        super().__init__()
        cin = hidden_dim + input_dim
        for suffix, ks, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{suffix}", conv(cin, hidden_dim, ks, 1, pad, dtype))

    def forward(self, h, x):
        for suffix in "12":
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{suffix}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{suffix}")(hx))
            q = torch.tanh(getattr(self, f"convq{suffix}")(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, input_dim=128, hidden_dim=256, dtype=None):
        super().__init__()
        self.conv1 = conv(input_dim, hidden_dim, 3, 1, 1, dtype)
        self.conv2 = conv(hidden_dim, 2, 3, 1, 1, dtype)

    def forward(self, x):
        # delta flow leaves in float32: the coordinate state is float32
        return self.conv2(F.relu(self.conv1(x))).float()


class BasicUpdateBlock(nn.Module):
    """Motion encoder -> SepConvGRU -> flow head; `mask` is the convex-upsample
    mask head, applied once after the loop (`upsample_mask`)."""

    def __init__(self, hidden_dim=128, dtype=None):
        super().__init__()
        self.encoder = BasicMotionEncoder(dtype=dtype)
        self.gru = SepConvGRU(hidden_dim, 128 + hidden_dim, dtype)
        self.flow_head = FlowHead(hidden_dim, 256, dtype)
        self.mask = nn.Sequential(
            conv(128, 256, 3, 1, 1, dtype), nn.ReLU(), conv(256, 64 * 9, 1, 1, 0, dtype)
        )

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, self.flow_head(net)

    def upsample_mask(self, net):
        return 0.25 * self.mask(net)


def convex_upsample_8x(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Convex-combination 8x upsampling. flow (N, 2, H, W); mask (N, 576, H, W)
    with channel (k*8 + i)*8 + j (k the 3x3 neighbour, (i, j) the subpixel)."""
    n, _, h, w = flow.shape
    mask = torch.softmax(mask.float().view(n, 1, 9, 8, 8, h, w), dim=2)
    neighbors = F.unfold(8.0 * flow, [3, 3], padding=1).view(n, 2, 9, 1, 1, h, w)
    up = (mask * neighbors).sum(dim=2)  # (N, 2, 8, 8, H, W)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(n, 2, 8 * h, 8 * w)


class RAFT(nn.Module):
    """RAFT-Large. Images in [0, 255], NCHW.

    forward(image1, image2) estimates both directions in one batched pass
    (the reference's `bidir=True`): forward in rows :N, backward in rows
    N:. The reverse volume is the transpose of the forward one. Returns
    (flow_up, [feat_1/4, feat_1/8] from cnet, fnet output), each 2N rows.
    That is exact only under running BatchNorm statistics. With
    `bidir=False` it estimates image1 -> image2 alone: fnet over both
    images, one volume, cnet over image1 only, so that `train=True` takes
    BatchNorm statistics over that direction's batch (stage-2 training
    makes one such call a direction); the results have N rows, the fnet
    output being image1's.

    Above `corr_max_volume_bytes` (both directions' pyramids together) no
    volume is formed: the loop looks up the windowed state
    (`ops/corr.py: WindowedCorr`), whose rows are the forward direction's
    queries against the second frame, then the backward's against the first.

    The module is built on `device`, the CUDA card when None; the CPU only
    when asked (`device="cpu"`). Without a card the default raises.
    """

    def __init__(self, iters=20, dtype=None, device=None,
                 corr_max_volume_bytes=corr_ops.MAX_VOLUME_BYTES):
        super().__init__()
        self.iters = iters
        self.dtype = dtype
        self.corr_max_volume_bytes = corr_max_volume_bytes
        self.fnet = BasicEncoder(256, "instance", dtype)
        self.cnet = BasicEncoder(256, "batch", dtype)
        self.update_block = BasicUpdateBlock(128, dtype)
        self.to(torch.device("cuda") if device is None else device)

    def forward(self, image1, image2, train=False, bidir=True):
        image1 = 2 * (image1 / 255.0) - 1.0
        image2 = 2 * (image2 / 255.0) - 1.0
        n = image1.shape[0]
        fdt = self.dtype or torch.float32
        fmaps, _ = self.fnet(torch.cat([image1, image2], dim=0))
        fmaps = fmaps.to(fdt)
        fmap1, fmap2 = fmaps[:n], fmaps[n:]

        if not bidir:
            corr_state = corr_ops.corr_pyramid_auto(
                fmap1, fmap2, max_volume_bytes=self.corr_max_volume_bytes)
            cnet_in, fmaps = image1, fmap1
        elif 2 * corr_ops.volume_bytes(fmap1, fmap2) > self.corr_max_volume_bytes:
            # both directions batched: queries [fmap1; fmap2] against [fmap2; fmap1]
            corr_state = corr_ops.windowed_corr_pyramid(fmaps, torch.cat([fmap2, fmap1], dim=0))
            cnet_in = torch.cat([image1, image2], dim=0)
        else:
            fwd, bwd = corr_ops.bidir_corr_pyramid(fmap1, fmap2)
            corr_state = tuple(torch.cat([f, b], dim=0) for f, b in zip(fwd, bwd))
            cnet_in = torch.cat([image1, image2], dim=0)

        cnet, feats = self.cnet(cnet_in, train)
        net = torch.tanh(cnet[:, :128])
        inp = F.relu(cnet[:, 128:])

        h8, w8 = image1.shape[2] // 8, image1.shape[3] // 8
        coords0 = coords_grid(cnet_in.shape[0], h8, w8, image1.device)
        coords1 = coords0
        for _ in range(self.iters):
            # as the reference, no gradient flows through the coordinates
            # from one iteration into the next
            coords1 = coords1.detach()
            corr = corr_ops.corr_lookup_any(corr_state, coords1)
            net, delta_flow = self.update_block(net, inp, corr, coords1 - coords0)
            coords1 = coords1 + delta_flow

        flow_up = convex_upsample_8x(coords1 - coords0, self.update_block.upsample_mask(net))
        return flow_up, feats, fmaps
