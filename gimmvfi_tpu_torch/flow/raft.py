"""RAFT optical flow (`gimmvfi_tpu/flow/raft.py`), NCHW.

Module and parameter names follow the reference RAFT state dict
(`fnet.*`, `cnet.*`, `update_block.*`). The refinement scan is a Python
loop; the upsample-mask head runs once on the final hidden state. `train`
switches `cnet`'s BatchNorm to batch statistics (stage-2 training); every
other path keeps the running ones.

`RAFT.forward_sharded` is the bidirectional inference pass with the width
split over the ranks of a process group (`parallel/spatial.py`): the
encoders on a window of each rank's strip of 1/8-scale columns, the
correlation state of the strip's queries against the whole second map,
the update loop on the strip with a halo exchange an iteration, and the
convex upsample on the strip; the results are gathered whole.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..nn.layers import (
    BatchNorm2d,
    ColumnShard,
    Conv2d,
    GemmConv2d,
    InstanceNorm,
    conv,
    instance_norm_shard,
    receptive_radius,
    strided_reach,
)
from ..ops import corr as corr_ops
from ..ops.coords import coords_grid
from ..parallel import dist as dist_ops


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

    def __init__(self, hidden_dim=128, dtype=None, corr_planes=4 * 81):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes, dtype)
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

    `corr_levels` and `corr_radius` (JAX's fields, 4 and 4 by default) set
    every lookup and the motion encoder's input, levels x (2r+1)^2 planes.
    On the card the windowed kernels take any of them: past 4 levels or
    radius 4 a windowed lookup takes their general case (`ops/corr.py`).

    Above `corr_max_volume_bytes` (both directions' pyramids together) no
    volume is formed: the loop looks up the windowed state
    (`ops/corr.py: WindowedCorr`), whose rows are the forward direction's
    queries against the second frame, then the backward's against the first.

    The module is built on `device`, the CUDA card when None; the CPU only
    when asked (`device="cpu"`). Without a card the default raises.
    """

    def __init__(self, iters=20, dtype=None, device=None,
                 corr_max_volume_bytes=corr_ops.MAX_VOLUME_BYTES, corr_levels=4, corr_radius=4):
        super().__init__()
        self.iters = iters
        self.dtype = dtype
        self.corr_max_volume_bytes = corr_max_volume_bytes
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.fnet = BasicEncoder(256, "instance", dtype)
        self.cnet = BasicEncoder(256, "batch", dtype)
        self.update_block = BasicUpdateBlock(128, dtype,
                                             corr_levels * (2 * corr_radius + 1) ** 2)
        self.to(torch.device("cuda") if device is None else device)

    def forward(self, image1, image2, train=False, bidir=True):
        image1 = 2 * (image1 / 255.0) - 1.0
        image2 = 2 * (image2 / 255.0) - 1.0
        n = image1.shape[0]
        fdt = self.dtype or torch.float32
        fmaps, _ = self.fnet(torch.cat([image1, image2], dim=0))
        fmaps = fmaps.to(fdt)
        fmap1, fmap2 = fmaps[:n], fmaps[n:]
        levels = self.corr_levels

        if not bidir:
            corr_state = corr_ops.corr_pyramid_auto(
                fmap1, fmap2, levels, max_volume_bytes=self.corr_max_volume_bytes)
            cnet_in, fmaps = image1, fmap1
        elif 2 * corr_ops.volume_bytes(fmap1, fmap2) > self.corr_max_volume_bytes:
            # both directions batched: queries [fmap1; fmap2] against [fmap2; fmap1]
            corr_state = corr_ops.windowed_corr_pyramid(fmaps, torch.cat([fmap2, fmap1], dim=0),
                                                        levels)
            cnet_in = torch.cat([image1, image2], dim=0)
        else:
            fwd, bwd = corr_ops.bidir_corr_pyramid(fmap1, fmap2, levels)
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
            corr = corr_ops.corr_lookup_any(corr_state, coords1, self.corr_radius)
            net, delta_flow = self.update_block(net, inp, corr, coords1 - coords0)
            coords1 = coords1 + delta_flow

        flow_up = convex_upsample_8x(coords1 - coords0, self.update_block.upsample_mask(net))
        return flow_up, feats, fmaps

    def halos(self) -> tuple[int, int, int]:
        """The halos of `forward_sharded`, in 1/8-scale columns, from the
        modules: (encoders, one loop iteration, the upsample).
          * The encoders: the larger strided reach (`strided_reach`: k // 2
            times the strides before each conv, 53 input columns) over
            their stride of 8, rounded up: 7.
          * An iteration reads the hidden state, the context and the
            coordinates; its lookup is pointwise in the query, so its reach
            is the sum of k // 2 over the motion encoder's, the GRU's and
            the flow head's convs: 6 + 6 + 2 = 14.
          * The upsample: the mask head's 3x3 conv over the hidden state and
            the 3x3 unfold of the flow each read 1."""
        enc = max(-(-reach // stride) for reach, stride in (strided_reach(self.fnet),
                                                              strided_reach(self.cnet)))
        ub = self.update_block
        it = (receptive_radius(ub.encoder) + receptive_radius(ub.gru)
              + receptive_radius(ub.flow_head))
        return enc, it, max(1, receptive_radius(ub.mask))

    def forward_sharded(self, image1, image2, strips: list[tuple[int, int]], group=None,
                        halos: tuple[int, int, int] | None = None):
        """`forward(image1, image2)` (both directions, running statistics)
        with the width split over the ranks of `group` (the default group
        if None): `strips` are every rank's columns [a, b) at 1/8 scale, in
        rank order, tiling W / 8. Every rank passes the whole pair; each
        returns `forward`'s results, whole, equal to one process's up to
        float rounding. On this rank, with `halos` (`RAFT.halos()` if None)
        (enc, it, up) in 1/8 columns:
          1. fnet and cnet on the input columns 8 x [a - enc, b + enc),
             clipped to the frame; fnet's instance norms take the whole
             frame's statistics (`instance_norm_shard`); the feature map and
             cnet's two feature maps are cropped to the strip and gathered
             whole (`dist.gather_disjoint`);
          2. the correlation state of the queries [a - it, b + it) against
             the whole other map; whether it is materialized or windowed
             depends on the whole pair's volume, as in `forward`;
          3. each iteration: the hidden state and the coordinates of the
             strip widened by `it` (`dist.exchange_halo`, one all-reduce),
             the lookup and the update block on that window, cropped back;
          4. the mask head and the convex upsample on the strip widened by
             `up`, cropped and gathered whole.
        Windows clipped at the frame's edge pad there as the frame does. H
        and W must be multiples of 8. Without a group, `strips` is one
        strip and this is `forward`."""
        if not dist_ops.group_up():
            return self(image1, image2)
        rank = dist.get_rank(group)
        n, _, h, w = image1.shape
        w8 = w // 8
        if h % 8 or w % 8 or strips[-1][1] != w8 or strips[0][0] != 0:
            raise ValueError(f"the strips {strips} do not tile the 1/8-scale width of a "
                             f"{h}x{w} frame (a multiple of 8 a side)")
        a, b = strips[rank]
        enc, it, up = self.halos() if halos is None else halos
        dev = image1.device
        images = torch.cat([2 * (image1 / 255.0) - 1.0, 2 * (image2 / 255.0) - 1.0], dim=0)
        lo, hi = max(0, a - enc), min(w8, b + enc)
        x = images[..., 8 * lo:8 * hi]
        with instance_norm_shard(ColumnShard(8 * lo, 8 * hi, 8 * a, 8 * b, w, group)):
            fmaps, _ = self.fnet(x)
        own = slice(a - lo, b - lo)

        def gather(part, scale):
            return dist_ops.gather_disjoint(part, scale * a, scale * b, scale * w8, 3, group)

        fmaps = gather(fmaps[..., own].to(self.dtype or torch.float32), 1)
        fmap1, fmap2 = fmaps[:n], fmaps[n:]
        wlo, whi = max(0, a - it), min(w8, b + it)
        queries = fmaps[..., wlo:whi]
        # the route of the whole pair's volume, as `forward` takes it
        levels = self.corr_levels
        if 2 * corr_ops.volume_bytes(fmap1, fmap2) > self.corr_max_volume_bytes:
            corr_state = corr_ops.windowed_corr_pyramid(queries, torch.cat([fmap2, fmap1], dim=0),
                                                        levels)
        else:
            corr_state = tuple(torch.cat(both, dim=0) for both in zip(
                corr_ops.corr_pyramid(queries[:n], fmap2, levels),
                corr_ops.corr_pyramid(queries[n:], fmap1, levels)))

        cnet, feats = self.cnet(x)
        feats = [gather(feats[0][..., 2 * (a - lo):2 * (b - lo)], 2), gather(feats[1][..., own], 1)]
        cnet = cnet[..., own]
        net = torch.tanh(cnet[:, :128])
        inp = dist_ops.exchange_halo(F.relu(cnet[:, 128:]), strips, it, 3, group)

        def widened(net, coords, halo):
            """net and coords of the strip, widened by `halo` (one exchange)."""
            both = dist_ops.exchange_halo(torch.cat([net.float(), coords], dim=1), strips, halo,
                                          3, group)
            return both[:, :net.shape[1]].to(net.dtype), both[:, net.shape[1]:]

        h8 = h // 8
        coords0 = coords_grid(2 * n, h8, whi - wlo, dev, x0=wlo)
        mine = slice(a - wlo, b - wlo)
        coords1 = coords0[..., mine]
        for _ in range(self.iters):
            net_w, coords_w = widened(net, coords1, it)
            corr = corr_ops.corr_lookup_any(corr_state, coords_w, self.corr_radius)
            net_w, delta_flow = self.update_block(net_w, inp, corr, coords_w - coords0)
            net = net_w[..., mine]
            coords1 = coords1 + delta_flow[..., mine]

        net_u, coords_u = widened(net, coords1, up)
        ulo = max(0, a - up)
        flow = coords_u - coords_grid(2 * n, h8, coords_u.shape[3], dev, x0=ulo)
        flow_up = convex_upsample_8x(flow, self.update_block.upsample_mask(net_u))
        return gather(flow_up[..., 8 * (a - ulo):8 * (b - ulo)], 8), feats, fmaps
