"""AMT-style coarse-to-fine frame synthesis (`gimmvfi_tpu/models/synthesis.py`), NCHW.

Parameter names follow the reference state dict: `upsample.<i>` and
`convblock.<i>` Sequentials in the decoders, `conv1..5`/`prelu` in ResBlock,
`layers.0/2` in LateralBlock. Flow corrections and decoder outputs leave in
float32 in both compute modes. The upsample heads' BatchNorm takes batch
statistics only when `upsample_features` is given `train=True` (stage-2
training); every other path keeps the running ones.

With `remat` (JAX's field, on by default as there) each decoder recomputes
its upsample head and each ResBlock of its conv block in the backward
(`nn/layers.py: remat_call`, JAX's `_block_classes`); GIMMVFI_R wraps the
decoders' and the update blocks' calls as units of their own around them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import BatchNorm2d, PReLU, conv, conv_prelu, leaky_relu, remat_call
from ..ops.interp import resize, warp

NUM_FLOWS = 3  # the default flow pairs the MultiFlowDecoder predicts and the combine blends
CORR_PLANES = 2 * 4 * 81  # both directions x 4 levels x (2r+1)^2 taps at the default radius 4


class LateralBlock(nn.Module):
    """conv-lrelu-conv residual block."""

    def __init__(self, dim, dtype=None):
        super().__init__()
        self.layers = nn.Sequential(
            conv(dim, dim, 3, 1, 1, dtype), nn.LeakyReLU(0.1), conv(dim, dim, 3, 1, 1, dtype)
        )

    def forward(self, x):
        return x + self.layers(x)


class ResBlock(nn.Module):
    """Residual block with a narrow side channel."""

    def __init__(self, in_channels, side_channels, dtype=None):
        super().__init__()
        c, s = in_channels, side_channels
        self.side = s
        self.conv1 = conv_prelu(c, c, dtype=dtype)
        self.conv2 = conv_prelu(s, s, dtype=dtype)
        self.conv3 = conv_prelu(c, c, dtype=dtype)
        self.conv4 = conv_prelu(s, s, dtype=dtype)
        self.conv5 = conv(c, c, 3, 1, 1, dtype)
        self.prelu = PReLU(c)

    def forward(self, x):
        s = self.side
        out = self.conv1(x)
        side = self.conv2(out[:, -s:])
        out = self.conv3(torch.cat([out[:, :-s], side], dim=1))
        side = self.conv4(out[:, -s:])
        out = self.conv5(torch.cat([out[:, :-s], side], dim=1))
        return self.prelu(x + out)


class UpsampleHead(nn.Sequential):
    """PixelShuffle(2) x num_shuffles, five convrelu, 1x1 conv, BN, ReLU;
    `train` goes to the BN."""

    def __init__(self, in_ch: int, num_shuffles: int, dtype=None):
        c_in = in_ch // 4**num_shuffles
        c4 = in_ch // 4
        layers = [nn.PixelShuffle(2) for _ in range(num_shuffles)]
        layers += [
            conv_prelu(c_in, c4, 5, 1, 2, dtype),
            conv_prelu(c4, c4, dtype=dtype),
            conv_prelu(c4, c4, dtype=dtype),
            conv_prelu(c4, c4, dtype=dtype),
            conv_prelu(c4, in_ch // 2, dtype=dtype),
            conv(in_ch // 2, in_ch // 2, 1, 1, 0, dtype),
            BatchNorm2d(in_ch // 2, compute_dtype=dtype),
            nn.ReLU(),
        ]
        super().__init__(*layers)

    def forward(self, x, train=False):
        for layer in self:
            x = layer(x, train) if isinstance(layer, BatchNorm2d) else layer(x)
        return x


def _conv_block(cin, c, skip, cout, first_k, dtype) -> nn.Sequential:
    return nn.Sequential(
        conv_prelu(cin, c, first_k, 1, first_k // 2, dtype),
        ResBlock(c, skip, dtype),
        ResBlock(c, skip, dtype),
        ResBlock(c, skip, dtype),
        conv(c, cout, 3, 1, 1, dtype),
    )


def _run_conv_block(block: nn.Sequential, x, remat: bool):
    """`block(x)` (`_conv_block`), each ResBlock a remat unit under `remat`."""
    for layer in block:
        x = remat_call(layer, x, remat=remat) if isinstance(layer, ResBlock) else layer(x)
    return x


def _warp_with_image(feat, img, flow, x0=0):
    """Warp features and image with one sample per flow; `flow` may be a
    window of columns from `x0` of the whole `feat` and `img` (`warp`)."""
    w = warp(torch.cat([feat, img.to(feat.dtype)], dim=1), flow, x0)
    c = feat.shape[1]
    return w[:, :c], w[:, c:]


class InitDecoder(nn.Module):
    """1/8 features -> 1/4: warp by the INR flows, refine, emit corrected
    flows and a (1 mask + features) tensor. `upsample` is t-invariant and
    runs once per pair (`upsample_features`)."""

    def __init__(self, in_ch=256, skip_ch=64, dtype=None, remat=True):
        super().__init__()
        self.remat = remat
        self.upsample = UpsampleHead(in_ch, 1, dtype)
        c = in_ch // 2
        self.convblock = _conv_block(2 * c + 2 * 2 + 4 * 3, c, skip_ch, c + 5, 1, dtype)

    def upsample_features(self, f, train=False):
        return remat_call(self.upsample, f, train, remat=self.remat)

    def forward(self, f0, f1, flow0_in, flow1_in, img0, img1):
        scale = f0.shape[2] / img0.shape[2]
        img0 = resize(img0, scale)
        img1 = resize(img1, scale)
        f0w, w0 = _warp_with_image(f0, img0, flow0_in)
        f1w, w1 = _warp_with_image(f1, img1, flow1_in)
        f_in = torch.cat([f0w, f1w, flow0_in, flow1_in, img0, img1, w0, w1], dim=1)
        out = _run_conv_block(self.convblock, f_in, self.remat)
        flow0 = flow0_in + out[:, :2].float()
        flow1 = flow1_in + out[:, 2:4].float()
        return flow0, flow1, out[:, 4:]


class UpdateBlock(nn.Module):
    """AMT update block: bidirectional corr + flow-pair encoders -> conv
    'gru' -> delta feature and delta flow; optional internal 2x scale.
    `corr_planes` is the width of the lookups it reads: both directions x
    the levels x (2r+1)^2 taps."""

    def __init__(self, scale_factor=None, dtype=None, corr_planes=CORR_PLANES):
        super().__init__()
        self.scale_factor = scale_factor
        self.dtype = dtype
        cdim, hidden_dim, flow_dim, corr_dim, corr_dim2, fc_dim = 128, 192, 64, 256, 192, 188
        self.convc1 = conv(corr_planes, corr_dim, 1, 1, 0, dtype)
        self.convc2 = conv(corr_dim, corr_dim2, 3, 1, 1, dtype)
        self.convf1 = conv(4, flow_dim * 2, 7, 1, 3, dtype)
        self.convf2 = conv(flow_dim * 2, flow_dim, 3, 1, 1, dtype)
        self.conv = conv(corr_dim2 + flow_dim, fc_dim, 3, 1, 1, dtype)

        def head(cin, cout):
            return nn.Sequential(
                conv(cin, hidden_dim, 3, 1, 1, dtype), nn.LeakyReLU(0.1),
                conv(hidden_dim, cout, 3, 1, 1, dtype),
            )

        self.gru = head(fc_dim + 4 + cdim, hidden_dim)
        self.feat_head = head(hidden_dim, cdim)
        self.flow_head = head(hidden_dim, 4)

    def forward(self, net, flow, corr):
        sf = self.scale_factor
        if sf is not None:
            net = resize(net, 1.0 / sf)
        cor = leaky_relu(self.convc2(leaky_relu(self.convc1(corr))))
        flo = leaky_relu(self.convf2(leaky_relu(self.convf1(flow))))
        inp = leaky_relu(self.conv(torch.cat([cor, flo], dim=1)))
        if self.dtype is not None:
            flow = flow.to(self.dtype)
            net = net.to(self.dtype)
        h = self.gru(torch.cat([inp, flow, net], dim=1))
        dnet = self.feat_head(h)
        dflow = self.flow_head(h).float()
        if sf is not None:
            dnet = resize(dnet, sf)
            dflow = sf * resize(dflow, sf)
        return dnet, dflow


class MultiFlowDecoder(nn.Module):
    """1/4 -> 1/1 via two PixelShuffles; predicts num_flows flow pairs, masks
    and image residuals. `upsample` is t-invariant (`upsample_features`).

    `forward` decodes a window of columns: ft_, flow0, flow1 and mask are
    the window's 1/4-scale state, whose full-resolution columns start at
    `x0`; f0, f1, img0 and img1 are whole frames, the warps' sources, read
    at global positions (the concat takes the window's columns of the
    images). With x0 = 0 and a whole-width state it decodes the frame."""

    def __init__(self, in_ch=128, skip_ch=64, dtype=None, num_flows=NUM_FLOWS, remat=True):
        super().__init__()
        self.num_flows = num_flows
        self.remat = remat
        self.upsample = UpsampleHead(in_ch, 2, dtype)
        c_feat = in_ch // 2
        cin = in_ch + 2 * c_feat + 2 * 2 + 1 + 4 * 3
        self.convblock = _conv_block(cin, 2 * in_ch, skip_ch, 8 * num_flows, 3, dtype)

    def upsample_features(self, f, train=False):
        return remat_call(self.upsample, f, train, remat=self.remat)

    def forward(self, ft_, f0, f1, flow0, flow1, mask, img0, img1, x0=0):
        n = self.num_flows
        flow0 = 4.0 * resize(flow0, 4.0)
        flow1 = 4.0 * resize(flow1, 4.0)
        ft_ = resize(ft_, 4.0)
        mask = resize(mask, 4.0)
        f0w, w0 = _warp_with_image(f0, img0, flow0, x0)
        f1w, w1 = _warp_with_image(f1, img1, flow1, x0)
        cols = slice(x0, x0 + flow0.shape[3])
        f_in = torch.cat([ft_, f0w, f1w, flow0, flow1, mask, img0[..., cols], img1[..., cols],
                          w0, w1], dim=1)
        out = _run_conv_block(self.convblock, f_in, self.remat).float()
        d_flow0, d_flow1, d_mask, img_res = torch.split(out, [2 * n, 2 * n, n, 3 * n], dim=1)
        mask = torch.sigmoid(d_mask + mask.float().repeat(1, n, 1, 1))
        flow0 = d_flow0 + flow0.repeat(1, n, 1, 1)
        flow1 = d_flow1 + flow1.repeat(1, n, 1, 1)
        return flow0, flow1, mask, img_res


def comb_block(dtype=None, num_flows=NUM_FLOWS) -> nn.Sequential:
    """7x7 conv + PReLU + 7x7 conv correction head over `num_flows` warps
    (keys `.0`, `.1`, `.2`)."""
    n = num_flows
    return nn.Sequential(
        conv(3 * n, 6 * n, 7, 1, 3, dtype), PReLU(6 * n), conv(6 * n, 3, 7, 1, 3, dtype)
    )


def multi_flow_combine(comb, img0, img1, flow0, flow1, mask, img_res, dtype=None, x0=0):
    """Blend num_flows backward warps of both frames.

    img0/img1 (N, 3, H, Ws) in [-1, 1]; flow0/flow1 (N, 2K, H, W); mask
    (N, K, H, W); img_res (N, 3K, H, W). Output (N, 3, H, W) in [0, 1]. With
    a compute dtype the image payload is warped in it; the blend is float32.
    The flows may be a window of columns from `x0` of the whole frames
    (`warp`); the output is then that window's.
    """
    n, ck, h, w = flow0.shape
    k = ck // 2
    if dtype is not None:
        img0 = img0.to(dtype)
        img1 = img1.to(dtype)

    def regroup(x, c):
        # (N, K*c, H, W) -> (N*K, c, H, W), the reference's (b, k) flattening
        return x.reshape(n * k, c, h, w)

    m = regroup(mask, 1)
    w0 = warp(img0.repeat_interleave(k, dim=0), regroup(flow0, 2), x0)
    w1 = warp(img1.repeat_interleave(k, dim=0), regroup(flow1, 2), x0)
    img_warps = (m * w0 + (1 - m) * w1 + regroup(img_res, 3)).view(n, k, 3, h, w)
    res_corr = comb(img_warps.reshape(n, k * 3, h, w)).float()
    pred = img_warps.mean(dim=1) + res_corr
    return (pred + 1.0) / 2.0
