"""GIMM-VFI-R and GIMM-VFI-F, inference: a plain float32 copy of the
mathematics of the port's `models/gimmvfi_r.py`, `gimmvfi_f.py`,
`gimm_core.py`, `hyponet.py` and `synthesis.py`, the whole frame at once.

`prepare` runs once a pair (the flow estimator both ways, the AMT's
correlation state and features, the motion latents, the splat weights,
the decoders' upsample heads); `decode_one` once a timestep (the latent
splat, the latent refiner, the HypoNet, the AMT synthesis, under DS the
full-resolution blend). `interpolate_padded` is the video entry's per-pair
path: pad, interpolate, unpad, numpy.

Precision follows `Precision`: `compute` for the convolutions (None is
float32), `hyponet` for the HypoNet's matmuls, `flow` for FlowFormer (GIMM-
VFI-F; RAFT follows `compute`). Each correlation state takes the route
(materialized or windowed past `max_volume_bytes`) that the `stated`
precision, the configuration's, gives it, whatever this model computes in.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .flowformer import FlowFormer
from .ops import (
    BatchNorm2d,
    InputPadder,
    PReLU,
    all_pairs_corr,
    conv,
    conv_prelu,
    coords_grid,
    gaussian_blur3x3,
    leaky_relu,
    lookup,
    normalize_flow,
    pool_levels,
    resize,
    resize_bilinear,
    sample_coords_3d,
    softsplat_linear_zeroeps,
    unnormalize_flow,
    warp,
    windowed_corr_pyramid,
)
from .raft import RAFT

DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def esize(dtype: torch.dtype | None) -> int:
    """Bytes an element of a tensor computed in `dtype` (None: float32)."""
    return 4 if dtype is None else torch.empty((), dtype=dtype).element_size()


@dataclass(frozen=True)
class Precision:
    compute: torch.dtype | None = torch.bfloat16
    hyponet: torch.dtype | None = None
    flow: torch.dtype | None = None

    @classmethod
    def named(cls, names: dict) -> "Precision":
        """From a configuration's {"compute", "hyponet", "flow"} names."""
        return cls(**{k: DTYPES[v] for k, v in names.items()})


# ----------------------------------------------------------------- synthesis
class LateralBlock(nn.Module):
    def __init__(self, dim, dtype=None):
        super().__init__()
        self.layers = nn.Sequential(conv(dim, dim, 3, 1, 1, dtype), nn.LeakyReLU(0.1),
                                    conv(dim, dim, 3, 1, 1, dtype))

    def forward(self, x):
        return x + self.layers(x)


class ResBlock(nn.Module):
    def __init__(self, c, s, dtype=None):
        super().__init__()
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


def upsample_head(in_ch, num_shuffles, dtype=None) -> nn.Sequential:
    c4 = in_ch // 4
    return nn.Sequential(*[nn.PixelShuffle(2) for _ in range(num_shuffles)],
                         conv_prelu(in_ch // 4**num_shuffles, c4, 5, 1, 2, dtype),
                         conv_prelu(c4, c4, dtype=dtype), conv_prelu(c4, c4, dtype=dtype),
                         conv_prelu(c4, c4, dtype=dtype), conv_prelu(c4, in_ch // 2, dtype=dtype),
                         conv(in_ch // 2, in_ch // 2, 1, 1, 0, dtype),
                         BatchNorm2d(in_ch // 2, compute_dtype=dtype), nn.ReLU())


def conv_block(cin, c, skip, cout, first_k, dtype) -> nn.Sequential:
    return nn.Sequential(conv_prelu(cin, c, first_k, 1, first_k // 2, dtype), ResBlock(c, skip, dtype),
                         ResBlock(c, skip, dtype), ResBlock(c, skip, dtype),
                         conv(c, cout, 3, 1, 1, dtype))


def warp_with_image(feat, img, flow):
    w = warp(torch.cat([feat, img.to(feat.dtype)], dim=1), flow)
    c = feat.shape[1]
    return w[:, :c], w[:, c:]


class InitDecoder(nn.Module):
    def __init__(self, in_ch=256, skip_ch=64, dtype=None):
        super().__init__()
        self.upsample = upsample_head(in_ch, 1, dtype)
        c = in_ch // 2
        self.convblock = conv_block(2 * c + 2 * 2 + 4 * 3, c, skip_ch, c + 5, 1, dtype)

    def forward(self, f0, f1, flow0_in, flow1_in, img0, img1):
        scale = f0.shape[2] / img0.shape[2]
        img0, img1 = resize(img0, scale), resize(img1, scale)
        f0w, w0 = warp_with_image(f0, img0, flow0_in)
        f1w, w1 = warp_with_image(f1, img1, flow1_in)
        out = self.convblock(torch.cat([f0w, f1w, flow0_in, flow1_in, img0, img1, w0, w1], dim=1))
        return flow0_in + out[:, :2].float(), flow1_in + out[:, 2:4].float(), out[:, 4:]


class UpdateBlock(nn.Module):
    def __init__(self, scale_factor=None, dtype=None, corr_planes=2 * 4 * 81):
        super().__init__()
        self.scale_factor, self.dtype = scale_factor, dtype
        cdim, hidden, flow_dim, corr_dim, corr_dim2, fc_dim = 128, 192, 64, 256, 192, 188
        self.convc1 = conv(corr_planes, corr_dim, 1, 1, 0, dtype)
        self.convc2 = conv(corr_dim, corr_dim2, 3, 1, 1, dtype)
        self.convf1 = conv(4, flow_dim * 2, 7, 1, 3, dtype)
        self.convf2 = conv(flow_dim * 2, flow_dim, 3, 1, 1, dtype)
        self.conv = conv(corr_dim2 + flow_dim, fc_dim, 3, 1, 1, dtype)

        def head(cin, cout):
            return nn.Sequential(conv(cin, hidden, 3, 1, 1, dtype), nn.LeakyReLU(0.1),
                                 conv(hidden, cout, 3, 1, 1, dtype))

        self.gru = head(fc_dim + 4 + cdim, hidden)
        self.feat_head = head(hidden, cdim)
        self.flow_head = head(hidden, 4)

    def forward(self, net, flow, corr):
        sf = self.scale_factor
        if sf is not None:
            net = resize(net, 1.0 / sf)
        cor = leaky_relu(self.convc2(leaky_relu(self.convc1(corr))))
        flo = leaky_relu(self.convf2(leaky_relu(self.convf1(flow))))
        inp = leaky_relu(self.conv(torch.cat([cor, flo], dim=1)))
        if self.dtype is not None:
            flow, net = flow.to(self.dtype), net.to(self.dtype)
        h = self.gru(torch.cat([inp, flow, net], dim=1))
        dnet, dflow = self.feat_head(h), self.flow_head(h).float()
        if sf is not None:
            dnet, dflow = resize(dnet, sf), sf * resize(dflow, sf)
        return dnet, dflow


class MultiFlowDecoder(nn.Module):
    def __init__(self, in_ch=128, skip_ch=64, dtype=None, num_flows=3):
        super().__init__()
        self.num_flows = num_flows
        self.upsample = upsample_head(in_ch, 2, dtype)
        cin = in_ch + 2 * (in_ch // 2) + 2 * 2 + 1 + 4 * 3
        self.convblock = conv_block(cin, 2 * in_ch, skip_ch, 8 * num_flows, 3, dtype)

    def forward(self, ft_, f0, f1, flow0, flow1, mask, img0, img1):
        n = self.num_flows
        flow0, flow1 = 4.0 * resize(flow0, 4.0), 4.0 * resize(flow1, 4.0)
        ft_, mask = resize(ft_, 4.0), resize(mask, 4.0)
        f0w, w0 = warp_with_image(f0, img0, flow0)
        f1w, w1 = warp_with_image(f1, img1, flow1)
        out = self.convblock(torch.cat([ft_, f0w, f1w, flow0, flow1, mask, img0, img1, w0, w1],
                                       dim=1)).float()
        d_flow0, d_flow1, d_mask, img_res = torch.split(out, [2 * n, 2 * n, n, 3 * n], dim=1)
        mask = torch.sigmoid(d_mask + mask.float().repeat(1, n, 1, 1))
        return d_flow0 + flow0.repeat(1, n, 1, 1), d_flow1 + flow1.repeat(1, n, 1, 1), mask, img_res


def comb_block(dtype=None, n=3) -> nn.Sequential:
    return nn.Sequential(conv(3 * n, 6 * n, 7, 1, 3, dtype), PReLU(6 * n),
                         conv(6 * n, 3, 7, 1, 3, dtype))


def multi_flow_combine(comb, img0, img1, flow0, flow1, mask, img_res, dtype=None):
    n, ck, h, w = flow0.shape
    k = ck // 2
    if dtype is not None:
        img0, img1 = img0.to(dtype), img1.to(dtype)
    m = mask.reshape(n * k, 1, h, w)
    w0 = warp(img0.repeat_interleave(k, dim=0), flow0.reshape(n * k, 2, h, w))
    w1 = warp(img1.repeat_interleave(k, dim=0), flow1.reshape(n * k, 2, h, w))
    img_warps = (m * w0 + (1 - m) * w1 + img_res.reshape(n * k, 3, h, w)).view(n, k, 3, h, w)
    res_corr = comb(img_warps.reshape(n, k * 3, h, w)).float()
    return (img_warps.mean(dim=1) + res_corr + 1.0) / 2.0


# ---------------------------------------------------------------------- GIMM
def motion_encoder(dtype=None) -> nn.Sequential:
    return nn.Sequential(conv(2, 16, 3, 1, 1, dtype), conv(16, 32, 3, 1, 1, dtype),
                         nn.LeakyReLU(0.1), LateralBlock(32, dtype), LateralBlock(32, dtype),
                         LateralBlock(32, dtype), nn.LeakyReLU(0.1),
                         conv(32, 16, 3, 1, 1, dtype, padding_mode="reflect"))


def latent_refiner(dtype=None) -> nn.Sequential:
    return nn.Sequential(conv(64, 32, 3, 1, 1, dtype), conv(32, 64, 3, 1, 1, dtype),
                         nn.LeakyReLU(0.1), LateralBlock(64, dtype), nn.LeakyReLU(0.1),
                         conv(64, 32, 3, 1, 1, dtype, padding_mode="reflect"))


def splatting_weights(flow01, flow10, alpha_v, alpha_fe):
    flows = torch.cat([flow01, flow10], dim=0)
    blurred = gaussian_blur3x3(torch.cat([flows**2, flows], dim=1))
    var = torch.sqrt(torch.clamp_min(blurred[:, :2] - blurred[:, 2:] ** 2, 1e-9)).mean(1, keepdim=True)
    n = flow01.shape[0]
    err01 = (-warp(flow10, flow01) - flow01).abs().mean(1, keepdim=True)
    err10 = (-warp(flow01, flow10) - flow10).abs().mean(1, keepdim=True)
    a_v, a_fe = alpha_v.view(1, 1, 1, 1), alpha_fe.view(1, 1, 1, 1)
    w1 = 1.0 / (1.0 + err01 * a_fe) + 1.0 / (1.0 + var[:n] * a_v)
    w2 = 1.0 / (1.0 + err10 * a_fe) + 1.0 / (1.0 + var[n:] * a_v)
    return w1, w2


def splat_nchw(x, flow, metric):
    out = softsplat_linear_zeroeps(x.permute(0, 2, 3, 1), flow.permute(0, 2, 3, 1),
                                   metric.permute(0, 2, 3, 1))
    return out.permute(0, 3, 1, 2)


class HypoNet(nn.Module):
    """SIREN MLP over (t, y, x) and the 32-channel latent: 5 layers of 128,
    each weight column L2-normalized, the last row of each matrix its bias;
    its matmuls in `dtype` (float32 if None)."""

    def __init__(self, dtype=None):
        super().__init__()
        self.dtype = dtype
        shapes, fan_in = [], 3 + 32 + 1
        for _ in range(4):
            shapes.append((fan_in, 128))
            fan_in = 129
        shapes.append((fan_in, 2))
        self.params_dict = nn.ParameterDict(
            {f"linear_wb{i}": nn.Parameter(torch.zeros(s)) for i, s in enumerate(shapes)})

    def forward(self, coord, pixel_latent):
        b, t_dim, h, w, _ = coord.shape
        lat = resize_bilinear(pixel_latent.float(), (h, w)).permute(0, 2, 3, 1)
        lat = lat[:, None].expand(b, t_dim, h, w, lat.shape[-1])
        hidden = torch.cat([lat.reshape(b, -1, lat.shape[-1]),
                            coord.float().reshape(b, -1, coord.shape[-1])], dim=-1)
        dt = self.dtype or torch.float32
        n_layer = len(self.params_dict)
        for i in range(n_layer):
            wb = self.params_dict[f"linear_wb{i}"]
            wgt = wb[:-1] / torch.clamp_min(torch.linalg.vector_norm(wb[:-1], dim=0, keepdim=True),
                                            1e-12)
            hidden = torch.matmul(hidden.to(dt), wgt.to(dt)).float() + wb[-1:]
            if i < n_layer - 1:
                hidden = torch.sin(hidden)
        return (hidden + 0.5).reshape(b, t_dim, h, w, 2)


# --------------------------------------------------------------------- model
class GIMMVFI(nn.Module):
    """GIMM-VFI with `flow` "raft" (R: RAFT of `iters` iterations and three
    1x1 projections) or "flowformer" (F: FlowFormer of `iters`)."""

    def __init__(self, flow: str, iters: int, precision: Precision = Precision(),
                 stated: Precision | None = None, max_volume_bytes: int = 2 << 30):
        super().__init__()
        dt = precision.compute
        stated = stated or precision
        self.dtype, self.flow = dt, flow
        self.max_volume_bytes = max_volume_bytes
        # the AMT's volume is over RAFT's projected map (compute dtype) or FlowFormer's own
        self.amt_esize = esize(stated.compute if flow == "raft" else stated.flow)
        if flow == "raft":
            self.flow_estimator = RAFT(iters, dt, max_volume_bytes, esize(stated.compute))
            self.amt_last_cproj = conv(128, 256, 1, 1, 0, dt)
            self.amt_second_last_cproj = conv(96, 128, 1, 1, 0, dt)
            self.amt_fproj = conv(256, 256, 1, 1, 0, dt)
        else:
            self.flow_estimator = FlowFormer(iters, autocast_dtype=precision.flow)
        self.amt_init_decoder = InitDecoder(256, 64, dt)
        self.amt_final_decoder = MultiFlowDecoder(128, 64, dt, 3)
        self.amt_update4_low = UpdateBlock(2.0, dt, 2 * 4 * 81)
        self.amt_update4_high = UpdateBlock(None, dt, 2 * 4 * 81)
        self.amt_comb_block = comb_block(dt, 3)
        self.cnn_encoder = motion_encoder(dt)
        self.res_conv = latent_refiner(dt)
        self.hyponet = HypoNet(precision.hyponet)
        self.alpha_v = nn.Parameter(torch.ones(1))
        self.alpha_fe = nn.Parameter(torch.ones(1))

    def _amt_corr(self, fa, fb):
        """Both directions' pyramids: one volume and its transpose, or two
        windowed states (the route at the stated precision)."""
        n, _, h1, w1 = fa.shape
        if 2 * n * (h1 * w1) ** 2 * self.amt_esize * 4 // 3 <= self.max_volume_bytes:
            corr = all_pairs_corr(fa, fb)
            corr_t = corr.reshape(n, h1 * w1, h1 * w1).transpose(1, 2).reshape(n, h1 * w1, h1, w1)
            return pool_levels(corr, 4), pool_levels(corr_t, 4)
        return windowed_corr_pyramid(fa, fb, 4), windowed_corr_pyramid(fb, fa, 4)

    @torch.no_grad()
    def prepare(self, img_xs, ds_factor=None) -> dict:
        """img_xs (N, 2, H, W, 3) in [0, 1]."""
        img0 = img_xs[:, 0].permute(0, 3, 1, 2).float()
        img1 = img_xs[:, 1].permute(0, 3, 1, 2).float()
        full_img = None
        if ds_factor is not None and ds_factor != 1:
            full_img = (img0, img1)
            img0, img1 = resize(img0, ds_factor), resize(img1, ds_factor)
        n = img0.shape[0]
        if self.flow == "raft":
            flow_2n, feats, fnet = self.flow_estimator(255.0 * img0, 255.0 * img1)
            corr = self._amt_corr(self.amt_fproj(fnet[:n]), self.amt_fproj(fnet[n:]))
            feats = [self.amt_second_last_cproj(feats[0]), self.amt_last_cproj(feats[1])]
        else:
            flow_2n, feats, fnet = self.flow_estimator(255.0 * img0, 255.0 * img1, bidir=True)
            corr = self._amt_corr(fnet[:n], fnet[n:])
        f01, f10 = flow_2n[:n], flow_2n[n:]
        nflows, scalers = normalize_flow(torch.stack([f01, -f10], dim=1))
        u8 = self.amt_init_decoder.upsample(feats[1])
        u4 = self.amt_final_decoder.upsample(feats[0])
        w1, w2 = splatting_weights(f01, f10, self.alpha_v, self.alpha_fe)
        latents = self.cnn_encoder(torch.cat([nflows[:, 0], nflows[:, 1]], dim=0))
        return {"img0": img0, "img1": img1, "full_img": full_img, "scalers": scalers,
                "flow01": f01, "flow10": f10, "w1": w1, "w2": w2,
                "latent0": latents[:n], "latent1": latents[n:], "corr": corr,
                "f8_up": (u8[:n], u8[n:]), "f4_up": (u4[:n], u4[n:])}

    @torch.no_grad()
    def decode_one(self, prep: dict, tv: float) -> dict:
        """One timestep: imgt_pred (N, H', W', 3) at full resolution, flowt
        (N, h, w, 2) at the working size."""
        img0, img1 = 2.0 * prep["img0"] - 1.0, 2.0 * prep["img1"] - 1.0
        n, _, h, w = img0.shape
        dev = img0.device
        t = torch.full((n, 1, 1, 1), float(tv), dtype=torch.float32, device=dev)
        fused = torch.cat([splat_nchw(prep["latent0"], prep["flow01"] * t, prep["w1"]),
                           splat_nchw(prep["latent1"], prep["flow10"] * (1.0 - t), prep["w2"])],
                          dim=1)
        latent = fused + self.res_conv(torch.cat([prep["latent0"], prep["latent1"], fused], dim=1))
        ninr = self.hyponet(sample_coords_3d(n, (h, w), tv, dev), latent)
        flow_t = unnormalize_flow(ninr, prep["scalers"])[:, 0]
        imgt = self.synthesize(img0, img1, flow_t.permute(0, 3, 1, 2), prep, t)
        return {"imgt_pred": imgt.permute(0, 2, 3, 1), "flowt": flow_t}

    def synthesize(self, img0, img1, flow_t, prep, cur_t):
        n, _, h, w = img0.shape
        coord = coords_grid(n, h // 8, w // 8, img0.device)
        ft0 = 0.25 * resize(flow_t * (-cur_t), 0.25)
        ft1 = 0.25 * resize(flow_t * (1.0 - cur_t), 0.25)
        ft0, ft1, ft_ = self.amt_init_decoder(prep["f8_up"][0], prep["f8_up"][1], ft0, ft1,
                                              img0, img1)
        mask, ft_ = ft_[:, :1], ft_[:, 1:]
        lo0, lo1 = 0.5 * resize(ft0, 0.5), 0.5 * resize(ft1, 0.5)
        fwd, bwd = prep["corr"]
        corr = torch.cat([lookup(fwd, coord + lo1 * (1.0 / (1.0 - cur_t)), 4),
                          lookup(bwd, coord + lo0 * (1.0 / cur_t), 4)], dim=1)
        d_ft, d_flow = self.amt_update4_low(ft_, torch.cat([lo0, lo1], dim=1), corr)
        ft0, ft1, ft_ = ft0 + d_flow[:, :2], ft1 + d_flow[:, 2:4], ft_ + d_ft
        d_ft, d_flow = self.amt_update4_high(ft_, torch.cat([ft0, ft1], dim=1), resize(corr, 2.0))
        ft0, ft1, ft_ = ft0 + d_flow[:, :2], ft1 + d_flow[:, 2:4], ft_ + d_ft
        f0, f1, m, res = self.amt_final_decoder(ft_, prep["f4_up"][0], prep["f4_up"][1], ft0, ft1,
                                                mask, img0, img1)
        if prep["full_img"] is not None:
            img0, img1 = 2.0 * prep["full_img"][0] - 1.0, 2.0 * prep["full_img"][1] - 1.0
            s = img1.shape[2] / f0.shape[2]
            f0, f1, m, res = s * resize(f0, s), s * resize(f1, s), resize(m, s), resize(res, s)
        out = multi_flow_combine(self.amt_comb_block, img0, img1, f0, f1, m, res, self.dtype)
        return torch.clamp(out, 0.0, 1.0)


@torch.no_grad()
def interpolate_padded(model: GIMMVFI, img0: np.ndarray, img1: np.ndarray, ts, ds_factor):
    """The video entry's per-pair path: two (H, W, 3) float32 frames,
    edge-padded to a multiple of 32 on the model's device, one `prepare`
    and a `decode_one` a timestep (DS_SCALE unless `ds_factor` is None or
    1), unpadded. Returns numpy (frames (T, H, W, 3), flows (T, h, w, 2)),
    the flows at the working size cut by the same padder."""
    dev = model.alpha_v.device
    padder = InputPadder(img0.shape[:2], 32)
    pair = torch.from_numpy(np.stack([img0, img1])).to(dev).permute(0, 3, 1, 2)
    xs = padder.pad(pair).permute(0, 2, 3, 1)[None]
    prep = model.prepare(xs, None if ds_factor in (None, 1.0) else ds_factor)
    frames, flows = [], []
    for tv in ts:
        out = model.decode_one(prep, tv)
        frames.append(padder.unpad(out["imgt_pred"][0].permute(2, 0, 1)).permute(1, 2, 0))
        flows.append(padder.unpad(out["flowt"][0].permute(2, 0, 1)).permute(1, 2, 0))
    return torch.stack(frames).cpu().numpy(), torch.stack(flows).cpu().numpy()
