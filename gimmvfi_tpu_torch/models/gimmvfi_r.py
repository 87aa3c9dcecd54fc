"""GIMM-VFI-R inference: RAFT flow + GIMM motion INR + AMT synthesis
(`gimmvfi_tpu/models/gimmvfi_r.py`).

`prepare` runs once per frame pair (flow, features, correlation pyramid,
motion latents, splat weights, t-invariant decoder heads); `decode_one`
runs once per timestep (latent splat, HypoNet flow, synthesis).
`interpolate_sequential` is the 8x entry point: one `prepare`, then a
Python loop of `decode_one`.

DS_SCALE (`ds_factor`, the reference's 2K/4K operating points): `prepare`
downsizes the pair by `ds_factor` and keeps the full-resolution frames;
every stage runs at the working size, and only the final flows, masks and
residuals are upsampled for the full-resolution blend. `imgt_pred` comes
back at full resolution, `flowt` at the working size.

Entry points take `img_xs` (N, 2, H, W, 3) in [0, 1], channels-last like
the reference, and return channels-last outputs; internals are NCHW.
Parameter names follow the reference GIMM-VFI-R state dict.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..flow.raft import RAFT
from ..nn.layers import conv
from ..ops import corr as corr_ops
from ..ops.coords import coords_grid, normalize_flow, sample_coords_3d, unnormalize_flow
from ..ops.interp import resize, warp
from .gimm_core import latent_refiner, motion_encoder, splat_fuse_latents, splatting_weights
from .hyponet import HypoNet
from .synthesis import InitDecoder, MultiFlowDecoder, UpdateBlock, comb_block, multi_flow_combine


class GIMMVFI_R(nn.Module):
    """dtype None computes in float32; torch.bfloat16 runs convolutions and
    correlation volumes in bf16 while flow/coordinate state, the HypoNet,
    normalization statistics, splatting and bilinear weights stay float32.

    The model is built on `device`, the CUDA card when None; the CPU only
    when asked (`device="cpu"`, as the CPU tests do). Without a card the
    default raises. Outputs stay on the model's device.

    Above `corr_max_volume_bytes` RAFT and the AMT pyramid use the windowed
    correlation instead of a materialized volume (each decides on its own
    volume's size); the setting holds no parameter."""

    def __init__(self, raft_iters=20, dtype=None, device=None,
                 corr_max_volume_bytes=corr_ops.MAX_VOLUME_BYTES):
        super().__init__()
        device = torch.device("cuda") if device is None else torch.device(device)
        self.dtype = dtype
        self.corr_max_volume_bytes = corr_max_volume_bytes
        f0, f1 = 256, 128
        skip = f1 // 2
        self._setup_flow_estimator(raft_iters, device)
        self.amt_init_decoder = InitDecoder(f0, skip, dtype)
        self.amt_final_decoder = MultiFlowDecoder(f1, skip, dtype)
        self.amt_update4_low = UpdateBlock(scale_factor=2.0, dtype=dtype)
        self.amt_update4_high = UpdateBlock(scale_factor=None, dtype=dtype)
        self.amt_comb_block = comb_block(dtype)
        self.cnn_encoder = motion_encoder(dtype)
        self.res_conv = latent_refiner(dtype)
        self.hyponet = HypoNet()
        self.alpha_v = nn.Parameter(torch.ones(1))
        self.alpha_fe = nn.Parameter(torch.ones(1))
        self.to(device)

    # ------------------------------------------------------------------ flow
    def _setup_flow_estimator(self, iters, device):
        """RAFT and the three 1x1 projections R adds on top of it; GIMMVFI_F
        overrides this."""
        dt = self.dtype
        self.flow_estimator = RAFT(iters, dtype=dt, device=device,
                                   corr_max_volume_bytes=self.corr_max_volume_bytes)
        self.amt_last_cproj = conv(128, 256, 1, 1, 0, dt)
        self.amt_second_last_cproj = conv(96, 128, 1, 1, 0, dt)
        self.amt_fproj = conv(256, 256, 1, 1, 0, dt)

    def bidir_flow(self, img0, img1):
        """The flow estimator alone, both directions in one batched pass:
        (flow_up, [feature 1/4, feature 1/8], feature map), forward in rows
        :N, backward in rows N:. img0/img1 (N, 3, H, W) in [0, 255]."""
        return self.flow_estimator(img0, img1)

    def cal_bidirection_flow(self, img0, img1):
        """Batched bidirectional RAFT, AMT features and the bidirectional
        correlation pyramid. img0/img1 (N, 3, H, W) in [0, 255]."""
        n = img0.shape[0]
        flow_2n, feats_2n, fnet_2n = self.bidir_flow(img0, img1)
        f01, f10 = flow_2n[:n], flow_2n[n:]
        corr_pyrs = corr_ops.bidir_corr_pyramid_auto(
            self.amt_fproj(fnet_2n[:n]), self.amt_fproj(fnet_2n[n:]),
            max_volume_bytes=self.corr_max_volume_bytes,
        )
        features = [self.amt_second_last_cproj(feats_2n[0]), self.amt_last_cproj(feats_2n[1])]
        nflows, scalers = normalize_flow(torch.stack([f01, -f10], dim=1))
        return nflows, f01, f10, scalers, features, corr_pyrs

    # ------------------------------------------------------------ synthesis
    def _corr_scale_lookup(self, corr_pyrs, coord, flow0, flow1, embt):
        """t-rescaled bidirectional correlation lookup of 1/4-scale flows,
        halved to the volume's 1/8 scale."""
        flow0 = 0.5 * resize(flow0, 0.5)
        flow1 = 0.5 * resize(flow1, 0.5)
        corr0, corr1 = corr_ops.bidir_corr_lookup(
            corr_pyrs, coord + flow1 * (1.0 / (1.0 - embt)), coord + flow0 * (1.0 / embt)
        )
        return torch.cat([corr0, corr1], dim=1), torch.cat([flow0, flow1], dim=1)

    def warp_w_mask(self, img0, img1, ft0, ft1, mask, scale=1):
        """Masked dual warp (the aux 1/4-scale prediction). With a compute
        dtype the image payload is warped in it."""
        if self.dtype is not None:
            img0 = img0.to(self.dtype)
            img1 = img1.to(self.dtype)
        ft0 = scale * resize(ft0, scale)
        ft1 = scale * resize(ft1, scale)
        mask = torch.sigmoid(resize(mask, scale))
        return mask * warp(img0, ft0) + (1 - mask) * warp(img1, ft1)

    def frame_synthesize(self, img0, img1, flow_t, f8_up, f4_up, corr_pyrs, cur_t,
                         full_img=None):
        """AMT coarse-to-fine synthesis. img0/img1 (N, 3, H, W) in [-1, 1];
        flow_t (N, 2, H, W); cur_t (N, 1, 1, 1). With `full_img`, the
        full-resolution pair (N, 3, H', W') in [0, 1], the final flows
        (scaled by H'/H), masks and residuals are resized by H'/H and the
        blend runs on the full-resolution frames."""
        n, _, h, w = img0.shape
        lookup_coord = coords_grid(n, h // 8, w // 8, img0.device)
        flow_t0_4 = 0.25 * resize(flow_t * (-cur_t), 0.25)
        flow_t1_4 = 0.25 * resize(flow_t * (1.0 - cur_t), 0.25)

        # ---- scale 1/4
        flowt0_4, flowt1_4, ft_4_ = self.amt_init_decoder(
            f8_up[0], f8_up[1], flow_t0_4, flow_t1_4, img0, img1
        )
        mask_4_, ft_4_ = ft_4_[:, :1], ft_4_[:, 1:]
        img_warp_4 = self.warp_w_mask(img0, img1, flowt0_4, flowt1_4, mask_4_, scale=4)
        img_warp_4 = torch.clamp((img_warp_4 + 1.0) / 2.0, 0.0, 1.0)

        corr_4, flow_4_lr = self._corr_scale_lookup(
            corr_pyrs, lookup_coord, flowt0_4, flowt1_4, cur_t
        )
        d_ft, d_flow = self.amt_update4_low(ft_4_, flow_4_lr, corr_4)
        flowt0_4 = flowt0_4 + d_flow[:, :2]
        flowt1_4 = flowt1_4 + d_flow[:, 2:4]
        ft_4_ = ft_4_ + d_ft

        corr_4 = resize(corr_4, 2.0)
        d_ft, d_flow = self.amt_update4_high(
            ft_4_, torch.cat([flowt0_4, flowt1_4], dim=1), corr_4
        )
        flowt0_4 = flowt0_4 + d_flow[:, :2]
        flowt1_4 = flowt1_4 + d_flow[:, 2:4]
        ft_4_ = ft_4_ + d_ft

        # ---- scale 1/1
        flowt0_1, flowt1_1, mask, img_res = self.amt_final_decoder(
            ft_4_, f4_up[0], f4_up[1], flowt0_4, flowt1_4, mask_4_, img0, img1
        )
        if full_img is not None:
            img0 = 2.0 * full_img[0] - 1.0
            img1 = 2.0 * full_img[1] - 1.0
            inv = img1.shape[2] / flowt0_1.shape[2]
            flowt0_1 = inv * resize(flowt0_1, inv)
            flowt1_1 = inv * resize(flowt1_1, inv)
            mask = resize(mask, inv)
            img_res = resize(img_res, inv)
        imgt_pred = multi_flow_combine(
            self.amt_comb_block, img0, img1, flowt0_1, flowt1_1, mask, img_res, self.dtype
        )
        return {
            "imgt_pred": torch.clamp(imgt_pred, 0.0, 1.0),
            "flowt0_pred": [flowt0_1, flowt0_4],
            "flowt1_pred": [flowt1_1, flowt1_4],
            "img_warp_4": img_warp_4,
        }

    # ----------------------------------------------------------- entry points
    def prepare(self, img_xs: torch.Tensor, ds_factor: float | None = None) -> dict:
        """Everything t-independent, once per pair. img_xs (N, 2, H, W, 3),
        moved to the model's device (frames loaded on the host run there).
        With `ds_factor` (not None or 1) the pair is resized by it and the
        full-resolution frames are kept as `full_img`."""
        img_xs = img_xs.to(self.alpha_v.device)
        img0 = img_xs[:, 0].permute(0, 3, 1, 2).float()
        img1 = img_xs[:, 1].permute(0, 3, 1, 2).float()
        full_img = None
        if ds_factor is not None and ds_factor != 1:
            full_img = (img0, img1)
            img0, img1 = resize(img0, ds_factor), resize(img1, ds_factor)
        nflows, f01, f10, scalers, features, corr_pyrs = self.cal_bidirection_flow(
            255.0 * img0, 255.0 * img1
        )
        n = img0.shape[0]
        w1, w2 = splatting_weights(f01, f10, self.alpha_v, self.alpha_fe)
        latents = self.cnn_encoder(torch.cat([nflows[:, 0], nflows[:, 1]], dim=0))
        u8 = self.amt_init_decoder.upsample_features(features[1])
        u4 = self.amt_final_decoder.upsample_features(features[0])
        return {
            "img0": img0, "img1": img1, "nflows": nflows, "scalers": scalers,
            "flow01": f01, "flow10": f10, "w1": w1, "w2": w2,
            "latent0": latents[:n], "latent1": latents[n:],
            "f8_up": (u8[:n], u8[n:]), "f4_up": (u4[:n], u4[n:]),
            "corr_pyrs": corr_pyrs, "full_img": full_img,
        }

    def decode_one(self, prep: dict, tv: float) -> dict:
        """One timestep: splat the latents to t, decode the flow with the
        HypoNet, synthesize. Outputs are channels-last: imgt_pred
        (N, H, W, 3) at full resolution, flowt (N, h, w, 2) and ninrflow
        (N, 1, h, w, 2) at the working size."""
        img0, img1 = prep["img0"], prep["img1"]
        n, _, h, w = img0.shape
        dev = img0.device
        t = torch.full((n,), float(tv), dtype=torch.float32, device=dev)
        coord = sample_coords_3d(n, (h, w), tv, dev)
        pixel_latent = splat_fuse_latents(
            self.res_conv, prep["latent0"], prep["latent1"], prep["flow01"],
            prep["flow10"], prep["w1"], prep["w2"], t,
        )
        ninr = self.hyponet(coord, pixel_latent)
        flow_t = unnormalize_flow(ninr, prep["scalers"])[:, 0]  # (N, H, W, 2)
        out = self.frame_synthesize(
            2.0 * img0 - 1.0, 2.0 * img1 - 1.0, flow_t.permute(0, 3, 1, 2),
            prep["f8_up"], prep["f4_up"], prep["corr_pyrs"], t.view(n, 1, 1, 1),
            full_img=prep["full_img"],
        )
        out["imgt_pred"] = out["imgt_pred"].permute(0, 2, 3, 1)
        out["flowt"] = flow_t
        out["ninrflow"] = ninr
        return out

    @torch.inference_mode()
    def interpolate(self, img_xs: torch.Tensor, t_values: Sequence[float],
                    ds_factor: float | None = None) -> dict:
        """Interpolate at shared timesteps; per-timestep lists of outputs."""
        prep = self.prepare(img_xs, ds_factor)
        outs = [self.decode_one(prep, tv) for tv in t_values]
        return {
            "imgt_pred": [o["imgt_pred"] for o in outs],
            "flowt": [o["flowt"] for o in outs],
            "ninrflow": [o["ninrflow"] for o in outs],
            "nflow": prep["nflows"],
            "raft_flow": torch.stack([prep["flow01"], prep["flow10"]], dim=1),
        }


@torch.inference_mode()
def interpolate_sequential(model: GIMMVFI_R, img_xs: torch.Tensor,
                           t_values: Sequence[float], ds_factor: float | None = None) -> dict:
    """Nx interpolation: one `prepare`, then one `decode_one` per timestep,
    keeping only the outputs. Returns {imgt_pred: (T, N, H, W, 3),
    flowt: (T, N, h, w, 2)}, (h, w) the working size."""
    prep = model.prepare(img_xs, ds_factor)
    imgs, flows = [], []
    for tv in t_values:
        out = model.decode_one(prep, tv)
        imgs.append(out["imgt_pred"])
        flows.append(out["flowt"])
    return {"imgt_pred": torch.stack(imgs), "flowt": torch.stack(flows)}
