"""GIMM-VFI-R: RAFT flow + GIMM motion INR + AMT synthesis
(`gimmvfi_tpu/models/gimmvfi_r.py`).

`prepare` runs once per frame pair (flow, features, correlation pyramid,
motion latents, splat weights, t-invariant decoder heads); `decode_one`
runs once per timestep (latent splat, HypoNet flow, synthesis).
`interpolate_sequential` is the 8x entry point: one `prepare`, then a
Python loop of `decode_one`.

`prepare_sharded` is `prepare` with the flow estimator split by width over
the ranks of a process group (`RAFT.forward_sharded`, or FlowFormer's in
GIMMVFI_F); `parallel/spatial.py` calls it.

`decode_one` is `decode_strip` over the whole width: three stages,
`flow_strip` (both latent splats on the whole frame, the latent refiner
on a window, the HypoNet on a strip of it), `synthesize_quarter` (the AMT
at 1/8 and 1/4 scale on the whole frame) and `synthesize_strip` (the
MultiFlowDecoder, the DS upsample and the combine on a window, cropped to
a strip). `parallel/spatial.py` runs `decode_strip` on a strip a rank.

`train_forward` is stage-2 training's forward: with `train=True` RAFT runs
once a direction and the decoder heads once a direction, so that
BatchNorm takes each direction's batch statistics, as the reference's
separate calls do; the HypoNet decodes the flow at t = 0 and t = 1 on
subsampled points (the reconstruction loss) and at each sample's t on
every pixel (the synthesis). Inference always uses the running statistics.

DS_SCALE (`ds_factor`, the reference's 2K/4K operating points): `prepare`
downsizes the pair by `ds_factor` and keeps the full-resolution frames;
every stage runs at the working size, and only the final flows, masks and
residuals are upsampled for the full-resolution blend. `imgt_pred` comes
back at full resolution, `flowt` at the working size.

`remat` (JAX's field, on by default as there; the inference entry points
turn it off as JAX's do): under grad the motion encoder, the latent
refiner, the HypoNet, both decoders (each call, the upsample heads' too)
and both update blocks are remat units (`nn/layers.py: remat_call`),
and inside the decoders each upsample head and ResBlock too, as JAX's
`nn.remat` wraps them. None of them launches a hand kernel: the splat
and the correlation lookups run outside them. The state dict is the same
either way, and so are the outputs, the loss and the gradients.

Entry points take `img_xs` (N, 2, H, W, 3) in [0, 1], channels-last like
the reference, and return channels-last outputs; internals are NCHW.
Parameter names follow the reference GIMM-VFI-R state dict.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.profiler import record_function

from ..flow.raft import RAFT
from ..nn.layers import conv, remat_call
from ..ops import corr as corr_ops
from ..ops.coords import (
    coords_grid,
    normalize_flow,
    sample_coords_3d,
    sample_coords_3d_per_sample,
    unnormalize_flow,
)
from ..ops.interp import resize, warp
from ..parallel import dist as dist_ops
from ..parallel.spatial import strip_bounds
from .gimm_core import (
    check_fwarp_type,
    latent_refiner,
    motion_encoder,
    refine_latents,
    splat_fuse_latents,
    splat_latents,
    splatting_weights,
)
from .hyponet import HypoNet
from .synthesis import (
    NUM_FLOWS,
    InitDecoder,
    MultiFlowDecoder,
    UpdateBlock,
    comb_block,
    multi_flow_combine,
)


class GIMMVFI_R(nn.Module):
    """dtype None computes in float32; torch.bfloat16 runs convolutions and
    correlation volumes in bf16 while flow/coordinate state, the HypoNet,
    normalization statistics, splatting and bilinear weights stay float32.

    The model is built on `device`, the CUDA card when None; the CPU only
    when asked (`device="cpu"`, as the CPU tests do). Without a card the
    default raises. Outputs stay on the model's device.

    Above `corr_max_volume_bytes` RAFT and the AMT pyramid use the windowed
    correlation instead of a materialized volume (each decides on its own
    volume's size); the setting holds no parameter.

    JAX's fields, with its defaults: `num_flows` flow pairs that the
    MultiFlowDecoder predicts and the combine blends; `fwarp_type`, the
    latent splat's mode ("linear" or "softmax", with zero-eps
    normalisation; another raises here); `corr_radius`, the AMT's lookups
    (RAFT keeps its own 4) and the width of the update blocks that read
    them (on the card a windowed lookup past radius 4 takes the kernels'
    general case); `coord_range`, the HypoNet's coordinate span; `remat`,
    the training backward's activation recomputation (module docstring)."""

    def __init__(self, raft_iters=20, dtype=None, device=None,
                 corr_max_volume_bytes=corr_ops.MAX_VOLUME_BYTES, num_flows=NUM_FLOWS,
                 fwarp_type="linear", corr_radius=4, coord_range=(-1.0, 1.0), remat=True):
        super().__init__()
        self.remat = remat
        device = torch.device("cuda") if device is None else torch.device(device)
        self.dtype = dtype
        self.corr_max_volume_bytes = corr_max_volume_bytes
        self.num_flows = num_flows
        self.fwarp_type = check_fwarp_type(fwarp_type)
        self.corr_radius = corr_radius
        self.coord_range = tuple(coord_range)
        f0, f1 = 256, 128
        skip = f1 // 2
        self._setup_flow_estimator(raft_iters, device)
        corr_planes = 2 * 4 * (2 * corr_radius + 1) ** 2  # both directions, the AMT's 4 levels
        self.amt_init_decoder = InitDecoder(f0, skip, dtype, remat)
        self.amt_final_decoder = MultiFlowDecoder(f1, skip, dtype, num_flows, remat)
        self.amt_update4_low = UpdateBlock(2.0, dtype, corr_planes)
        self.amt_update4_high = UpdateBlock(None, dtype, corr_planes)
        self.amt_comb_block = comb_block(dtype, num_flows)
        self.cnn_encoder = motion_encoder(dtype)
        self.res_conv = latent_refiner(dtype)
        self.hyponet = HypoNet()
        self.alpha_v = nn.Parameter(torch.ones(1))
        self.alpha_fe = nn.Parameter(torch.ones(1))
        self.to(device)

    def _unit(self, fn, *args, **kwargs):
        """`fn(*args, **kwargs)`, a remat unit under `self.remat`."""
        return remat_call(fn, *args, remat=self.remat, **kwargs)

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

    def bidir_flow(self, img0, img1, train=False):
        """The flow estimator alone, both directions: (flow_up, [feature
        1/4, feature 1/8], feature map), forward in rows :N, backward in
        rows N:. img0/img1 (N, 3, H, W) in [0, 255]. One batched pass, or
        with `train` one call a direction (per-direction BatchNorm batch
        statistics, forward first)."""
        if not train:
            return self.flow_estimator(img0, img1)
        f01, feats0, fnet0 = self.flow_estimator(img0, img1, train=True, bidir=False)
        f10, feats1, fnet1 = self.flow_estimator(img1, img0, train=True, bidir=False)
        return (torch.cat([f01, f10], dim=0), [torch.cat(f, dim=0) for f in zip(feats0, feats1)],
                torch.cat([fnet0, fnet1], dim=0))

    def cal_bidirection_flow(self, img0, img1, train=False):
        """Bidirectional RAFT, AMT features (both directions' rows) and the
        bidirectional correlation pyramid. img0/img1 (N, 3, H, W) in [0, 255]."""
        return self.flow_state(*self.bidir_flow(img0, img1, train))

    def flow_state(self, flow_2n, feats_2n, fnet_2n):
        """The rest of `cal_bidirection_flow` from RAFT's results for both
        directions (`bidir_flow`): the 1x1 projections, the AMT's
        bidirectional correlation pyramid and the normalized flows."""
        n = flow_2n.shape[0] // 2
        f01, f10 = flow_2n[:n], flow_2n[n:]
        corr_pyrs = corr_ops.bidir_corr_pyramid_auto(
            self.amt_fproj(fnet_2n[:n]), self.amt_fproj(fnet_2n[n:]),
            max_volume_bytes=self.corr_max_volume_bytes,
        )
        features = [self.amt_second_last_cproj(feats_2n[0]), self.amt_last_cproj(feats_2n[1])]
        nflows, scalers = normalize_flow(torch.stack([f01, -f10], dim=1))
        return nflows, f01, f10, scalers, features, corr_pyrs

    # ------------------------------------------------------------------ INR
    def motion_latents(self, nflows, flow01, flow10) -> dict:
        """The t-invariant half of the GIMM decode: the splatting weights of
        the detached flows (N, 2, H, W) and both motion latents of the
        normalized flows (one encoder pass over the two)."""
        n = flow01.shape[0]
        flow01, flow10 = flow01.detach(), flow10.detach()
        w1, w2 = splatting_weights(flow01, flow10, self.alpha_v, self.alpha_fe)
        latents = self._unit(self.cnn_encoder, torch.cat([nflows[:, 0], nflows[:, 1]], dim=0))
        return {"flow01": flow01, "flow10": flow10, "w1": w1, "w2": w2,
                "latent0": latents[:n], "latent1": latents[n:]}

    def decode_flow(self, lat: dict, t, coord, sub_idx=None):
        """Splat both latents to t (N,), fuse them and decode the
        normalized flow at `coord` (N, T, h, w, 3) with the HypoNet:
        (N, T, h, w, 2), or (N, K, 2) at the (N, K) `sub_idx` points."""
        pixel_latent = splat_fuse_latents(
            self.res_conv, lat["latent0"], lat["latent1"], lat["flow01"], lat["flow10"],
            lat["w1"], lat["w2"], t, self.fwarp_type, self.remat,
        )
        return self._unit(self.hyponet, coord, pixel_latent, sub_idx)

    def flow_strip(self, prep: dict, tv: float, strip: tuple[int, int],
                   window: tuple[int, int]) -> tuple[torch.Tensor, torch.Tensor]:
        """A timestep's flow on the working columns `strip` (a, b): both
        latent splats on the whole frame, the refiner on the columns
        `window` (lo, hi), which holds the strip (exact on it when it
        reaches the refiner's receptive radius past each inner edge), the
        HypoNet at the strip's points of the whole frame's grid. Returns
        the flow (N, h, b - a, 2), channels-last, and the normalized INR
        flow (N, 1, h, b - a, 2)."""
        n, _, h, w = prep["img0"].shape
        dev = prep["img0"].device
        t = torch.full((n,), float(tv), dtype=torch.float32, device=dev)
        fused = splat_latents(prep["latent0"], prep["latent1"], prep["flow01"], prep["flow10"],
                              prep["w1"], prep["w2"], t, self.fwarp_type)
        (a, b), (lo, hi) = strip, window
        latent = refine_latents(self.res_conv, prep["latent0"], prep["latent1"], fused, lo, hi,
                                self.remat)
        ninr = self._unit(self.hyponet,
                          sample_coords_3d(n, (h, w), tv, dev, self.coord_range, cols=strip),
                          latent[..., a - lo:b - lo])
        return unnormalize_flow(ninr, prep["scalers"])[:, 0], ninr

    def predict_flow(self, nflows, flows, t, coord, sub_idx=None):
        """The GIMM motion decode at timesteps t (N,): nflows (N, 2, 2, H,
        W) normalized, flows (N, 2, 2, H, W) raw (detached here), coord
        (N, 1, h, w, 3). Returns (N, 1, h, w, 2), or (N, K, 2) with sub_idx."""
        return self.decode_flow(self.motion_latents(nflows, flows[:, 0], flows[:, 1]),
                                t, coord, sub_idx)

    def upsample_synth_features(self, features, train=False):
        """The decoders' t-invariant upsample heads on both directions'
        features (forward rows :N, backward N:): (f8_up pair, f4_up pair).
        One batched call each, or with `train` one a direction (per-direction
        BatchNorm batch statistics)."""
        def up8(f, train=False):
            return self._unit(self.amt_init_decoder.upsample_features, f, train)

        def up4(f, train=False):
            return self._unit(self.amt_final_decoder.upsample_features, f, train)

        n = features[0].shape[0] // 2
        if train:
            return ((up8(features[1][:n], True), up8(features[1][n:], True)),
                    (up4(features[0][:n], True), up4(features[0][n:], True)))
        u8, u4 = up8(features[1]), up4(features[0])
        return (u8[:n], u8[n:]), (u4[:n], u4[n:])

    # ------------------------------------------------------------ synthesis
    def _corr_scale_lookup(self, corr_pyrs, coord, flow0, flow1, embt):
        """t-rescaled bidirectional correlation lookup of 1/4-scale flows,
        halved to the volume's 1/8 scale."""
        flow0 = 0.5 * resize(flow0, 0.5)
        flow1 = 0.5 * resize(flow1, 0.5)
        corr0, corr1 = corr_ops.bidir_corr_lookup(
            corr_pyrs, coord + flow1 * (1.0 / (1.0 - embt)), coord + flow0 * (1.0 / embt),
            self.corr_radius,
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
        """AMT coarse-to-fine synthesis of the whole frame, with the aux
        1/4-scale prediction (`synthesize_quarter`, `warp_w_mask`,
        `synthesize_strip`). img0/img1 (N, 3, H, W) in [-1, 1]; flow_t (N,
        2, H, W); cur_t (N, 1, 1, 1); `full_img` as `synthesize_strip`.
        Returns imgt_pred and img_warp_4, NCHW."""
        q = self.synthesize_quarter(img0, img1, flow_t, f8_up, corr_pyrs, cur_t)
        img_warp_4 = self.warp_w_mask(img0, img1, *q["init"], scale=4)
        whole = (0, img0.shape[3])
        return {
            "imgt_pred": self.synthesize_strip(q, img0, img1, f4_up, whole, whole, full_img),
            "img_warp_4": torch.clamp((img_warp_4 + 1.0) / 2.0, 0.0, 1.0),
        }

    def synthesize_quarter(self, img0, img1, flow_t, f8_up, corr_pyrs, cur_t) -> dict:
        """The AMT's InitDecoder, correlation lookups and both UpdateBlocks
        at 1/8 and 1/4 scale, on the whole frame. img0/img1 (N, 3, H, W) in
        [-1, 1]; flow_t (N, 2, H, W); cur_t (N, 1, 1, 1). Returns the
        1/4-scale state the MultiFlowDecoder reads (`ft_4`, `flowt0_4`,
        `flowt1_4`, `mask_4`) and the InitDecoder's flows and mask
        (`init`, for the aux prediction)."""
        n, _, h, w = img0.shape
        lookup_coord = coords_grid(n, h // 8, w // 8, img0.device)
        flow_t0_4 = 0.25 * resize(flow_t * (-cur_t), 0.25)
        flow_t1_4 = 0.25 * resize(flow_t * (1.0 - cur_t), 0.25)

        # ---- scale 1/4
        flowt0_4, flowt1_4, ft_4_ = self._unit(
            self.amt_init_decoder, f8_up[0], f8_up[1], flow_t0_4, flow_t1_4, img0, img1
        )
        mask_4_, ft_4_ = ft_4_[:, :1], ft_4_[:, 1:]
        init = (flowt0_4, flowt1_4, mask_4_)

        corr_4, flow_4_lr = self._corr_scale_lookup(
            corr_pyrs, lookup_coord, flowt0_4, flowt1_4, cur_t
        )
        d_ft, d_flow = self._unit(self.amt_update4_low, ft_4_, flow_4_lr, corr_4)
        flowt0_4 = flowt0_4 + d_flow[:, :2]
        flowt1_4 = flowt1_4 + d_flow[:, 2:4]
        ft_4_ = ft_4_ + d_ft

        corr_4 = resize(corr_4, 2.0)
        d_ft, d_flow = self._unit(
            self.amt_update4_high, ft_4_, torch.cat([flowt0_4, flowt1_4], dim=1), corr_4
        )
        flowt0_4 = flowt0_4 + d_flow[:, :2]
        flowt1_4 = flowt1_4 + d_flow[:, 2:4]
        ft_4_ = ft_4_ + d_ft
        return {"ft_4": ft_4_, "flowt0_4": flowt0_4, "flowt1_4": flowt1_4, "mask_4": mask_4_,
                "init": init}

    def synthesize_strip(self, q: dict, img0, img1, f4_up, strip: tuple[int, int],
                         window: tuple[int, int], full_img=None) -> torch.Tensor:
        """The frame on the working columns `strip` (a, b): the
        MultiFlowDecoder on the columns `window` (lo, hi) of the 1/4-scale
        state `q` (`synthesize_quarter`), its warps reading the whole
        `f4_up` and img0/img1 (N, 3, H, W) in [-1, 1]; under DS the
        resize to full resolution; the combine, its warps reading the whole
        frames; cropped to the strip. lo and hi lie on the 1/4-scale grid
        (multiples of 4); the strip is exact when the window reaches the
        stage's receptive radius past each inner edge (`parallel/
        spatial.py`). With `full_img`, the full-resolution pair (N, 3, H',
        W') in [0, 1], the final flows (scaled by s = H'/H), masks and
        residuals are resized by s and the blend runs on the
        full-resolution frames. Returns (N, 3, H', (b - a) s) in [0, 1]."""
        (a, b), (lo, hi) = strip, window
        cols = slice(lo // 4, hi // 4)
        flowt0_1, flowt1_1, mask, img_res = self._unit(
            self.amt_final_decoder, q["ft_4"][..., cols], f4_up[0], f4_up[1],
            q["flowt0_4"][..., cols], q["flowt1_4"][..., cols], q["mask_4"][..., cols], img0, img1,
            x0=lo,
        )
        scale = 1
        if full_img is not None:
            img0 = 2.0 * full_img[0] - 1.0
            img1 = 2.0 * full_img[1] - 1.0
            scale = img1.shape[2] / flowt0_1.shape[2]
            flowt0_1 = scale * resize(flowt0_1, scale)
            flowt1_1 = scale * resize(flowt1_1, scale)
            mask = resize(mask, scale)
            img_res = resize(img_res, scale)
        x0 = round(lo * scale)
        imgt_pred = multi_flow_combine(
            self.amt_comb_block, img0, img1, flowt0_1, flowt1_1, mask, img_res, self.dtype, x0
        )
        return torch.clamp(imgt_pred[..., round(a * scale) - x0:round(b * scale) - x0], 0.0, 1.0)

    # ----------------------------------------------------------- entry points
    def prepare(self, img_xs: torch.Tensor, ds_factor: float | None = None) -> dict:
        """Everything t-independent, once per pair. img_xs (N, 2, H, W, 3),
        moved to the model's device (frames loaded on the host run there).
        With `ds_factor` (not None or 1) the pair is resized by it and the
        full-resolution frames are kept as `full_img`."""
        img0, img1, full_img = self._working_pair(img_xs, ds_factor)
        return self._prepared(img0, img1, full_img,
                              self.cal_bidirection_flow(255.0 * img0, 255.0 * img1))

    def prepare_sharded(self, img_xs: torch.Tensor, ds_factor: float | None = None,
                        group=None) -> dict:
        """`prepare` with the flow estimator split by width over the ranks
        of `group` (the default group if None; its `forward_sharded` on
        even strips of 1/8-scale columns, its results gathered whole); the
        DS resize before it and everything after it (`flow_state`, the
        motion latents, the decoder heads) run whole on every rank. Every rank passes the whole
        pair and gets `prepare`'s dict, equal to one process's up to float
        rounding. The working width must be a multiple of 8 and at least 8
        columns a rank. With no group up, `prepare`."""
        if not dist_ops.group_up():
            return self.prepare(img_xs, ds_factor)
        img0, img1, full_img = self._working_pair(img_xs, ds_factor)
        w8, world = img0.shape[3] // 8, dist.get_world_size(group)
        if img0.shape[3] % 8 or w8 < world:
            raise ValueError(f"a working width of {img0.shape[3]} does not split into {world} "
                             f"strips of 8-column units")
        flow = self.flow_estimator.forward_sharded(255.0 * img0, 255.0 * img1,
                                                   strip_bounds(w8, world, 1), group)
        return self._prepared(img0, img1, full_img, self.flow_state(*flow))

    def _working_pair(self, img_xs: torch.Tensor, ds_factor: float | None):
        """The pair NCHW on the model's device at the working size, and the
        full-resolution pair under DS (else None)."""
        img_xs = img_xs.to(self.alpha_v.device)
        img0 = img_xs[:, 0].permute(0, 3, 1, 2).float()
        img1 = img_xs[:, 1].permute(0, 3, 1, 2).float()
        full_img = None
        if ds_factor is not None and ds_factor != 1:
            full_img = (img0, img1)
            img0, img1 = resize(img0, ds_factor), resize(img1, ds_factor)
        return img0, img1, full_img

    def _prepared(self, img0, img1, full_img, flow_state) -> dict:
        """`prepare`'s dict from `cal_bidirection_flow`'s results."""
        nflows, f01, f10, scalers, features, corr_pyrs = flow_state
        f8_up, f4_up = self.upsample_synth_features(features)
        return {
            "img0": img0, "img1": img1, "nflows": nflows, "scalers": scalers,
            **self.motion_latents(nflows, f01, f10),
            "f8_up": f8_up, "f4_up": f4_up, "corr_pyrs": corr_pyrs, "full_img": full_img,
        }

    def decode_strip(self, prep: dict, tv: float, strip: tuple[int, int],
                     windows: tuple[tuple[int, int], tuple[int, int]], gather=None) -> dict:
        """One timestep on the working columns `strip`: `flow_strip` on
        the window `windows[0]`, the strip's flow made whole by `gather`
        (the ranks' all-reduce in `parallel/spatial.py`; None when the
        strip is the frame), `synthesize_quarter` on the whole frame,
        `synthesize_strip` on the window `windows[1]`. Outputs are
        channels-last: imgt_pred (N, H, (b - a) s, 3) at full resolution,
        flowt (N, h, w, 2), ninrflow (N, 1, h, b - a, 2)."""
        img0, img1 = 2.0 * prep["img0"] - 1.0, 2.0 * prep["img1"] - 1.0
        flow_t, ninr = self.flow_strip(prep, tv, strip, windows[0])
        if gather is not None:
            flow_t = gather(flow_t)
        n = img0.shape[0]
        cur_t = torch.full((n, 1, 1, 1), float(tv), dtype=torch.float32, device=img0.device)
        q = self.synthesize_quarter(img0, img1, flow_t.permute(0, 3, 1, 2), prep["f8_up"],
                                    prep["corr_pyrs"], cur_t)
        imgt = self.synthesize_strip(q, img0, img1, prep["f4_up"], strip, windows[1],
                                     prep["full_img"])
        return {"imgt_pred": imgt.permute(0, 2, 3, 1), "flowt": flow_t, "ninrflow": ninr}

    def decode_one(self, prep: dict, tv: float) -> dict:
        """One timestep: splat the latents to t, decode the flow with the
        HypoNet, synthesize (`decode_strip` over the whole width). Outputs
        are channels-last: imgt_pred (N, H, W, 3) at full resolution, flowt
        (N, h, w, 2) and ninrflow (N, 1, h, w, 2) at the working size."""
        whole = (0, prep["img0"].shape[3])
        return self.decode_strip(prep, tv, whole, (whole, whole))

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

    def train_forward(self, img_xs: torch.Tensor, t: torch.Tensor, sub_idx0: torch.Tensor,
                      sub_idx1: torch.Tensor, train: bool = True) -> dict:
        """Stage-2 training's forward (`trainer_gimmvfi.py:216-258`).

        img_xs (N, 2, H, W, 3) in [0, 1]; t (N,) per-sample timesteps,
        strictly inside (0, 1) (the synthesis divides by t and 1 - t);
        sub_idx0/1 (N, K) indices into the H*W pixels for the t = 0 / t = 1
        flow reconstruction. `train=True` takes BatchNorm batch statistics
        (and moves the running ones); `train=False`, the validation's, runs
        the batched inference flow on the running statistics.

        Returns channels-last tensors as the JAX package's: imgt_pred and
        img_warp_4 (N, H, W, 3), ninrflow [inr0, inr1] (N, K, 2) each,
        nflow and raft_flow (N, 2, H, W, 2), flowt (N, H, W, 2)."""
        dev = self.alpha_v.device
        img_xs = img_xs.to(dev)
        img0 = img_xs[:, 0].permute(0, 3, 1, 2).float()
        img1 = img_xs[:, 1].permute(0, 3, 1, 2).float()
        n, _, h, w = img0.shape
        t = torch.as_tensor(t, dtype=torch.float32, device=dev).reshape(n)
        nflows, f01, f10, scalers, features, corr_pyrs = self.cal_bidirection_flow(
            255.0 * img0, 255.0 * img1, train
        )
        lat = self.motion_latents(nflows, f01, f10)
        ones = torch.ones(n, dtype=torch.float32, device=dev)
        span = self.coord_range
        inr0 = self.decode_flow(lat, 0.0 * ones, sample_coords_3d(n, (h, w), 0.0, dev, span),
                                sub_idx0.to(dev))
        inr1 = self.decode_flow(lat, ones, sample_coords_3d(n, (h, w), 1.0, dev, span),
                                sub_idx1.to(dev))
        inr_t = self.decode_flow(lat, t, sample_coords_3d_per_sample(t, (h, w), span))
        flow_t = unnormalize_flow(inr_t, scalers)[:, 0]  # (N, H, W, 2)
        f8_up, f4_up = self.upsample_synth_features(features, train)
        out = self.frame_synthesize(
            2.0 * img0 - 1.0, 2.0 * img1 - 1.0, flow_t.permute(0, 3, 1, 2), f8_up, f4_up,
            corr_pyrs, t.view(n, 1, 1, 1),
        )
        return {
            "imgt_pred": out["imgt_pred"].permute(0, 2, 3, 1),
            "img_warp_4": out["img_warp_4"].permute(0, 2, 3, 1),
            "ninrflow": [inr0, inr1],
            "nflow": nflows.permute(0, 1, 3, 4, 2),
            "flowt": flow_t,
            "raft_flow": torch.stack([f01, f10], dim=1).permute(0, 1, 3, 4, 2),
        }


@torch.inference_mode()
def interpolate_sequential(model: GIMMVFI_R, img_xs: torch.Tensor,
                           t_values: Sequence[float], ds_factor: float | None = None) -> dict:
    """Nx interpolation: one `prepare`, then one `decode_one` per timestep,
    keeping only the outputs. Returns {imgt_pred: (T, N, H, W, 3),
    flowt: (T, N, h, w, 2)}, (h, w) the working size. Each stage sits in a
    `torch.profiler` span of its name (the bench's `--trace-dir`)."""
    with record_function("prepare"):
        prep = model.prepare(img_xs, ds_factor)
    imgs, flows = [], []
    for tv in t_values:
        with record_function("decode_one"):
            out = model.decode_one(prep, tv)
        imgs.append(out["imgt_pred"])
        flows.append(out["flowt"])
    return {"imgt_pred": torch.stack(imgs), "flowt": torch.stack(flows)}
