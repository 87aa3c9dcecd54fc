"""GIMM: the stage-1 generalizable implicit motion model, flow only
(`gimmvfi_tpu/models/gimm.py`), inference.

It encodes two normalized flows, forward-splats the latents to time t
(the splat kernel, twice a timestep), fuses them with a residual refiner
and decodes the flow at (t, y, x) with the SIREN HypoNet. The splat is
`fwarp_type` ("linear", every config's, or "softmax") with zero-eps
normalisation; another type raises at construction. Parameter names
follow the reference GIMM state dict; float32.

Entry points take channels-last flows like the reference and return
channels-last outputs; internals are NCHW.

`remat` (JAX's field, off by default as there; the train CLI and the
training tool turn it on as JAX's do): the motion encoder and the latent
refiner are remat units (`nn/layers.py: remat_call`), recomputed in the
backward; the HypoNet is not. The state dict is the same either way.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..nn.layers import remat_call
from ..ops.coords import sample_coords_3d, sample_coords_3d_per_sample
from .gimm_core import (
    check_fwarp_type,
    latent_refiner,
    motion_encoder,
    splat_fuse_latents,
    splatting_weights,
)
from .hyponet import HypoNet


class GIMM(nn.Module):
    """Built on `device`, the CUDA card when None; the CPU only when asked
    (`device="cpu"`, as the CPU tests do). Without a card the default
    raises. Inputs are moved to the model's device."""

    def __init__(self, coord_range: tuple[float, float] = (-1.0, 1.0), device=None,
                 fwarp_type: str = "linear", remat: bool = False):
        super().__init__()
        self.coord_range = tuple(coord_range)
        self.remat = remat
        self.fwarp_type = check_fwarp_type(fwarp_type)
        self.cnn_encoder = motion_encoder()
        self.res_conv = latent_refiner()
        self.hyponet = HypoNet()
        self.alpha_v = nn.Parameter(torch.ones(1))
        self.alpha_fe = nn.Parameter(torch.ones(1))
        self.to(torch.device("cuda") if device is None else torch.device(device))

    def _encode(self, xs: torch.Tensor, ori_flow: torch.Tensor):
        """The t-invariant work: NCHW flows, both latents (one encoder pass
        over the two) and the splatting weights."""
        dev = self.alpha_v.device
        xs, ori_flow = xs.to(dev).float(), ori_flow.to(dev).float()
        n = xs.shape[0]
        flow01 = ori_flow[:, 0].permute(0, 3, 1, 2)
        flow10 = ori_flow[:, 1].permute(0, 3, 1, 2)
        w1, w2 = splatting_weights(flow01, flow10, self.alpha_v, self.alpha_fe)
        latents = remat_call(self.cnn_encoder,
                             torch.cat([xs[:, 0], xs[:, 1]], dim=0).permute(0, 3, 1, 2),
                             remat=self.remat)
        return latents[:n], latents[n:], flow01, flow10, w1, w2

    def forward(self, xs: torch.Tensor, ori_flow: torch.Tensor, t: torch.Tensor,
                coord: torch.Tensor | None = None) -> torch.Tensor:
        """xs (N, 2, H, W, 2): flows normalized to [0, 1]; ori_flow (N, 2, H,
        W, 2): the raw flows 0->1 and 1->0; t (N,) timesteps. `coord` (N, T,
        H, W, 3), the (t, y, x) points to decode, goes to the HypoNet as it
        is; None decodes every pixel at t.

        Returns the normalized flow at t, (N, T, H, W, 2) (T = 1 without
        `coord`)."""
        n, _, h, w, _ = xs.shape
        latent0, latent1, flow01, flow10, w1, w2 = self._encode(xs, ori_flow)
        t = torch.as_tensor(t, dtype=torch.float32, device=latent0.device).reshape(n)
        pixel_latent = splat_fuse_latents(self.res_conv, latent0, latent1, flow01, flow10,
                                          w1, w2, t, self.fwarp_type, self.remat)
        if coord is None:
            coord = sample_coords_3d_per_sample(t, (h, w), self.coord_range)
        return self.hyponet(coord.to(t.device), pixel_latent)

    @torch.inference_mode()
    def forward_multi(self, xs: torch.Tensor, ori_flow: torch.Tensor,
                      ts: Sequence[float]) -> torch.Tensor:
        """M timesteps shared across the batch: the encoder and the splatting
        weights once, then one splat + decode per t, one at a time.

        Returns (N, M, H, W, 2) normalized flows."""
        n, _, h, w, _ = xs.shape
        latent0, latent1, flow01, flow10, w1, w2 = self._encode(xs, ori_flow)
        base = sample_coords_3d(n, (h, w), 1.0, latent0.device, self.coord_range)
        outs = []
        for tv in ts:
            t = torch.full((n,), float(tv), dtype=torch.float32, device=latent0.device)
            pixel_latent = splat_fuse_latents(self.res_conv, latent0, latent1, flow01, flow10,
                                              w1, w2, t, self.fwarp_type)
            coord = torch.cat([base[..., :1] * t.view(n, 1, 1, 1, 1), base[..., 1:]], dim=-1)
            outs.append(self.hyponet(coord, pixel_latent)[:, 0])
        return torch.stack(outs, dim=1)


def gimm_loss(preds: torch.Tensor, targets: torch.Tensor) -> dict[str, torch.Tensor]:
    """MSE and PSNR on normalized flows, per sample then averaged."""
    n = preds.shape[0]
    mse = ((preds - targets) ** 2).reshape(n, -1).mean(dim=-1)
    return {"loss_total": mse.mean(), "mse": mse.mean(), "psnr": (-10.0 * torch.log10(mse)).mean()}
