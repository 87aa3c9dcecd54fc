"""GIMM-VFI-F inference: FlowFormer flow + GIMM motion INR + AMT synthesis
(`gimmvfi_tpu/models/gimmvfi_f.py`).

A GIMMVFI_R whose flow stack differs: FlowFormer (`ff_iters` decoder
iterations) in place of RAFT, and no 1x1 projections. The Twins context
features [128 ch at 1/4, 256 ch at 1/8] go to the AMT as they are, and the
bidirectional correlation pyramid is built over FlowFormer's float32
feature map itself; above `corr_max_volume_bytes` (the 720p pair's 2.3 GB
is) that is the float32 windowed state. FlowFormer computes in float32
under any `dtype`. Every entry point (`prepare`, `decode_one`,
`interpolate`, `interpolate_sequential`) is inherited.
"""

from __future__ import annotations

import torch

from ..flow.flowformer import FlowFormer
from ..ops import corr as corr_ops
from ..ops.coords import normalize_flow
from .gimmvfi_r import GIMMVFI_R


class GIMMVFI_F(GIMMVFI_R):
    def __init__(self, ff_iters=32, dtype=None, device=None,
                 corr_max_volume_bytes=corr_ops.MAX_VOLUME_BYTES):
        super().__init__(ff_iters, dtype, device, corr_max_volume_bytes)

    def _setup_flow_estimator(self, iters, device):
        self.flow_estimator = FlowFormer(iters, device=device)

    def bidir_flow(self, img0, img1):
        return self.flow_estimator(img0, img1, bidir=True)

    def cal_bidirection_flow(self, img0, img1):
        """Bidirectional FlowFormer in one batched pass, the unprojected
        features and the bidirectional pyramid over the raw feature map.
        img0/img1 (N, 3, H, W) in [0, 255]."""
        n = img0.shape[0]
        flow_2n, feats_2n, fnet_2n = self.bidir_flow(img0, img1)
        f01, f10 = flow_2n[:n], flow_2n[n:]
        corr_pyrs = corr_ops.bidir_corr_pyramid_auto(
            fnet_2n[:n], fnet_2n[n:], max_volume_bytes=self.corr_max_volume_bytes)
        nflows, scalers = normalize_flow(torch.stack([f01, -f10], dim=1))
        return nflows, f01, f10, scalers, list(feats_2n), corr_pyrs
