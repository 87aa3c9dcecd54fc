"""Vimeo-Triplet-Flow dataset, stage-1 GIMM motion pretraining
(`gimmvfi_tpu/data/flow_dataset.py`), numpy.

The reference's `src/datasets/flow_dataset.py` (`fast_vimeo_flow`): loads three
precomputed FlowFormer .flo fields per triplet, all aligned to one motion
direction (im1->im3, composed middle, -(im3->im1)), random 256^2 crop, and
per-sample max-abs normalization of the *endpoint* flows to [0, 1].
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .frame_io import read_flo


@dataclass
class VimeoFlowTriplets:
    path: str
    split: str = "train"
    crop: int = 256

    def __post_init__(self):
        self.flow_root = os.path.join(self.path, "flow_sequences")
        listing = os.path.join(
            self.path, "tri_trainlist.txt" if self.split != "test" else "tri_testlist.txt"
        )
        with open(listing) as f:
            items = [x for x in f.read().splitlines() if x.strip()]
        self.meta_data = items

    def __len__(self):
        return len(self.meta_data)

    def __getitem__(self, args):
        index, rng = args if isinstance(args, tuple) else (args, np.random.default_rng())
        d = os.path.join(self.flow_root, self.meta_data[index])
        # all flows aligned to one direction (`flow_dataset.py:80-90`)
        f0 = read_flo(os.path.join(d, "im1_im3.flo"))
        fm = read_flo(os.path.join(d, "im2_im3.flo")) - read_flo(
            os.path.join(d, "im2_im1.flo")
        )
        f1 = -read_flo(os.path.join(d, "im3_im1.flo"))

        if "train" in self.split:
            h, w = f0.shape[:2]
            y = rng.integers(0, h - self.crop + 1)
            x = rng.integers(0, w - self.crop + 1)
            f0, fm, f1 = (f[y : y + self.crop, x : x + self.crop] for f in (f0, fm, f1))

        flows = np.stack([f0, fm, f1], axis=0).astype(np.float32)  # (3, H, W, 2)
        # normalize by max-abs over the two *endpoint* flows (`:100-109`)
        scaler = np.abs(flows[[0, 2]]).max()
        nflows = (flows / scaler + 1.0) / 2.0
        return {
            "xs": nflows,  # (3, H, W, 2) in [0, 1]: [f01, f_mid, f10_aligned]
            "flow_scaler": np.float32(scaler),
            # raw (f01, f10) pair for splatting weights: second entry is
            # -f1 = im3->im1 direction (`flow_dataset.py:118-124`)
            "ori_flows": np.stack([flows[0], -flows[2]], axis=0),
        }
