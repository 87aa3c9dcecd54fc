"""Vimeo septuplet arbitrary-timestep dataset, stage-2 GIMM-VFI training
(`gimmvfi_tpu/data/vimeo_arb.py`, the reference's `src/datasets/vimeo_arb.py`).

An item samples 3 sorted frames of a septuplet, t = (i1 - i0) / (i2 - i0);
the train augmentation is a random 2x resize (p = 0.1), the 224^2 crop,
channel reverse, time reverse, vertical and horizontal flips and a
transpose (without `aug`: the crop, the flips and a 90-degree rotation).
The test split reads `vimeo_triplet/tri_testlist.txt` beside the septuplet
tree. The draws come from the item's `np.random.Generator` in the JAX
package's order, so items are its items bit for bit. Channels-last numpy;
batching is `data/loader.py`'s.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .frame_io import read_image


@dataclass
class VimeoArbitrary:
    """split: "train" | "test". Returns dict(img0, img1, gt, t)."""

    path: str
    split: str = "train"
    aug: bool = True
    crop_size: tuple[int, int] = (224, 224)

    def __post_init__(self):
        self.image_root = os.path.join(self.path, "sequences")
        if self.split != "test":
            listing = os.path.join(self.path, "all_sep.txt")
            self.frames_per_seq = 7
        else:
            self.path = self.path.replace("vimeo_septuplet", "vimeo_triplet")
            self.image_root = os.path.join(self.path, "sequences")
            listing = os.path.join(self.path, "tri_testlist.txt")
            self.frames_per_seq = 3
        with open(listing) as f:
            items = f.read().splitlines()
        if self.split == "test":
            items = items[:-1]
        self.meta_data = [x for x in items if x.strip()]

    def __len__(self):
        return len(self.meta_data)

    def _load_triplet(self, index: int, rng: np.random.Generator):
        seq = os.path.join(self.image_root, self.meta_data[index])
        idx = np.sort(rng.permutation(self.frames_per_seq)[:3])
        imgs = [read_image(os.path.join(seq, f"im{i + 1}.png")) for i in idx]
        t = float(idx[1] - idx[0]) / float(idx[2] - idx[0])
        return imgs[0], imgs[1], imgs[2], t

    def __getitem__(self, args):
        index, rng = args if isinstance(args, tuple) else (args, np.random.default_rng())
        img0, gt, img1, t = self._load_triplet(index, rng)

        if "train" in self.split and self.aug:
            img0, gt, img1, t = self._augment(img0, gt, img1, t, rng)
        elif "train" in self.split:
            img0, gt, img1, t = self._augment_noresize(img0, gt, img1, t, rng)

        return {
            "img0": np.ascontiguousarray(img0, np.float32),
            "img1": np.ascontiguousarray(img1, np.float32),
            "gt": np.ascontiguousarray(gt, np.float32),
            "t": np.float32(t),
        }

    # -- augmentation (`vimeo_arb.py:17-180`)
    def _augment(self, img0, gt, img1, t, rng):
        import cv2

        if rng.uniform() < 0.1:
            img0, gt, img1 = (
                cv2.resize(x, None, fx=2.0, fy=2.0, interpolation=cv2.INTER_LINEAR)
                for x in (img0, gt, img1)
            )
        img0, gt, img1 = self._crop(img0, gt, img1, rng)
        if rng.uniform() < 0.5:  # channel reverse
            img0, gt, img1 = (x[:, :, ::-1] for x in (img0, gt, img1))
        if rng.uniform() < 0.5:  # time reverse
            img0, img1, t = img1, img0, 1.0 - t
        if rng.uniform() < 0.3:  # vertical flip
            img0, gt, img1 = (x[::-1] for x in (img0, gt, img1))
        if rng.uniform() < 0.5:  # horizontal flip
            img0, gt, img1 = (x[:, ::-1] for x in (img0, gt, img1))
        if rng.uniform() < 0.05:  # rotate (transpose)
            img0, gt, img1 = (x.transpose(1, 0, 2) for x in (img0, gt, img1))
        return img0, gt, img1, t

    def _augment_noresize(self, img0, gt, img1, t, rng):
        import cv2

        img0, gt, img1 = self._crop(img0, gt, img1, rng)
        if rng.uniform() < 0.5:
            img0, gt, img1 = (x[:, :, ::-1] for x in (img0, gt, img1))
        if rng.uniform() < 0.5:
            img0, img1, t = img1, img0, 1.0 - t
        if rng.uniform() < 0.5:
            img0, gt, img1 = (x[::-1] for x in (img0, gt, img1))
        if rng.uniform() < 0.5:
            img0, gt, img1 = (x[:, ::-1] for x in (img0, gt, img1))
        p = rng.uniform()
        rots = [cv2.ROTATE_90_CLOCKWISE, cv2.ROTATE_180, cv2.ROTATE_90_COUNTERCLOCKWISE]
        if p < 0.75:
            rot = rots[int(p / 0.25)]
            img0, gt, img1 = (cv2.rotate(np.ascontiguousarray(x), rot) for x in (img0, gt, img1))
        return img0, gt, img1, t

    def _crop(self, img0, gt, img1, rng):
        ch, cw = self.crop_size
        ih, iw = img0.shape[:2]
        x = rng.integers(0, ih - ch + 1)
        y = rng.integers(0, iw - cw + 1)
        return (
            img0[x : x + ch, y : y + cw],
            gt[x : x + ch, y : y + cw],
            img1[x : x + ch, y : y + cw],
        )
