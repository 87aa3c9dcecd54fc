"""Input padding to a divisor of the flow/synthesis pyramid
(`gimmvfi_tpu/ops/pad.py`), on NCHW tensors.

"sintel" mode splits the pad between both sides of H and W; any other
mode pads W on both sides and H at the bottom only. Every inference entry
point pads to a multiple of 32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class InputPadder:
    """Pads tensors whose last two dims are (H, W), e.g. NCHW images, so
    that H and W divide by `divisor`, replicating the edge (as
    `jnp.pad(mode="edge")` does).

    `dims` is the unpadded shape, (..., H, W) or just (H, W). `bucket` >
    divisor rounds the padded size up to a multiple of `bucket` instead,
    so that mixed-size sets share padded sizes.
    """

    def __init__(self, dims, divisor: int = 8, mode: str = "sintel", bucket: int | None = None):
        self.ht, self.wd = (int(d) for d in tuple(dims)[-2:])
        d = max(divisor, bucket or 0)
        pad_ht = (d - self.ht % d) % d
        pad_wd = (d - self.wd % d) % d
        if mode == "sintel":
            # (left, right, top, bottom)
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, pad_ht // 2, pad_ht - pad_ht // 2]
        else:
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht]

    @property
    def padded_hw(self) -> tuple[int, int]:
        l, r, t, b = self._pad
        return self.ht + t + b, self.wd + l + r

    def pad(self, *inputs: torch.Tensor):
        """Edge-pad each input's last two dims, (..., C, H, W) with at least
        three dims; one tensor in, one out, else a list."""
        outs = []
        for x in inputs:
            flat = x.reshape(-1, *x.shape[-3:])
            out = F.pad(flat, self._pad, mode="replicate")
            outs.append(out.reshape(*x.shape[:-2], *out.shape[-2:]))
        return outs if len(outs) > 1 else outs[0]

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        """Cut the pad off the last two dims, (..., H, W)."""
        l, r, t, b = self._pad
        ht, wd = x.shape[-2:]
        return x[..., t : ht - b, l : wd - r]


def pad_reflect(x: torch.Tensor, pad: int = 1) -> torch.Tensor:
    """Reflect-pad H and W of an NCHW tensor."""
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")
