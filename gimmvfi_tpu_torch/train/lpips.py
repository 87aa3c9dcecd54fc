"""LPIPS perceptual metric, AlexNet backbone with linear heads
(`gimmvfi_tpu/train/lpips.py`), NCHW.

AlexNet feature slices (relu1..relu5), each feature unit-L2 normalized over
channels, squared differences, bias-free 1x1 linear heads, the spatial
mean, summed over the five layers. The benchmark harnesses report it beside
PSNR; `calc_lpips` quantizes both images to 8 bits first, as the reference
metric does.

Module and parameter names follow the reference LPIPS state dict
(`net.slice<s>.<i>`, `lin<k>.model.1`), so its weights load with
`utils/convert.py: load_reference_state_dict`. They are not in the repo.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.convert import LPIPS_SLICES

# ScalingLayer constants
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
# AlexNet's five convs: conv index -> (in, out, kernel, stride, padding)
_ALEX_CONVS = {0: (3, 64, 11, 4, 2), 3: (64, 192, 5, 1, 2), 6: (192, 384, 3, 1, 1),
               8: (384, 256, 3, 1, 1), 10: (256, 256, 3, 1, 1)}


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet `.features` cut at every ReLU the metric taps:
    slice 1 conv0; slices 2 and 3 a 3x3/2 max pool then conv3, conv6;
    slices 4 and 5 conv8, conv10; each conv followed by its ReLU.

    Returns [relu1 (64 ch), relu2 (192), relu3 (384), relu4 (256), relu5 (256)].
    """

    def __init__(self):
        super().__init__()
        for slice_idx, conv_idx in LPIPS_SLICES:
            layers = OrderedDict()
            if slice_idx in (2, 3):
                layers[str(conv_idx - 1)] = nn.MaxPool2d(3, 2)
            layers[str(conv_idx)] = nn.Conv2d(*_ALEX_CONVS[conv_idx])
            layers[str(conv_idx + 1)] = nn.ReLU()
            setattr(self, f"slice{slice_idx}", nn.Sequential(layers))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        outs = []
        for slice_idx, _ in LPIPS_SLICES:
            x = getattr(self, f"slice{slice_idx}")(x)
            outs.append(x)
        return outs


class _LinearHead(nn.Module):
    """The reference's NetLinLayer: (dropout, bias-free 1x1 conv) with the
    conv at `model.1`; dropout is the identity at inference."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


def _normalize_channels(feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Unit L2 over channels, eps added to the norm."""
    return feat / (torch.sqrt(torch.sum(feat**2, dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """Perceptual distance of NCHW images in [-1, 1] (or [0, 1] with
    `normalize=True`); returns (N, 1, 1, 1). Built on `device`, the card
    when None; the CPU only when asked."""

    def __init__(self, device=None):
        super().__init__()
        self.net = AlexNetFeatures()
        for k, (_, conv_idx) in enumerate(LPIPS_SLICES):
            setattr(self, f"lin{k}", _LinearHead(_ALEX_CONVS[conv_idx][1]))
        self.to(torch.device("cuda") if device is None else torch.device(device))

    def forward(self, in0: torch.Tensor, in1: torch.Tensor, normalize: bool = False) -> torch.Tensor:
        if normalize:  # [0, 1] -> [-1, 1]
            in0 = 2.0 * in0 - 1.0
            in1 = 2.0 * in1 - 1.0
        shift = torch.tensor(_SHIFT, dtype=torch.float32, device=in0.device).view(1, 3, 1, 1)
        scale = torch.tensor(_SCALE, dtype=torch.float32, device=in0.device).view(1, 3, 1, 1)
        outs0 = self.net((in0 - shift) / scale)
        outs1 = self.net((in1 - shift) / scale)
        total = 0.0
        for k, (f0, f1) in enumerate(zip(outs0, outs1)):
            d = (_normalize_channels(f0) - _normalize_channels(f1)) ** 2
            total = total + getattr(self, f"lin{k}")(d).mean(dim=(2, 3), keepdim=True)
        return total


@torch.inference_mode()
def calc_lpips(model: LPIPS, gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """The benchmark metric: both images quantized to 8 bits first. gt and
    pred channels-last (N, H, W, 3) in [0, 1], moved to the model's device;
    returns (N, 1, 1, 1)."""
    dev = next(model.parameters()).device

    def quantize(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev).permute(0, 3, 1, 2)
        return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0) / 255.0

    return model(quantize(gt), quantize(pred), normalize=True)
