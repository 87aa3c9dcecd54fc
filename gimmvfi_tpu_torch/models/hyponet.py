"""HypoNet: the coordinate SIREN MLP that decodes flow at (t, y, x)
(`gimmvfi_tpu/models/hyponet.py`), without modulations.

Each layer's parameter is one (fan_in + 1, fan_out) matrix whose last row
is the bias (`params_dict.linear_wb<i>`), with weight columns L2-normalized
over fan_in. Everything here is float32 in both compute modes.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import sine
from ..ops.interp import resize_bilinear


class HypoNet(nn.Module):
    output_bias = 0.5
    output_dim = 2

    def __init__(self):
        super().__init__()
        n_layer, hidden_dim = 5, 128
        shapes = []
        fan_in = 3 + 32 + 1  # (t, y, x) + 32 latent channels + the bias row
        for _ in range(n_layer - 1):
            shapes.append((fan_in, hidden_dim))
            fan_in = hidden_dim + 1
        shapes.append((fan_in, self.output_dim))
        self.params_dict = nn.ParameterDict(
            {f"linear_wb{i}": nn.Parameter(torch.zeros(s)) for i, s in enumerate(shapes)}
        )
        self.siren_init_()

    @torch.no_grad()
    def siren_init_(self):
        """The reference's SIREN initialization (`modules/utils.py:37-62`,
        as `gimmvfi_tpu/models/hyponet.py: _make_param`): weights uniform in
        +-1/fan_in on the first layer and +-sqrt(6/fan_in) after it, the
        bias row with a fan_in of 1; from torch's global generator."""
        for i, wb in enumerate(self.params_dict.values()):
            fan_in = wb.shape[0] - 1
            bound_w = 1.0 / fan_in if i == 0 else (6.0 / fan_in) ** 0.5
            bound_b = 1.0 if i == 0 else 6.0 ** 0.5
            wb[:-1].uniform_(-bound_w, bound_w)
            wb[-1:].uniform_(-bound_b, bound_b)

    def forward(self, coord: torch.Tensor, pixel_latent: torch.Tensor,
                sub_idx: torch.Tensor | None = None) -> torch.Tensor:
        """coord (B, T, H, W, D) float32; pixel_latent (B, L, h, w).

        Returns (B, T, H, W, output_dim), or with `sub_idx`, (B, K) indices
        into the flattened (T*H*W) points, (B, K, output_dim): the points are
        gathered before the MLP (the training loss's subsample).
        """
        b, t_dim, h, w, _ = coord.shape
        lat = resize_bilinear(pixel_latent.float(), (h, w)).permute(0, 2, 3, 1)
        lat = lat[:, None].expand(b, t_dim, h, w, lat.shape[-1])
        hidden = torch.cat(
            [lat.reshape(b, -1, lat.shape[-1]), coord.float().reshape(b, -1, coord.shape[-1])],
            dim=-1,
        )
        if sub_idx is not None:
            idx = sub_idx.to(device=hidden.device, dtype=torch.long)
            hidden = torch.gather(hidden, 1, idx[..., None].expand(*idx.shape, hidden.shape[-1]))
        n_layer = len(self.params_dict)
        for idx in range(n_layer):
            wb = self.params_dict[f"linear_wb{idx}"]
            param_w, param_b = wb[:-1], wb[-1:]
            param_w = param_w / torch.clamp_min(
                torch.linalg.vector_norm(param_w, dim=0, keepdim=True), 1e-12
            )
            hidden = torch.matmul(hidden, param_w) + param_b
            if idx < n_layer - 1:
                hidden = sine(hidden)
        out = hidden + self.output_bias
        if sub_idx is not None:
            return out
        return out.reshape(b, t_dim, h, w, self.output_dim)
