"""Softmax/linear/avg/sum forward splatting (`gimmvfi_tpu/ops/softsplat.py`).

Each source pixel (i, j) adds `value * weight` into the four destination
pixels around (j + u, i + v) with bilinear weights. The `avg`, `linear` and
`softmax` modes append a weight channel and divide by it under one of three
epsilon policies (`-addeps`, `-zeroeps`, `-clipeps`).

The sum core `splat_sum` is the hand-written CUDA kernel
`csrc/softsplat.cu` for CUDA tensors, and `splat_sum_plain`, four masked
`index_add_` calls, for CPU tensors. There is no fallback between them: a
CUDA tensor launches the kernel or raises. The mode prologue and epilogue
are plain torch around the core.

Layout: channels last, as in the reference. `ten_in` (N, H, W, C), `flow`
(N, H, W, 2), `metric` (N, H, W, 1). Inference only: there is no backward.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.kernel_build import build_library

_EPS = 1e-7


class SplatKernel:
    """The CUDA splat kernel: built at first use, with a launch counter."""

    name = "softsplat_sum"
    source = "gimmvfi_tpu_torch/csrc/softsplat.cu"
    replaces = "gimmvfi_tpu/ops/splat_pallas.py:136"

    def __init__(self):
        self.launches = 0
        self._fn = None

    def build(self) -> str:
        """Build (or load from the cache) the library; returns the ptxas log."""
        lib, log = build_library("softsplat.cu")
        fn = lib.softsplat_sum_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self._fn = fn
        return log

    def __call__(self, vals: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        n, h, w, c = vals.shape
        if vals.dtype != torch.float32 or flow.dtype != torch.float32:
            raise TypeError(f"splat kernel takes float32, got {vals.dtype}, {flow.dtype}")
        if flow.shape != (n, h, w, 2) or flow.device != vals.device:
            raise ValueError(
                f"flow {tuple(flow.shape)} on {flow.device} does not match "
                f"vals {tuple(vals.shape)} on {vals.device}"
            )
        if not (vals.is_contiguous() and flow.is_contiguous()):
            raise ValueError("splat kernel takes contiguous (N, H, W, C) tensors")
        if torch.is_grad_enabled() and (vals.requires_grad or flow.requires_grad):
            raise NotImplementedError("the splat kernel has no backward yet")
        if self._fn is None:
            self.build()
        out = torch.zeros_like(vals)
        with torch.cuda.device(vals.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = self._fn(vals.data_ptr(), flow.data_ptr(), out.data_ptr(),
                           n, h, w, c, stream)
        if err != 0:
            raise RuntimeError(f"softsplat_sum_f32 launch failed: cudaError {err}")
        self.launches += 1
        return out


SPLAT_KERNEL = SplatKernel()


def splat_geometry(flow: torch.Tensor):
    """Integer base corners, bilinear weight factors and per-corner in-bounds
    masks of the splat positions (`splat_pallas.py:150-175`, float32).

    Positions are clamped to [-2, size] before the integer conversion, which
    keeps every in-bounds decision and avoids overflow far off the frame.
    """
    n, h, w, _ = flow.shape
    f32 = torch.float32
    jj = torch.arange(w, dtype=f32, device=flow.device).view(1, 1, w)
    ii = torch.arange(h, dtype=f32, device=flow.device).view(1, h, 1)
    x = jj + flow[..., 0].float()
    y = ii + flow[..., 1].float()
    finite = torch.isfinite(x) & torch.isfinite(y)
    x = torch.where(finite, x, -10.0)
    y = torch.where(finite, y, -10.0)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx1 = x - x0f
    wy1 = y - y0f
    ix0 = x0f.clamp(-2, w).to(torch.int64)
    iy0 = y0f.clamp(-2, h).to(torch.int64)
    corners = []
    for dx, dy, wgt in (
        (0, 0, (1.0 - wx1) * (1.0 - wy1)),
        (1, 0, wx1 * (1.0 - wy1)),
        (0, 1, (1.0 - wx1) * wy1),
        (1, 1, wx1 * wy1),
    ):
        ix, iy = ix0 + dx, iy0 + dy
        ok = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        corners.append((ix, iy, wgt, ok))
    return corners


def splat_sum_plain(vals: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Plain torch sum core: four masked `index_add_` calls, float32.

    vals (N, H, W, C) float32, flow (N, H, W, 2) -> (N, H, W, C) float32.
    Out-of-frame corners go to a dump row that is cut off at the end.
    """
    n, h, w, c = vals.shape
    p = n * h * w
    flat = vals.reshape(p, c).float()
    img = torch.arange(n, device=vals.device).view(n, 1, 1) * (h * w)
    out = torch.zeros(p + 1, c, dtype=torch.float32, device=vals.device)
    for ix, iy, wgt, ok in splat_geometry(flow):
        idx = torch.where(ok, img + iy * w + ix, p).reshape(p)
        out.index_add_(0, idx, flat * wgt.reshape(p, 1))
    return out[:p].reshape(n, h, w, c)


def splat_sum(vals: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Sum-mode splat core: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors, an error for anything else."""
    if vals.is_cuda:
        return SPLAT_KERNEL(vals, flow)
    if vals.device.type == "cpu":
        return splat_sum_plain(vals, flow)
    raise NotImplementedError(f"no splat core for device {vals.device}")


def softsplat(
    ten_in: torch.Tensor,
    flow: torch.Tensor,
    metric: torch.Tensor | None,
    mode: str,
) -> torch.Tensor:
    """Forward-splat with mode/eps handling.

    mode: "sum" | "avg" | "linear[-eps]" | "softmax[-eps]", eps one of
    "addeps" (default), "zeroeps", "clipeps". Returns ten_in's dtype
    promoted with metric's, like the reference.
    """
    base, _, eps_policy = mode.partition("-")
    if base not in ("sum", "avg", "linear", "softmax"):
        raise ValueError(f"unknown splat mode: {mode}")
    if (metric is None) != (base in ("sum", "avg")):
        raise ValueError(f"mode {mode} {'needs' if metric is None else 'takes no'} metric")

    if base == "avg":
        ten_in = torch.cat([ten_in, torch.ones_like(ten_in[..., :1])], dim=-1)
    elif base == "linear":
        ten_in = torch.cat([ten_in * metric, metric], dim=-1)
    elif base == "softmax":
        m = torch.exp(metric)
        ten_in = torch.cat([ten_in * m, m], dim=-1)

    out = splat_sum(ten_in.float().contiguous(), flow.float().contiguous())
    out = out.to(ten_in.dtype)
    if base == "sum":
        return out

    norm = out[..., -1:]
    eps_policy = eps_policy or "addeps"
    if eps_policy == "addeps":
        norm = norm + _EPS
    elif eps_policy == "zeroeps":
        norm = torch.where(norm == 0.0, 1.0, norm)
    elif eps_policy == "clipeps":
        norm = torch.clamp_min(norm, _EPS)
    else:
        raise ValueError(f"unknown eps policy: {mode}")
    return out[..., :-1] / norm
