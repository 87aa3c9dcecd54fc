"""Softmax/linear/avg/sum forward splatting (`gimmvfi_tpu/ops/softsplat.py`).

Each source pixel (i, j) adds `value * weight` into the four destination
pixels around (j + u, i + v) with bilinear weights. The `avg`, `linear` and
`softmax` modes append a weight channel and divide by it under one of three
epsilon policies (`-addeps`, `-zeroeps`, `-clipeps`).

The sum core `splat_sum` is, for CUDA tensors, the autograd Function
`SplatSum` over two hand-written CUDA kernels: `csrc/softsplat_sorted.cu`
forward (destination-sorted, summed in a fixed order, bit-deterministic
as the JAX package's) and `csrc/softsplat_bwd.cu` backward (the JAX
package's gather-form VJP, `_splat_pallas_bwd`). For CPU tensors it is
`splat_sum_plain`, four masked `index_add_` calls that autograd
differentiates. There is no fallback between them: a CUDA tensor launches
the kernels or raises. The mode prologue and epilogue are plain torch
around the core. `splat_sum_sorted_plain` is the forward kernel's order in
plain torch, `splat_sum_backward_plain` the backward kernel's plain
version. `csrc/softsplat.cu`, the forward by float atomics (its sums in
an order that changes from call to call), is on no route; `chip_smoke.py`
times it beside the sorted kernel.

Layout: channels last, as in the reference. `ten_in` (N, H, W, C), `flow`
(N, H, W, 2), `metric` (N, H, W, 1).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..utils.kernel_build import CudaKernel, build_library

_EPS = 1e-7


class SplatKernel(CudaKernel):
    """The CUDA splat kernel by float atomics: built at first use, with a
    launch counter. On no route (`SortedSplatKernel` is the forward)."""

    def __init__(self):
        super().__init__(
            name="softsplat_sum",
            source="gimmvfi_tpu_torch/csrc/softsplat.cu",
            symbol="softsplat_sum_f32",
            argtypes=[ctypes.c_void_p] * 3 + [ctypes.c_int] * 4,
            replaces="gimmvfi_tpu/ops/splat_pallas.py:136",
        )

    def __call__(self, vals: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        if vals.dim() != 4:
            raise ValueError(f"splat kernel takes vals (N, H, W, C), got {tuple(vals.shape)}")
        if torch.is_grad_enabled() and (vals.requires_grad or flow.requires_grad):
            raise NotImplementedError(
                "the splat kernel's output has no graph: call splat_sum, whose SplatSum "
                "carries the backward kernel")
        n, h, w, c = vals.shape
        self.check(("vals", vals, torch.float32),
                   ("flow", flow, torch.float32, (n, h, w, 2), vals.device))
        if n * h * w >= 2**31 or not 1 <= c <= 2**22:
            raise ValueError(f"splat kernel takes N*H*W < 2**31 and 1 <= C <= 2**22, "
                             f"got {tuple(vals.shape)}")
        out = torch.zeros_like(vals)
        self.launch(vals.device, vals.data_ptr(), flow.data_ptr(), out.data_ptr(), n, h, w, c)
        return out


class SplatBackwardKernel(CudaKernel):
    """The CUDA backward of the sum-mode splat: built at first use, with a
    launch counter. Returns (d_vals, d_flow), d_flow None unless asked for."""

    def __init__(self):
        super().__init__(
            name="softsplat_sum_bwd",
            source="gimmvfi_tpu_torch/csrc/softsplat_bwd.cu",
            symbol="softsplat_sum_bwd_f32",
            argtypes=[ctypes.c_void_p] * 5 + [ctypes.c_int] * 4,
            replaces="gimmvfi_tpu/ops/softsplat.py:108",
        )

    def __call__(self, vals: torch.Tensor, flow: torch.Tensor, g: torch.Tensor,
                 need_flow: bool = True):
        if vals.dim() != 4:
            raise ValueError(f"splat backward takes vals (N, H, W, C), got {tuple(vals.shape)}")
        n, h, w, c = vals.shape
        self.check(("vals", vals, torch.float32),
                   ("flow", flow, torch.float32, (n, h, w, 2), vals.device),
                   ("g", g, torch.float32, (n, h, w, c), vals.device))
        if n * h * w >= 2**31 or not 1 <= c <= 2**22:
            raise ValueError(f"splat backward takes N*H*W < 2**31 and 1 <= C <= 2**22, "
                             f"got {tuple(vals.shape)}")
        d_vals = torch.empty_like(vals)
        d_flow = torch.empty_like(flow) if need_flow else None
        self.launch(vals.device, vals.data_ptr(), flow.data_ptr(), g.data_ptr(),
                    d_vals.data_ptr(), 0 if d_flow is None else d_flow.data_ptr(), n, h, w, c)
        return d_vals, d_flow


class SortedSplatKernel(CudaKernel):
    """The deterministic CUDA splat, `csrc/softsplat_sorted.cu`: the keys
    kernel, `torch.sort(stable=True)`, then the launcher of the tile-staged
    gather kernel, whose launches the counter counts (one a call). Built at
    first use."""

    def __init__(self):
        super().__init__(
            name="softsplat_sorted_sum",
            source="gimmvfi_tpu_torch/csrc/softsplat_sorted.cu",
            symbol="softsplat_sorted_sum_f32",
            argtypes=[ctypes.c_void_p] * 5 + [ctypes.c_int] * 4,
            replaces="gimmvfi_tpu/ops/splat_pallas.py:136",
        )
        self._keys_fn = None

    def build(self) -> str:
        log = super().build()
        fn = build_library(Path(self.source).name)[0].softsplat_sorted_keys
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self._keys_fn = fn
        return log

    def __call__(self, vals: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        if vals.dim() != 4:
            raise ValueError(f"splat kernel takes vals (N, H, W, C), got {tuple(vals.shape)}")
        if torch.is_grad_enabled() and (vals.requires_grad or flow.requires_grad):
            raise NotImplementedError(
                "the splat kernel's output has no graph: call splat_sum, whose SplatSum "
                "carries the backward kernel")
        n, h, w, c = vals.shape
        total = n * (h * w + 2 * (w + 1))
        if total >= 2**31 - 1 or not 1 <= c <= 2**22:
            raise ValueError(f"the sorted splat kernel takes N*(H*W + 2(W+1)) < 2**31 - 1 and "
                             f"1 <= C <= 2**22, got {tuple(vals.shape)}")
        self.check(("vals", vals, torch.float32),
                   ("flow", flow, torch.float32, (n, h, w, 2), vals.device))
        if self._fn is None:
            self.build()
        dev = vals.device
        npix = n * h * w
        keys = torch.empty(npix, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            err = self._keys_fn(flow.data_ptr(), keys.data_ptr(), n, h, w,
                                torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"softsplat_sorted_keys launch failed: cudaError {err}")
        keys, order = torch.sort(keys, stable=True)
        out = torch.empty_like(vals)
        self.launch(dev, vals.data_ptr(), flow.data_ptr(), keys.data_ptr(), order.data_ptr(),
                    out.data_ptr(), n, h, w, c)
        return out


SPLAT_KERNEL = SplatKernel()
SPLAT_SORTED_KERNEL = SortedSplatKernel()
SPLAT_BACKWARD_KERNEL = SplatBackwardKernel()


class SplatSum(torch.autograd.Function):
    """The sum core on the card: forward `SPLAT_SORTED_KERNEL`, backward
    `SPLAT_BACKWARD_KERNEL` (d_flow only when flow needs it)."""

    @staticmethod
    def forward(ctx, vals: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(vals, flow)
        return SPLAT_SORTED_KERNEL(vals, flow)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        vals, flow = ctx.saved_tensors
        d_vals, d_flow = SPLAT_BACKWARD_KERNEL(vals, flow, g.float().contiguous(),
                                               need_flow=ctx.needs_input_grad[1])
        return (d_vals if ctx.needs_input_grad[0] else None), d_flow


def splat_positions(flow: torch.Tensor):
    """Integer base corners (ix0, iy0) and the bilinear factors (wx1, wy1)
    of the splat positions (`splat_pallas.py:150-175`, float32), each
    (N, H, W).

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
    return x0f.clamp(-2, w).to(torch.int64), y0f.clamp(-2, h).to(torch.int64), x - x0f, y - y0f


def splat_geometry(flow: torch.Tensor):
    """The 4 corners of each splat position as (ix, iy, weight, in-bounds
    mask), in the kernel's order: (0, 0), (1, 0), (0, 1), (1, 1)."""
    _, h, w, _ = flow.shape
    ix0, iy0, wx1, wy1 = splat_positions(flow)
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


def splat_sort_keys(flow: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Each source pixel's key, its base corner on the canvas padded by one
    row and one column (`splat_pallas.py:177-181`): image * P + y0 * W + x0
    + W + 1, flat (N*H*W,) int64; and P = H*W + 2(W + 1). A source none of
    whose corners lies on the frame takes the image's last key, P - 1,
    which no destination reads (JAX clips its key into [0, P))."""
    n, h, w, _ = flow.shape
    ix0, iy0, _, _ = splat_positions(flow)
    p_pad = h * w + 2 * (w + 1)
    some = (ix0 >= -1) & (ix0 < w) & (iy0 >= -1) & (iy0 < h)
    base = torch.where(some, iy0 * w + ix0 + w + 1, p_pad - 1)
    img = torch.arange(n, device=flow.device).view(n, 1, 1) * p_pad
    return (img + base).reshape(-1), p_pad


def splat_sum_sorted_plain(vals: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The sorted kernel's order in plain torch (`csrc/softsplat_sorted.cu`):
    the sources stably sorted by `splat_sort_keys`; destination d (key k)
    sums the corners (0,0), (1,0), (0,1), (1,1) from the keys k, k - 1,
    k - W, k - W - 1, each run in sorted order, as acc = acc + v * w in
    float32, masked corners weighing 0. For the tests and the card's
    checks; no path calls it.

    vals (N, H, W, C) float32, flow (N, H, W, 2) -> (N, H, W, C) float32.
    """
    n, h, w, c = vals.shape
    p = n * h * w
    dev = vals.device
    keys, p_pad = splat_sort_keys(flow)
    keys, order = torch.sort(keys, stable=True)
    starts = torch.searchsorted(keys, torch.arange(n * p_pad + 1, device=dev))
    weights = torch.stack([torch.where(ok, wgt, 0.0) for _, _, wgt, ok in splat_geometry(flow)],
                          dim=-1).reshape(p, 4)[order]
    rows = vals.reshape(p, c).float()[order]
    pix = torch.arange(h * w, device=dev)
    k = (torch.arange(n, device=dev).view(n, 1) * p_pad + pix + w + 1).reshape(p)
    out = torch.zeros(p, c, dtype=torch.float32, device=dev)
    for corner, delta in enumerate((0, 1, w, w + 1)):
        lo, hi = starts[k - delta], starts[k - delta + 1]
        count = hi - lo
        for r in range(int(count.max()) if p else 0):
            take = (count > r)[:, None]
            j = torch.where(count > r, lo + r, 0)
            out = torch.where(take, out + rows[j] * weights[j, corner, None], out)
    return out.reshape(n, h, w, c)


def splat_sum_backward_plain(vals: torch.Tensor, flow: torch.Tensor, g: torch.Tensor,
                             need_flow: bool = True):
    """Plain torch backward of the sum core (`gimmvfi_tpu/ops/softsplat.py:
    _splat_pallas_bwd`): one gather of g at the 4 corners, then d_vals is
    their weighted sum and d_flow the value-weighted corner differences.

    vals, g (N, H, W, C), flow (N, H, W, 2), float32 -> (d_vals, d_flow),
    d_flow None unless `need_flow`.
    """
    n, h, w, c = vals.shape
    p = n * h * w
    img = torch.arange(n, device=vals.device).view(n, 1, 1) * (h * w)
    g_flat = g.reshape(p, c).float()
    gq, weights, masks = [], [], []
    for ix, iy, wgt, ok in splat_geometry(flow):
        ok = ok.reshape(p)
        idx = torch.where(ok, (img + iy * w + ix).reshape(p), 0)
        gq.append(torch.where(ok[:, None], g_flat[idx], 0.0))
        weights.append(wgt.reshape(p) * ok)
        masks.append(ok.float())
    gq = torch.stack(gq, dim=1)  # (P, 4, C)
    d_vals = torch.einsum("pk,pkc->pc", torch.stack(weights, dim=-1), gq).reshape(n, h, w, c)
    if not need_flow:
        return d_vals, None
    _, _, wx1, wy1 = (a.reshape(p) for a in splat_positions(flow))
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    m00, m01, m10, m11 = masks
    s00, s01, s10, s11 = torch.einsum("pc,pkc->pk", vals.reshape(p, c).float(), gq).unbind(-1)
    du = -wy0 * m00 * s00 + wy0 * m01 * s01 - wy1 * m10 * s10 + wy1 * m11 * s11
    dv = -wx0 * m00 * s00 - wx1 * m01 * s01 + wx0 * m10 * s10 + wx1 * m11 * s11
    return d_vals, torch.stack([du, dv], dim=-1).reshape(n, h, w, 2)


def splat_sum(vals: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Sum-mode splat core: `SplatSum` (the forward and backward kernels)
    for CUDA tensors, the plain version (differentiated by autograd) for
    CPU tensors, an error for anything else."""
    if vals.is_cuda:
        return SplatSum.apply(vals, flow)
    if vals.device.type == "cpu":
        return splat_sum_plain(vals, flow)
    raise NotImplementedError(f"no splat core for device {vals.device}")


def softsplat(
    ten_in: torch.Tensor,
    flow: torch.Tensor,
    metric: torch.Tensor | None,
    mode: str,
    return_norm: bool = False,
):
    """Forward-splat with mode/eps handling.

    mode: "sum" | "avg" | "linear[-eps]" | "softmax[-eps]", eps one of
    "addeps" (default), "zeroeps", "clipeps". Returns ten_in's dtype
    promoted with metric's, like the reference. With `return_norm` a
    normalising mode returns (splatted values, eps-adjusted weight) instead
    of their quotient; "sum" returns its one output either way.
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
    if return_norm:
        return out[..., :-1], norm
    return out[..., :-1] / norm
