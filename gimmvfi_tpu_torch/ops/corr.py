"""All-pairs correlation pyramids and window lookups (`gimmvfi_tpu/ops/corr.py`).

Materialized path: the volume corr[n, p, q] = <fmap1[n, :, p], fmap2[n, :, q]>
/ sqrt(C) is one batched matmul, stored in the feature dtype (bf16 halves
it), pooled 2x2 over the target dims per level. A lookup samples a
(2r+1)^2 window per level with `F.grid_sample` (zeros padding,
align_corners=True).

Windowed path, taken when the volume would pass `max_volume_bytes`
(`corr_pyramid_auto`): pooling and window sampling are linear in the
volume, which is linear in fmap2, so a lookup can sample the pooled
target *features* and dot them with the query feature on the fly. The
state (`WindowedCorr`) is O(HW*C) instead of O((HW)^2). Its lookup is a
hand-written CUDA kernel for CUDA tensors, on the tensor cores:
`csrc/windowed_corr_mma.cu` in bf16 and `csrc/windowed_corr_tf32.cu`
(3xTF32) in float32; `windowed_corr_lookup_plain` for CPU tensors. A CUDA
tensor launches its kernel or raises. `csrc/windowed_corr.cu` (CUDA cores)
takes both dtypes; no route sends it a lookup. A CUDA lookup goes through
`WindowedCorrLookup`, whose backward is the hand-written
`csrc/windowed_corr_bwd.cu` (its plain version
`windowed_corr_lookup_backward_plain`); on the CPU autograd differentiates
the plain lookup. The kernels take any radius and level count: at most 4
levels and a radius of at most 4 (every path's lookups) take their fast
case, the rest their general case (`fast_case`), a launch for each group of
at most 4 levels (`level_groups`).
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..utils.kernel_build import CudaKernel, build_library
from .interp import bilinear_sampler

MAX_VOLUME_BYTES = 2 << 30


def all_pairs_corr(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """corr (N, H1*W1, H2, W2) from NCHW feature maps, scaled by 1/sqrt(C)."""
    n, c, h1, w1 = fmap1.shape
    h2, w2 = fmap2.shape[-2:]
    a = fmap1.reshape(n, c, h1 * w1).transpose(1, 2)
    b = fmap2.reshape(n, c, h2 * w2)
    corr = torch.bmm(a, b)
    corr.div_(math.sqrt(c))
    return corr.view(n, h1 * w1, h2, w2)


def _pool_levels(corr: torch.Tensor, num_levels: int) -> tuple[torch.Tensor, ...]:
    """2x2/stride-2 average pools of (N, P, h, w) over (h, w); floors odd sizes."""
    levels = [corr]
    for _ in range(num_levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        levels.append(corr)
    return tuple(levels)


def corr_pyramid(fmap1, fmap2, num_levels: int = 4) -> tuple[torch.Tensor, ...]:
    """RAFT correlation pyramid: levels[i] is (N, P, h_i, w_i)."""
    return _pool_levels(all_pairs_corr(fmap1, fmap2), num_levels)


def bidir_corr_pyramid(fmap1, fmap2, num_levels: int = 4):
    """Forward and transposed pyramids from one all-pairs matmul: the
    transposed volume corr_T[n, q, h1, w1] = corr[n, p(h1, w1), q]."""
    n, _, h1, w1 = fmap1.shape
    h2, w2 = fmap2.shape[-2:]
    corr = all_pairs_corr(fmap1, fmap2)
    corr_t = corr.reshape(n, h1 * w1, h2 * w2).transpose(1, 2).reshape(n, h2 * w2, h1, w1)
    return _pool_levels(corr, num_levels), _pool_levels(corr_t, num_levels)


def volume_bytes(fmap1, fmap2) -> int:
    """Bytes of one materialized pyramid (all levels: 4/3 of level 0)."""
    n, _, h1, w1 = fmap1.shape
    h2, w2 = fmap2.shape[-2:]
    return n * h1 * w1 * h2 * w2 * fmap1.element_size() * 4 // 3


def corr_pyramid_auto(fmap1, fmap2, num_levels: int = 4,
                      max_volume_bytes: int = MAX_VOLUME_BYTES):
    """`corr_pyramid` when the volume fits `max_volume_bytes`, else the
    windowed state. The choice depends on shapes only."""
    if volume_bytes(fmap1, fmap2) <= max_volume_bytes:
        return corr_pyramid(fmap1, fmap2, num_levels)
    return windowed_corr_pyramid(fmap1, fmap2, num_levels)


def bidir_corr_pyramid_auto(fmap1, fmap2, num_levels: int = 4,
                            max_volume_bytes: int = MAX_VOLUME_BYTES):
    """`bidir_corr_pyramid` when both volumes fit, else the windowed pair."""
    n, _, h1, w1 = fmap1.shape
    h2, w2 = fmap2.shape[-2:]
    if 2 * n * h1 * w1 * h2 * w2 * fmap1.element_size() * 4 // 3 <= max_volume_bytes:
        return bidir_corr_pyramid(fmap1, fmap2, num_levels)
    return bidir_windowed_corr_pyramid(fmap1, fmap2, num_levels)


def corr_lookup(pyramid, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Sample (2r+1)^2 windows at `coords` (N, 2, H, W), pixel (x, y) in
    level-0 target space, from every level.

    Returns (N, levels*(2r+1)^2, H, W) in the volume's dtype. Channel
    k = i*(2r+1) + j of a level samples (x + d[i], y + d[j]): the x offset
    is the outer index, as converted weights expect.
    """
    n, _, h, w = coords.shape
    win = 2 * radius + 1
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=coords.device)
    centre = coords.float().permute(0, 2, 3, 1).reshape(n * h * w, 1, 1, 2)
    out = []
    for i, corr in enumerate(pyramid):
        c = centre / (2.0**i)
        gx = (c[..., 0] + d.view(1, win, 1)).expand(-1, win, win)
        gy = (c[..., 1] + d.view(1, 1, win)).expand(-1, win, win)
        grid = torch.stack([gx, gy], dim=-1)  # (N*H*W, x offset, y offset, 2)
        level = corr.reshape(n * h * w, 1, *corr.shape[-2:])
        vals = bilinear_sampler(level, grid)  # (N*H*W, 1, win, win)
        out.append(vals.view(n, h, w, win * win).permute(0, 3, 1, 2))
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------- windowed


class WindowedCorr(NamedTuple):
    """On-the-fly correlation state: query features and pooled target maps."""

    f1: torch.Tensor  # (N, P, C) level-0 query features, pre-scaled by 1/sqrt(C)
    f2_levels: tuple[torch.Tensor, ...]  # (N, h_l, w_l, C), channels last
    shape_hw: tuple[int, int]  # query (H, W)


def _avg_pool_nhwc(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 mean of (N, h, w, C), flooring odd sizes. The sum and
    the division are float32 and the result is cast once, as JAX's `mean`
    does for bf16."""
    n, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    xf = x[:, : h2 * 2, : w2 * 2].float().reshape(n, h2, 2, w2, 2, c)
    return (xf.sum(dim=(2, 4)) / 4.0).to(x.dtype)


def windowed_corr_pyramid(fmap1, fmap2, num_levels: int = 4) -> WindowedCorr:
    """The windowed state of NCHW feature maps; no volume is formed."""
    n, c, h1, w1 = fmap1.shape
    f1 = (fmap1.float() / math.sqrt(c)).to(fmap1.dtype)
    f1 = f1.reshape(n, c, h1 * w1).transpose(1, 2).contiguous()
    levels = [fmap2.permute(0, 2, 3, 1).contiguous()]
    for _ in range(num_levels - 1):
        levels.append(_avg_pool_nhwc(levels[-1]))
    return WindowedCorr(f1, tuple(levels), (h1, w1))


def bidir_windowed_corr_pyramid(fmap1, fmap2, num_levels: int = 4):
    """Forward and transposed windowed states: the transposed volume
    corr_T[q, r] = <fmap2[q], fmap1[r]> is the state with roles swapped."""
    return (windowed_corr_pyramid(fmap1, fmap2, num_levels),
            windowed_corr_pyramid(fmap2, fmap1, num_levels))


def _window_base(c: torch.Tensor, radius: int, size: int):
    """Integer window start (floor(c) - r) and fractional offset of level
    coordinates c. The start is clamped before the integer conversion: past
    either end every tap is off the map, so the clamp changes no result, and
    a non-finite c takes the low end (its offset is NaN and makes every
    output of the window NaN, as in JAX)."""
    span = 2 * radius + 2
    fl = torch.floor(c)
    start = torch.where(torch.isfinite(fl), fl - radius, -span - 1.0)
    return start.clamp(-span - 1, size + 1).long(), c - fl


def windowed_corr_lookup_plain(wc: WindowedCorr, coords: torch.Tensor,
                               radius: int = 4) -> torch.Tensor:
    """Plain torch windowed lookup: a transcription of JAX
    `windowed_corr_lookup` (`gimmvfi_tpu/ops/corr.py:249-314`).

    coords (N, 2, H, W) float pixel (x, y) in level-0 target space. Per
    level: gather, for each query and each of its 2r+2 tap rows, the 2r+2
    target pixels of the row from a zero-padded map as one contiguous band
    of (2r+2)*C values; dot with f1 in float32; tent-blend the (2r+2)^2
    integer taps to the (2r+1)^2 real-valued ones in float32 in JAX's order;
    cast once to the feature dtype. Taps off the map count as zero.
    Returns (N, levels*(2r+1)^2, H, W), x offset outer.

    Non-finite coordinates: a NaN or infinite x or y makes all (2r+1)^2
    outputs of every level NaN for that query, which is what the JAX
    function returns on the CPU (its fractional offset is NaN).
    """
    n, _, h, w = coords.shape
    p = h * w
    win, span = 2 * radius + 1, 2 * radius + 2
    m = span + 1  # zero margin: the clamped window start is >= -m and <= size + 1
    f1 = wc.f1.float()
    c = f1.shape[-1]
    flat = coords.float().reshape(n, 2, p)
    rows = torch.arange(span, device=coords.device)
    out = []
    for i, f2 in enumerate(wc.f2_levels):
        _, hl, wl, _ = f2.shape
        x0, fx = _window_base(flat[:, 0] / 2.0**i, radius, wl)
        y0, fy = _window_base(flat[:, 1] / 2.0**i, radius, hl)
        f2p = F.pad(f2, (0, 0, m, m, m, m))
        wlp = wl + 2 * m
        rows_total = (hl + 2 * m) * wlp
        # banded view: row r holds the padded map's pixels r .. r+span-1
        bands = f2p.reshape(n, rows_total * c).as_strided(
            (n, rows_total - span + 1, span * c), (rows_total * c, c, 1))
        # (N, P, span): the band of each tap row, from the window's corner
        idx = ((y0 + m).unsqueeze(-1) + rows) * wlp + (x0 + m).unsqueeze(-1)
        g = bands[torch.arange(n, device=coords.device).view(n, 1), idx.reshape(n, p * span)]
        g = g.reshape(n, p, span, span, c).float()  # [query, tap row y, col x, C]
        s = torch.einsum("npyxc,npc->npyx", g, f1)
        fy_ = fy.reshape(n, p, 1, 1)
        fx_ = fx.reshape(n, p, 1, 1)
        sy = s[:, :, :win] * (1.0 - fy_) + s[:, :, 1:] * fy_
        v = sy[..., :win] * (1.0 - fx_) + sy[..., 1:] * fx_  # (N, P, y, x)
        v = v.transpose(2, 3).to(wc.f1.dtype)  # x offset outer
        out.append(v.reshape(n, h, w, win * win).permute(0, 3, 1, 2))
    return torch.cat(out, dim=1)


def windowed_corr_lookup_backward_plain(wc: WindowedCorr, coords: torch.Tensor, g: torch.Tensor,
                                        radius: int = 4):
    """Plain torch backward of `windowed_corr_lookup`: the formula of
    `csrc/windowed_corr_bwd.cu`, vectorised as `windowed_corr_lookup_plain`.

    g (N, levels*(2r+1)^2, H, W), the output's gradient. Per level and
    query, with gv[j][i] = g[l*(2r+1)^2 + i*(2r+1) + j] (x offset outer):
    the (2r+2)^2 dots s are recomputed (a tap off the map counts 0), the
    y blend sy = s[j](1-fy) + s[j+1]fy with them; back through the x blend
    dsy[j][i] += gv(1-fx), dsy[j][i+1] += gv fx, dfx = sum gv (sy[j][i+1] -
    sy[j][i]); back through the y blend ds[j] += dsy(1-fy), ds[j+1] +=
    dsy fy, dfy = sum dsy (s[j+1] - s[j]); each tap adds ds f2 to d_f1 and
    ds f1 to its pixel of d_f2; d_coords gains (dfx, dfy) / 2^l (floor has
    no gradient). Returns (d_f1 (N, P, C), d_levels as the levels,
    d_coords (N, 2, H, W)), all float32.

    A query with a non-finite coordinate gets what autograd of the plain
    lookup gives: NaN in d_f1 and d_coords (its taps' zeros times a NaN),
    nothing in d_levels (every tap is off the map).
    """
    n, _, h, w = coords.shape
    p = h * w
    win, span = 2 * radius + 1, 2 * radius + 2
    m = span + 1
    f1 = wc.f1.float()
    c = f1.shape[-1]
    flat = coords.float().reshape(n, 2, p)
    gf = g.float().reshape(n, len(wc.f2_levels), win, win, p)  # [n, level, i (x), j (y), query]
    steps = torch.arange(span, device=coords.device)
    batch = torch.arange(n, device=coords.device).view(n, 1)
    d_f1 = torch.zeros_like(f1)
    d_coords = torch.zeros((n, 2, p), dtype=torch.float32, device=coords.device)
    d_levels = []
    for i, f2 in enumerate(wc.f2_levels):
        _, hl, wl, _ = f2.shape
        x0, fx = _window_base(flat[:, 0] / 2.0**i, radius, wl)
        y0, fy = _window_base(flat[:, 1] / 2.0**i, radius, hl)
        f2p = F.pad(f2.float(), (0, 0, m, m, m, m))
        wlp = wl + 2 * m
        # (N, P, span, span): each tap's pixel in the padded map, [tap row y, col x]
        pix = (((y0 + m).view(n, p, 1, 1) + steps.view(1, 1, span, 1)) * wlp
               + (x0 + m).view(n, p, 1, 1) + steps.view(1, 1, 1, span))
        tap = f2p.reshape(n, -1, c)[batch, pix.reshape(n, -1)].reshape(n, p, span, span, c)
        s = torch.einsum("npyxc,npc->npyx", tap, f1)
        gv = gf[:, i].permute(0, 3, 2, 1)  # (N, P, j, i)
        fy_ = fy.reshape(n, p, 1, 1)
        fx_ = fx.reshape(n, p, 1, 1)
        sy = s[:, :, :win] * (1.0 - fy_) + s[:, :, 1:] * fy_  # (N, P, win, span)
        dsy = torch.zeros_like(sy)
        dsy[..., :win] += gv * (1.0 - fx_)
        dsy[..., 1:] += gv * fx_
        dfx = (gv * (sy[..., 1:] - sy[..., :win])).sum(dim=(2, 3))
        ds = torch.zeros_like(s)
        ds[:, :, :win] += dsy * (1.0 - fy_)
        ds[:, :, 1:] += dsy * fy_
        dfy = (dsy * (s[:, :, 1:] - s[:, :, :win])).sum(dim=(2, 3))
        d_f1 += torch.einsum("npyx,npyxc->npc", ds, tap)
        d_f2p = torch.zeros((n * f2p.shape[1] * wlp, c), dtype=torch.float32, device=f2.device)
        idx = (batch * (f2p.shape[1] * wlp) + pix.reshape(n, -1)).reshape(-1)
        d_f2p.index_add_(0, idx, (ds.unsqueeze(-1) * f1.view(n, p, 1, 1, c)).reshape(-1, c))
        d_levels.append(d_f2p.view(n, hl + 2 * m, wlp, c)[:, m:m + hl, m:m + wl].contiguous())
        d_coords[:, 0] += dfx / 2.0**i
        d_coords[:, 1] += dfy / 2.0**i
        del tap, s, sy, dsy, ds, d_f2p
    return d_f1, tuple(d_levels), d_coords.reshape(n, 2, h, w)


LEVEL_GROUP = 4  # levels a kernel launch takes: the fast case's most, the general case's group
FAST_RADIUS = 4  # the fast case's largest radius
WINDOWED_REPLACES = "gimmvfi_tpu/ops/corr.py:249"


def fast_case(levels: int, radius: int) -> bool:
    """Whether a lookup (or its backward) of `levels` levels at `radius`
    takes the kernels' fast case, else their general case (tap tiles of at
    most 9 x 9 outputs, a launch a group of levels)."""
    return levels <= LEVEL_GROUP and radius <= FAST_RADIUS


def level_groups(levels: int) -> list[tuple[int, int]]:
    """(first level, levels) of each general-case launch: consecutive groups
    of at most LEVEL_GROUP levels."""
    return [(l0, min(LEVEL_GROUP, levels - l0)) for l0 in range(0, levels, LEVEL_GROUP)]


def level_args(levels) -> tuple[list[int], list[int]]:
    """A launch's level pointers and sizes: the pointers, then the heights
    and the widths, each padded to LEVEL_GROUP."""
    pad = [0] * (LEVEL_GROUP - len(levels))
    return ([f2.data_ptr() for f2 in levels] + pad,
            [f2.shape[1] for f2 in levels] + pad + [f2.shape[2] for f2 in levels] + pad)


class WindowedCorrCudaKernel(CudaKernel):
    """What the windowed lookup's kernels and its backward take: C a
    multiple of 8 in [8, 256], at least one level and a radius >= 0, in the
    subclass's `DTYPES`. Built at first use, with a launch counter; each
    launcher takes `pointers` device pointers, six ints and the heights and
    widths of up to LEVEL_GROUP levels."""

    MAX_C = 256
    DTYPES = (torch.float32, torch.bfloat16)

    def __init__(self, name: str, source: str, symbol: str, pointers: int = 7):
        super().__init__(
            name=name,
            source=source,
            symbol=symbol,
            argtypes=[ctypes.c_void_p] * pointers + [ctypes.c_int] * (6 + 2 * LEVEL_GROUP),
            replaces=WINDOWED_REPLACES,
        )

    def checked(self, wc: WindowedCorr, coords: torch.Tensor, radius: int):
        """A lookup's checks: raise on what the kernel does not take; returns
        an empty output and (N, C)."""
        n, c = self.validated(wc, coords, radius)
        h, w = coords.shape[-2:]
        out = torch.empty((n, len(wc.f2_levels) * (2 * radius + 1) ** 2, h, w),
                          dtype=wc.f1.dtype, device=wc.f1.device)
        return out, (n, c)

    def refuse_window(self, levels: int, radius: int) -> None:
        """Raise on a level count or radius the kernel does not take."""
        if levels < 1 or radius < 0:
            raise ValueError(f"{self.name}: takes at least one level and a radius >= 0, got "
                             f"{levels} and {radius}")

    def validated(self, wc: WindowedCorr, coords: torch.Tensor, radius: int, *extra):
        """Raise on what the kernel does not take (and on `extra` specs, as
        `CudaKernel.check` takes them, checked with the inputs); returns (N,
        C)."""
        f1, levels = wc.f1, wc.f2_levels
        if torch.is_grad_enabled() and any(t.requires_grad for t in (f1, coords, *levels)):
            raise NotImplementedError(
                f"{self.name}: the windowed lookup kernels have no backward, and their output "
                "would leave the graph; run them under torch.no_grad or inference_mode "
                "(windowed_corr_lookup carries the backward kernel)")
        if f1.dim() != 3 or coords.dim() != 4 or coords.shape[1] != 2:
            raise ValueError(f"{self.name}: takes f1 (N, P, C) and coords (N, 2, H, W), got "
                             f"{tuple(f1.shape)} and {tuple(coords.shape)}")
        n, p, c = f1.shape
        h, w = coords.shape[-2:]
        if f1.dtype not in self.DTYPES:
            names = " or ".join(str(d).removeprefix("torch.") for d in self.DTYPES)
            raise TypeError(f"{self.name}: f1 must be {names}, got {f1.dtype}")
        if c % 8 or not 8 <= c <= self.MAX_C:
            raise ValueError(f"{self.name}: takes C a multiple of 8 in [8, {self.MAX_C}], got {c}")
        self.refuse_window(len(levels), radius)
        if n * p >= 2**31 or h * w != p:
            raise ValueError(f"{self.name}: needs N*P < 2**31 and H*W == P, got "
                             f"f1 {tuple(f1.shape)}, coords {tuple(coords.shape)}")
        specs = [("f1", f1, f1.dtype), ("coords", coords, torch.float32, (n, 2, h, w), f1.device)]
        for i, f2 in enumerate(levels):
            if f2.dim() != 4 or f2.shape[0] != n or f2.shape[3] != c:
                raise ValueError(f"{self.name}: level {i} must be (N, h, w, C) = ({n}, h, w, {c}), "
                                 f"got {tuple(f2.shape)}")
            specs.append((f"level {i}", f2, f1.dtype, tuple(f2.shape), f1.device))
        self.check(*specs, *extra)
        return n, c


class WindowedCorrKernel(WindowedCorrCudaKernel):
    """The CUDA-core windowed-correlation lookup (`csrc/windowed_corr.cu`),
    in float32 or bf16, 1-4 levels and a radius of 0-4; the tensor-core
    kernels took over both routes, and it stays to be timed beside them."""

    def __init__(self, name="windowed_corr", source="gimmvfi_tpu_torch/csrc/windowed_corr.cu",
                 symbol="windowed_corr_lookup"):
        super().__init__(name, source, symbol)

    def refuse_window(self, levels: int, radius: int) -> None:
        if not 1 <= levels <= LEVEL_GROUP or not 0 <= radius <= FAST_RADIUS:
            raise ValueError(f"{self.name}: takes 1-{LEVEL_GROUP} levels and radius "
                             f"0-{FAST_RADIUS}, got {levels} and {radius}")

    def __call__(self, wc: WindowedCorr, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
        out, (n, c) = self.checked(wc, coords, radius)
        f1 = wc.f1
        ptrs, sizes = level_args(wc.f2_levels)
        self.launch(f1.device, f1.data_ptr(), *ptrs, coords.data_ptr(), out.data_ptr(),
                    n, f1.shape[1], c, len(wc.f2_levels), radius,
                    int(f1.dtype == torch.bfloat16), *sizes)
        return out


class WindowedCorrTileKernel(WindowedCorrCudaKernel):
    """The tensor-core windowed-correlation lookups' launcher: 16-query
    tiles of one image row, the union of their windows staged once in
    shared memory, `mma.sync` dots, in the subclass's `DTYPES`. A lookup of
    the fast case launches the source's `symbol`, counted here; any other
    launches its general case, `<symbol>_general`, once for each group of
    levels, counted on `general`."""

    def __init__(self, name: str, source: str, symbol: str):
        super().__init__(name, source, symbol)
        self.general = CudaKernel(
            name=f"{name}_general", source=source, symbol=f"{symbol}_general",
            argtypes=[ctypes.c_void_p] * 7 + [ctypes.c_int] * (8 + 2 * LEVEL_GROUP),
            replaces=WINDOWED_REPLACES)

    def __call__(self, wc: WindowedCorr, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
        out, (n, c) = self.checked(wc, coords, radius)
        h, w = coords.shape[-2:]
        levels, dev = wc.f2_levels, wc.f1.device
        head = (wc.f1.data_ptr(),)
        tail = (coords.data_ptr(), out.data_ptr(), n, h, w, c)
        if fast_case(len(levels), radius):
            ptrs, sizes = level_args(levels)
            self.launch(dev, *head, *ptrs, *tail, len(levels), radius, *sizes)
            return out
        for l0, count in level_groups(len(levels)):
            ptrs, sizes = level_args(levels[l0:l0 + count])
            self.general.launch(dev, *head, *ptrs, *tail, count, radius, l0, len(levels), *sizes)
        return out


class WindowedCorrMmaKernel(WindowedCorrTileKernel):
    """The bf16 tensor-core lookup (`csrc/windowed_corr_mma.cu`), bf16 `mma`
    dots with float32 sums."""

    DTYPES = (torch.bfloat16,)

    def __init__(self):
        super().__init__(name="windowed_corr_mma",
                         source="gimmvfi_tpu_torch/csrc/windowed_corr_mma.cu",
                         symbol="windowed_corr_mma_lookup")


class WindowedCorrTf32Kernel(WindowedCorrTileKernel):
    """The float32 tensor-core lookup (`csrc/windowed_corr_tf32.cu`), 3xTF32
    `mma` dots, float32-exact to ~2**-22 a product."""

    DTYPES = (torch.float32,)

    def __init__(self):
        super().__init__(name="windowed_corr_tf32",
                         source="gimmvfi_tpu_torch/csrc/windowed_corr_tf32.cu",
                         symbol="windowed_corr_tf32_lookup")


BWD_TILE = 8  # destination tiles of the backward: 8x8 pixels of a level's map
BWD_KEY_PAD = 16  # the fast case's key tiles' padding of a level's map on its low sides
BWD_REACH = 3  # the fast case's candidate key tiles a side of a destination tile


def bwd_key_pad(radius: int, general: bool) -> int:
    """The key tiles' padding of a level's map on its low sides: 16 in the
    fast case; in the general case a live window's base x0 >= -(2r + 1)
    padded to a multiple of 8 (`csrc/windowed_corr_bwd.cu: general_pad`)."""
    return 8 * -(-(2 * radius + 1) // 8) if general else BWD_KEY_PAD


def bwd_chunk_queries(entries: int, reach: int = BWD_REACH) -> int:
    """The entries a chunk of the backward's destination side takes, from
    N*levels*P: a power of two in [128, 1024], about reach^2 x entries / 1024
    (the candidates of all tiles number ~reach^2 x entries: 9 x in the fast
    case), so that a large lookup's chunks number a few per SM and a small
    one's coarse tiles still split; the best of 64-4096 at each of the three
    shapes timed on the card (`PERF.md` §6). A function of the shape alone,
    so the order of every sum is the same from call to call."""
    q = 1 << max(0, (reach * reach * entries // 1024).bit_length() - 1)
    return min(1024, max(128, q))


BWD_SPLIT_BELOW = 2048  # query tiles below which the backward's query side splits the levels


def bwd_split_levels(n: int, h: int, w: int) -> bool:
    """Whether the backward's query side takes a block a (tile of 16
    queries, level) rather than a block a tile: when the tiles number fewer
    than `BWD_SPLIT_BELOW`, a few waves of blocks or less, as at stage-2
    training's 28x28 lookups (224 tiles) and 720p F's AMT lookup (920),
    where it was faster on the card, and not at the 2K RAFT lookup (4,352),
    where it was slower (`PERF.md` §6); the levels' parts of d_f1 and
    d_coords are then added in level order. A function of the shape alone.
    The general case always splits."""
    return n * h * -(-w // 16) < BWD_SPLIT_BELOW


class BwdPlanSizes(NamedTuple):
    """The backward's keys and destination tiles (`csrc/windowed_corr_bwd.cu:
    make_geometry`) for one launch's levels: level l has (KY_l, KX_l) =
    ((h_l + pad + 7) // 8, (w_l + pad + 7) // 8) key tiles ((h_l + 23) // 8
    in the fast case) and (TY_l, TX_l) = ((h_l + 7) // 8, (w_l + 7) // 8)
    destination tiles; keys and tiles are numbered image, level, row,
    column; the sentinel key (a window off the map) is N * keys_per_image;
    a destination tile's candidates are the reach x reach key tiles from
    its own row and column."""

    kx: tuple[int, ...]
    key_base: tuple[int, ...]
    keys_per_image: int
    tx: tuple[int, ...]
    ty: tuple[int, ...]
    sentinel: int
    tiles: int
    entries: int
    chunk_q: int
    max_chunks: int  # tiles + ceil(reach^2 entries / chunk_q): no plan has more chunks
    pad: int
    reach: int


def bwd_plan_sizes(level_hw, n: int, p: int, radius: int = 4,
                   general: bool = False) -> BwdPlanSizes:
    """`BwdPlanSizes` of levels of (h_l, w_l), N images and P queries, in the
    fast case's key geometry or (`general`) the radius's."""
    pad = bwd_key_pad(radius, general)
    reach = pad // 8 + 1
    kx = tuple((w + pad + 7) // 8 for _, w in level_hw)
    ky = tuple((h + pad + 7) // 8 for h, _ in level_hw)
    tx = tuple((w + 7) // 8 for _, w in level_hw)
    ty = tuple((h + 7) // 8 for h, _ in level_hw)
    key_sizes = [a * b for a, b in zip(kx, ky)]
    key_base = tuple(sum(key_sizes[:i]) for i in range(len(key_sizes)))
    entries = n * len(level_hw) * p
    chunk_q = bwd_chunk_queries(entries, reach)
    tiles = n * sum(a * b for a, b in zip(tx, ty))
    return BwdPlanSizes(kx, key_base, sum(key_sizes), tx, ty, n * sum(key_sizes), tiles, entries,
                        chunk_q, tiles + -(-reach * reach * entries // chunk_q), pad, reach)


class WindowedCorrBwdKernel(WindowedCorrCudaKernel):
    """The windowed lookup's backward (`csrc/windowed_corr_bwd.cu`). Takes
    what the lookups take, and g (N, levels*(2r+1)^2, H, W) in the
    features' dtype; returns (d_f1, d_levels, d_coords) in the inputs'
    dtypes (d_coords float32, None unless `need_coords`: without it the
    query side skips the dots, which only d_coords needs). One call runs
    the query side (`windowed_corr_bwd_query`: ds, keys, d_f1, d_coords),
    `torch.sort(stable=True)` of the keys, then the destination side
    (`windowed_corr_bwd`, whose launches the counter counts: one a call),
    which writes every element of d_levels once, summed in a fixed order:
    d_levels are bitwise the same from call to call. That is the fast case
    (`fast_case`); any other radius and level count runs the general case
    for each group of levels (`windowed_corr_bwd_query_general`, the sort,
    `windowed_corr_bwd_general`, counted on `general`: one a group), then
    `windowed_corr_bwd_level_sum` adds the levels' float32 parts of d_f1 and
    d_coords in level order."""

    QUERY_SYMBOL = "windowed_corr_bwd_query"
    GENERAL_QUERY_SYMBOL = "windowed_corr_bwd_query_general"
    LEVEL_SUM_SYMBOL = "windowed_corr_bwd_level_sum"

    def __init__(self):
        super().__init__("windowed_corr_bwd", "gimmvfi_tpu_torch/csrc/windowed_corr_bwd.cu",
                         "windowed_corr_bwd")
        ints = [ctypes.c_int] * (7 + 2 * LEVEL_GROUP)
        self.argtypes = [ctypes.c_void_p] * 12 + ints + [ctypes.c_void_p]
        self.general = CudaKernel("windowed_corr_bwd_general", self.source,
                                  "windowed_corr_bwd_general",
                                  argtypes=[ctypes.c_void_p] * 12 + ints, replaces=WINDOWED_REPLACES)
        self.launchers = {
            self.QUERY_SYMBOL: [ctypes.c_void_p] * 14 + ints + [ctypes.c_int, ctypes.c_void_p],
            self.GENERAL_QUERY_SYMBOL: ([ctypes.c_void_p] * 12 + [ctypes.c_int] * (9 + 2 * LEVEL_GROUP)
                                        + [ctypes.c_void_p]),
            self.LEVEL_SUM_SYMBOL: [ctypes.c_void_p] * 4 + [ctypes.c_int64] + [ctypes.c_int] * 3
                                   + [ctypes.c_void_p],
        }
        self._fns = {}

    def build(self) -> str:
        log = super().build()
        self.attach(build_library(Path(self.source).name)[0])
        return log

    def attach(self, lib) -> None:
        """Bind the query side's launchers and the level sum of library
        `lib` (the counted launchers are bound as every kernel's)."""
        for symbol, argtypes in self.launchers.items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            self._fns[symbol] = fn

    def _run(self, symbol: str, device, *args) -> None:
        """An uncounted launcher of the library on `device`'s current stream."""
        with torch.cuda.device(device):
            err = self._fns[symbol](*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{symbol} launch failed: cudaError {err}")

    def __call__(self, wc: WindowedCorr, coords: torch.Tensor, g: torch.Tensor, radius: int = 4,
                 need_coords: bool = True):
        g_shape = (coords.shape[0], len(wc.f2_levels) * (2 * radius + 1) ** 2, *coords.shape[-2:])
        n, c = self.validated(wc, coords, radius,
                              ("g", g, wc.f1.dtype, g_shape, wc.f1.device))
        levels = wc.f2_levels
        p = wc.f1.shape[1]
        group = min(len(levels), LEVEL_GROUP)
        sizes = [tuple(f2.shape[1:3]) for f2 in levels]
        if (n * group * p >= 2**31 or max(max(hw) for hw in sizes) > 32000
                or 2 * radius + 2 > 32000):
            raise ValueError(f"{self.name}: needs N*levels*P < 2**31 (levels of a group of "
                             f"{LEVEL_GROUP}), level sizes <= 32000 and 2r + 2 <= 32000, got "
                             f"{n * group * p} entries, levels {sizes}, radius {radius}")
        if self._fn is None:
            self.build()
        if fast_case(len(levels), radius):
            return self._fast(wc, coords, g, radius, need_coords, n, c)
        return self._general(wc, coords, g, radius, need_coords, n, c)

    def _fast(self, wc, coords, g, radius, need_coords, n, c):
        f1, levels = wc.f1, wc.f2_levels
        p = f1.shape[1]
        h, w = coords.shape[-2:]
        plan = bwd_plan_sizes([tuple(f2.shape[1:3]) for f2 in levels], n, p)
        ptrs, sizes = level_args(levels)
        dev = f1.device
        ntaps = (2 * radius + 2) ** 2
        is_bf16 = int(f1.dtype == torch.bfloat16)
        d_f1 = torch.empty_like(f1)
        d_coords = torch.empty_like(coords) if need_coords else None
        split = bwd_split_levels(n, h, w)
        parts = [torch.empty((len(levels), *t.shape), dtype=torch.float32, device=dev)
                 if split and t is not None else None for t in (d_f1, d_coords)]
        ds = torch.empty((n, len(levels), p, ntaps), dtype=torch.float32, device=dev)
        keys = torch.empty(plan.entries, dtype=torch.int32, device=dev)
        bases = torch.empty(plan.entries, dtype=torch.int32, device=dev)
        self._run(self.QUERY_SYMBOL, dev, f1.data_ptr(), *ptrs, coords.data_ptr(), g.data_ptr(),
                  *[0 if t is None else t.data_ptr() for t in (d_f1, d_coords, *parts)],
                  ds.data_ptr(), keys.data_ptr(), bases.data_ptr(), n, h, w, c, len(levels),
                  radius, is_bf16, int(split), *sizes)
        d_levels = [torch.empty_like(f2) for f2 in levels]
        self._destination(self, plan, f1, ds, keys, bases, d_levels, radius, is_bf16, sizes)
        return d_f1, tuple(d_levels), d_coords

    @staticmethod
    def _destination(counted: CudaKernel, plan: BwdPlanSizes, f1, ds, keys, bases, d_levels,
                     radius: int, is_bf16: int, sizes) -> None:
        """The destination side of one launch's levels: the stable sort of
        their `keys` (the first `plan.entries`), then `counted`'s launcher
        (the fast or the general one), which writes `d_levels`."""
        n, p, c = f1.shape
        dev = f1.device
        sorted_keys, order = torch.sort(keys[:plan.entries], stable=True)
        offsets = torch.empty(plan.sentinel + 1, dtype=torch.int32, device=dev)
        chunk_start = torch.empty(plan.tiles + 1, dtype=torch.int32, device=dev)
        partial = torch.empty((plan.max_chunks, BWD_TILE * BWD_TILE, c), dtype=torch.float32,
                              device=dev)
        outs, _ = level_args(d_levels)
        counted.launch(dev, f1.data_ptr(), ds.data_ptr(), sorted_keys.data_ptr(),
                       order.data_ptr(), bases.data_ptr(), offsets.data_ptr(),
                       chunk_start.data_ptr(), partial.data_ptr(), *outs, n, p, c, len(d_levels),
                       radius, is_bf16, plan.chunk_q, *sizes)

    def _general(self, wc, coords, g, radius, need_coords, n, c):
        f1, levels = wc.f1, wc.f2_levels
        p = f1.shape[1]
        h, w = coords.shape[-2:]
        dev = f1.device
        ntaps = (2 * radius + 2) ** 2
        is_bf16 = int(f1.dtype == torch.bfloat16)
        nl = len(levels)
        # every level's float32 parts of d_f1 and d_coords, added once at the end
        d_f1_part = torch.empty((nl, n * p, c), dtype=torch.float32, device=dev)
        d_coords_part = (torch.empty((nl, n, 2, p), dtype=torch.float32, device=dev)
                         if need_coords else None)
        # one group's scratch, taken by each group in turn (on one stream)
        group = min(nl, LEVEL_GROUP)
        ds = torch.empty((n, group, p, ntaps), dtype=torch.float32, device=dev)
        keys = torch.empty(n * group * p, dtype=torch.int32, device=dev)
        bases = torch.empty(n * group * p, dtype=torch.int32, device=dev)
        d_levels = [torch.empty_like(f2) for f2 in levels]
        for l0, count in level_groups(nl):
            mine = levels[l0:l0 + count]
            plan = bwd_plan_sizes([tuple(f2.shape[1:3]) for f2 in mine], n, p, radius, general=True)
            ptrs, sizes = level_args(mine)
            self._run(self.GENERAL_QUERY_SYMBOL, dev, f1.data_ptr(), *ptrs, coords.data_ptr(),
                      g.data_ptr(), d_f1_part.data_ptr(),
                      0 if d_coords_part is None else d_coords_part.data_ptr(), ds.data_ptr(),
                      keys.data_ptr(), bases.data_ptr(), n, h, w, c, count, radius, is_bf16, l0,
                      nl, *sizes)
            self._destination(self.general, plan, f1, ds, keys, bases, d_levels[l0:l0 + count],
                              radius, is_bf16, sizes)
        d_f1 = torch.empty_like(f1)
        d_coords = torch.empty_like(coords) if need_coords else None
        self._run(self.LEVEL_SUM_SYMBOL, dev, d_f1_part.data_ptr(),
                  0 if d_coords_part is None else d_coords_part.data_ptr(), d_f1.data_ptr(),
                  0 if d_coords is None else d_coords.data_ptr(), n * p, c, nl, is_bf16)
        return d_f1, tuple(d_levels), d_coords


WINDOWED_CORR_KERNEL = WindowedCorrKernel()
WINDOWED_CORR_MMA_KERNEL = WindowedCorrMmaKernel()
WINDOWED_CORR_TF32_KERNEL = WindowedCorrTf32Kernel()
WINDOWED_CORR_BWD_KERNEL = WindowedCorrBwdKernel()
# the general cases' counted launchers
WINDOWED_CORR_MMA_GENERAL_KERNEL = WINDOWED_CORR_MMA_KERNEL.general
WINDOWED_CORR_TF32_GENERAL_KERNEL = WINDOWED_CORR_TF32_KERNEL.general
WINDOWED_CORR_BWD_GENERAL_KERNEL = WINDOWED_CORR_BWD_KERNEL.general


def windowed_corr_kernel_for(dtype: torch.dtype) -> WindowedCorrTileKernel:
    """The kernel a CUDA lookup of this feature dtype goes to, on the tensor
    cores: bf16 `mma` for bf16, 3xTF32 `mma` for float32 (each at any
    radius and level count: its fast or its general case); an error for any
    other."""
    if dtype == torch.bfloat16:
        return WINDOWED_CORR_MMA_KERNEL
    if dtype == torch.float32:
        return WINDOWED_CORR_TF32_KERNEL
    raise TypeError(f"no windowed correlation kernel for {dtype}: takes bfloat16 or float32")


class WindowedCorrLookup(torch.autograd.Function):
    """The windowed lookup on the card: `apply(coords, f1, *levels,
    radius)`. Forward the kernel of `windowed_corr_kernel_for`, backward
    `WINDOWED_CORR_BWD_KERNEL` (d_coords only when coords need it); a
    gradient is returned only where an input needs one. Under no_grad or
    inference_mode, or when no input needs a gradient, it records no graph
    and launches the forward kernel alone."""

    @staticmethod
    def forward(ctx, coords: torch.Tensor, f1: torch.Tensor, *levels_radius):
        *levels, radius = levels_radius
        ctx.radius = radius
        ctx.save_for_backward(coords, f1, *levels)
        wc = WindowedCorr(f1, tuple(levels), tuple(coords.shape[-2:]))
        return windowed_corr_kernel_for(f1.dtype)(wc, coords, radius)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        coords, f1, *levels = ctx.saved_tensors
        need = ctx.needs_input_grad
        g = g.contiguous()
        if g.data_ptr() % 16:  # a contiguous view at an offset, as torch.cat's backward gives
            g = g.clone()
        wc = WindowedCorr(f1, tuple(levels), tuple(coords.shape[-2:]))
        d_f1, d_levels, d_coords = WINDOWED_CORR_BWD_KERNEL(wc, coords, g, ctx.radius,
                                                            need_coords=need[0])
        return (d_coords, d_f1 if need[1] else None,
                *(d if ok else None for d, ok in zip(d_levels, need[2:])), None)


def windowed_corr_lookup(wc: WindowedCorr, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Windowed lookup, the same output as `corr_lookup` on the materialized
    pyramid: for CUDA tensors `WindowedCorrLookup` (the kernels), for CPU
    tensors the plain version under autograd, an error for anything else."""
    if coords.is_cuda:
        return WindowedCorrLookup.apply(coords.float().contiguous(), wc.f1, *wc.f2_levels, radius)
    if coords.device.type == "cpu":
        return windowed_corr_lookup_plain(wc, coords, radius)
    raise NotImplementedError(f"no windowed correlation lookup for device {coords.device}")


def windowed_corr_work(wc: WindowedCorr, coords: torch.Tensor, radius: int = 4) -> tuple[int, int]:
    """(bytes, operations) a windowed lookup needs on these inputs: f1, the
    levels and the coordinates read once and the output written once; two
    operations a channel for each tap that lies on its level's map (taps off
    the map are zeros and need no dot; a non-finite coordinate needs none)."""
    n, p, c = wc.f1.shape
    win, span = 2 * radius + 1, 2 * radius + 2
    esize = wc.f1.element_size()
    nbytes = (wc.f1.numel() + sum(f2.numel() for f2 in wc.f2_levels)) * esize
    nbytes += coords.numel() * 4 + n * len(wc.f2_levels) * win * win * p * esize
    flat = coords.float().reshape(n, 2, p)
    ok = torch.isfinite(flat).all(dim=1)
    taps = 0
    for i, f2 in enumerate(wc.f2_levels):
        counts = []
        for axis, size in ((0, f2.shape[2]), (1, f2.shape[1])):
            start, _ = _window_base(flat[:, axis] / 2.0**i, radius, size)
            counts.append((torch.clamp(start + span, max=size) - start.clamp(min=0)).clamp(0, span))
        taps += int((counts[0] * counts[1] * ok).sum())
    return nbytes, 2 * c * taps


def windowed_corr_bwd_work(wc: WindowedCorr, coords: torch.Tensor, radius: int = 4,
                           need_coords: bool = True) -> tuple[int, int, int]:
    """(bytes, dot operations, product operations) the windowed lookup's
    backward needs on these inputs: f1, the levels, the coordinates and g
    read once, d_f1 and d_levels (in the features' dtype) and d_coords
    (with `need_coords`) written once. For each tap on its level's map, two
    operations a channel for its dot again (products of the features'
    dtype, summed in float32; only d_coords needs them) and four for its
    shares of d_f1 and of its pixel's d_f2 (float32 products: ds is
    float32)."""
    nbytes, dots = windowed_corr_work(wc, coords, radius)
    esize = wc.f1.element_size()
    feats = (wc.f1.numel() + sum(f2.numel() for f2 in wc.f2_levels)) * esize
    # the forward's output written becomes g read; the gradients come on top
    nbytes += feats + (coords.numel() * 4 if need_coords else 0)
    return nbytes, dots if need_coords else 0, 2 * dots


def corr_lookup_any(pyr, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """`windowed_corr_lookup` for a `WindowedCorr`, `corr_lookup` for a
    materialized pyramid (a tuple of levels)."""
    if isinstance(pyr, WindowedCorr):
        return windowed_corr_lookup(pyr, coords, radius)
    return corr_lookup(pyr, coords, radius)


def bidir_corr_lookup(pyramids, coords0, coords1, radius: int = 4):
    """Look up the forward state at coords0 and the transposed one at
    coords1; either pair of materialized pyramids or of windowed states."""
    fwd, bwd = pyramids
    return corr_lookup_any(fwd, coords0, radius), corr_lookup_any(bwd, coords1, radius)
