"""NCHW layers with the reference's dtype policy (`gimmvfi_tpu/nn/layers.py`).

`compute_dtype=None` computes in float32; `torch.bfloat16` casts a conv's
input, weight and bias to bf16. Parameters always stay float32, and
normalization statistics are computed in float32 in both modes.

A frame split by width over the ranks of a group (`parallel/spatial.py`)
runs a conv stack on a window of columns; `receptive_radius` and
`strided_reach` bound how far past a window's edge its convs read, and
inside `instance_norm_shard` every `InstanceNorm` takes the whole frame's
statistics (`instance_norm_sharded`).

`remat_call` is JAX's `nn.remat` for a unit of a model: under grad the
unit keeps only its inputs and recomputes its activations in the backward.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel import dist as dist_ops

_RECOMPUTING: contextvars.ContextVar[bool] = contextvars.ContextVar("recomputing", default=False)


class _Recompute:
    """Marks the backward's recompute of a `remat_call` unit (nested
    units re-enter it)."""

    def __init__(self):
        self._tokens = []

    def __enter__(self):
        self._tokens.append(_RECOMPUTING.set(True))

    def __exit__(self, *exc):
        _RECOMPUTING.reset(self._tokens.pop())


def _remat_contexts():
    return contextlib.nullcontext(), _Recompute()


def recomputing() -> bool:
    """True inside the backward's recompute of a `remat_call` unit."""
    return _RECOMPUTING.get()


def remat_call(fn, *args, remat: bool, **kwargs):
    """`fn(*args, **kwargs)`; with `remat` and grad on, as JAX's `nn.remat`
    unit: `torch.utils.checkpoint` (non-reentrant) keeps only the inputs,
    and the backward runs `fn` again for its activations. The autograd
    graph is the same as the plain call's, so where the kernels are
    deterministic (the CPU's) the gradients are bitwise the same. The
    recompute runs under `recomputing()`, in which BatchNorm does not move
    its running statistics a second time (flax's `nn.remat` drops the
    recompute's `batch_stats`). Without grad (inference) a plain call. No
    module is wrapped: the state dict keeps its keys."""
    if not (remat and torch.is_grad_enabled()):
        return fn(*args, **kwargs)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=_remat_contexts, **kwargs)


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose input, weight and bias are cast to `compute_dtype`.

    `padding_mode="reflect"` pads like the reference's `pad_mode="reflect"`.
    Weights are OIHW, so converted reference weights load directly.
    """

    def __init__(self, *args, compute_dtype: torch.dtype | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.float32
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class GemmConv2d(Conv2d):
    """A stride-1, ungrouped Conv2d computed as unfold + one matmul, with
    Conv2d's weights, keys and dtype policy. cuDNN 9.2 sends some float32
    3x3 convs (256 input channels at 92x160, as in FlowFormer's motion
    encoder at 720p) to an FFT path that takes 390-450 ms a call on an
    H100; as a GEMM the same conv takes 0.7-1 ms."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.stride != (1, 1) or self.groups != 1 or self.padding_mode != "zeros":
            raise ValueError("GemmConv2d takes stride 1, groups 1 and zero padding")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.float32
        n, _, h, w = x.shape
        (kh, kw), (ph, pw), (dh, dw) = self.kernel_size, self.padding, self.dilation
        cols = F.unfold(x.to(dt), self.kernel_size, self.dilation, self.padding)
        out = self.weight.to(dt).flatten(1) @ cols  # (N, Cout, H' * W')
        if self.bias is not None:
            out = out + self.bias.to(dt).view(1, -1, 1)
        return out.view(n, -1, h + 2 * ph - dh * (kh - 1), w + 2 * pw - dw * (kw - 1))


class PReLU(nn.Module):
    """Per-channel PReLU that keeps the input's dtype (state key `weight`)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = self.weight.to(x.dtype).view(1, -1, 1, 1)
        return torch.clamp_min(x, 0) + alpha * torch.clamp_max(x, 0)


BN_MOMENTUM = 0.9  # flax's default, as every BatchNorm of the JAX package uses


class BatchNorm2d(nn.Module):
    """BatchNorm2d with float32 statistics and arithmetic that returns
    `compute_dtype` (float32 if None), as flax's BatchNorm does.

    The statistics mode is the explicit `train` argument of `forward`, as
    JAX's `train` flag, never `nn.Module.training` (True on every freshly
    built module, and the inference paths never call `.eval()`):
      * `train=False` normalizes with the running statistics,
        `(x - mean) * (rsqrt(var + eps) * weight) + bias`;
      * `train=True` normalizes with the batch's mean and *biased* variance
        (`E[x^2] - E[x]^2`, clipped at 0, flax's fast variance) and then
        moves the running statistics, `running = 0.9 running + 0.1 batch`,
        with that same biased variance (torch's BatchNorm2d would use the
        unbiased one); a remat unit's recompute (`recomputing()`) takes
        the same batch statistics and leaves the running ones, so they
        move once a step.

    Under a process group of more than one rank (`parallel/dist.py`), the
    batch is the global one, as under JAX's sharded batch: the per-channel
    sums of x and x^2 are all-reduced (differentiably) and divided by the
    global count, every rank holding a batch of the same shape. A remat
    recompute all-reduces again in the backward, in the same order on
    every rank, before the step's gradient all-reduce.
    """

    def __init__(self, channels: int, eps: float = 1e-5,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.eps = eps
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.float()
        if train:
            world = dist_ops.world_size()
            if world > 1:
                c = xf.shape[1]
                sums = dist_ops.all_reduce_sum(torch.cat([xf.sum(dim=(0, 2, 3)),
                                                          (xf * xf).sum(dim=(0, 2, 3))]))
                count = xf.numel() // c * world
                mean, mean2 = sums[:c] / count, sums[c:] / count
            else:
                mean, mean2 = xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            if not recomputing():
                with torch.no_grad():
                    m = BN_MOMENTUM
                    self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                    self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1)
        y = y + self.bias.view(1, -1, 1, 1)
        return y.to(self.compute_dtype or torch.float32)


class ColumnShard(NamedTuple):
    """A window of a frame split by width: its input columns [lo, hi), the
    rank's own columns [a, b) inside it, the frame's input width, and the
    process group (None: the default group)."""

    lo: int
    hi: int
    a: int
    b: int
    width: int
    group: object = None


_SHARD: contextvars.ContextVar[ColumnShard | None] = contextvars.ContextVar("column_shard",
                                                                           default=None)


@contextlib.contextmanager
def instance_norm_shard(shard: ColumnShard):
    """Within: every `InstanceNorm` sees a window of `shard` (at any stride
    that divides lo, a, b and the width) and normalizes it with the whole
    frame's statistics (`instance_norm_sharded`)."""
    token = _SHARD.set(shard)
    try:
        yield
    finally:
        _SHARD.reset(token)


class InstanceNorm(nn.Module):
    """Parameter-free InstanceNorm2d (biased variance, float32 statistics);
    `train` is accepted beside BatchNorm2d's and changes nothing. Inside
    `instance_norm_shard` its input is a window of the shard, at the stride
    its width gives, and its statistics are the whole frame's."""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        shard = _SHARD.get()
        if shard is None:
            return instance_norm(x)
        lo, hi, a, b, width, group = shard
        stride = (hi - lo) // x.shape[3]
        return instance_norm_sharded(x, (a - lo) // stride, (b - lo) // stride, width // stride,
                                     group)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch InstanceNorm2d default; statistics in float32, result in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def instance_norm_sharded(x: torch.Tensor, a: int, b: int, width: int, group=None,
                          eps: float = 1e-5) -> torch.Tensor:
    """`instance_norm` of a frame `width` columns wide that is split by
    width over the ranks of `group`: x (N, C, H, w) is this rank's window,
    its columns [a, b) the rank's own (the ranks' own columns tile the
    frame). The statistics are the whole frame's, in float32 and in two
    passes as `instance_norm`'s: the sum over the own columns all-reduced
    gives the mean, then the sum of squares about it the variance. The
    whole window is normalized with them. Without a group, the window is
    the frame."""
    xf = x.float()
    count = x.shape[2] * width
    mine = xf[..., a:b]
    up = dist_ops.group_up()
    total = mine.sum(dim=(2, 3), keepdim=True)
    if up:
        dist.all_reduce(total, group=group)
    mean = total / count
    sq = ((mine - mean) ** 2).sum(dim=(2, 3), keepdim=True)
    if up:
        dist.all_reduce(sq, group=group)
    return ((xf - mean) * torch.rsqrt(sq / count + eps)).to(x.dtype)


def receptive_radius(module: nn.Module) -> int:
    """A bound on how many columns on each side one output column of
    `module` reads: the sum of k // 2 (times the dilation) over its convs."""
    return sum(m.dilation[1] * (m.kernel_size[1] // 2) for m in module.modules()
               if isinstance(m, nn.Conv2d))


def strided_reach(module: nn.Module) -> tuple[int, int]:
    """(reach, stride) of a strided conv stack run in registration order
    (RAFT's `BasicEncoder`): one output column reads at most `reach` input
    columns on each side of its first, stride x its index, where reach is
    the sum over the convs of k // 2 (times the dilation) times the product
    of the strides before it; `stride` is the product of all of them. A
    `downsample` shortcut, in parallel with its block's convs, must be 1x1:
    it reads inside their reach and adds no stride of its own."""
    reach, stride = 0, 1
    for name, m in module.named_modules():
        if not isinstance(m, nn.Conv2d):
            continue
        if "downsample" in name.split("."):
            if m.kernel_size[1] != 1:
                raise ValueError(f"{name}: a shortcut conv must be 1x1, got {m.kernel_size}")
            continue
        reach += stride * m.dilation[1] * (m.kernel_size[1] // 2)
        stride *= m.stride[1]
    return reach, stride


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.1) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def pixel_shuffle(x: torch.Tensor, upscale: int) -> torch.Tensor:
    """nn.PixelShuffle on NCHW: out[b, c, h*r+i, w*r+j] = in[b, c*r*r+i*r+j, h, w]."""
    return F.pixel_shuffle(x, upscale)


def sine(x: torch.Tensor, w0: float = 1.0) -> torch.Tensor:
    """SIREN activation."""
    return torch.sin(w0 * x)


def conv(cin: int, cout: int, k=3, stride=1, padding=0, dtype=None, **kw) -> Conv2d:
    """Shorthand for a biased `Conv2d` with the given compute dtype."""
    return Conv2d(cin, cout, k, stride, padding, compute_dtype=dtype, **kw)


def conv_prelu(cin: int, cout: int, k=3, stride=1, padding=1, dtype=None) -> nn.Sequential:
    """The reference's `convrelu`: Sequential(Conv2d, PReLU) (keys `.0`, `.1`)."""
    return nn.Sequential(conv(cin, cout, k, stride, padding, dtype), PReLU(cout))


@torch.no_grad()
def init_normal_(module: nn.Module, seed: int, std: float = 0.02) -> nn.Module:
    """Fill every parameter with N(0, std) drawn from a seeded CPU generator.

    The draws happen on the CPU, so the same seed gives the same weights on
    any device. BatchNorm running statistics are set to mean 0 / var 1: a
    random running variance could be negative and make rsqrt(var + eps) NaN.
    """
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for p in module.parameters():
        p.copy_(torch.randn(p.shape, generator=gen) * std)
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return module
