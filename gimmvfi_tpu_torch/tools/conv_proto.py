"""3x3 SAME bf16 conv at the MultiFlowDecoder's full-resolution shape: the
hand-written tensor-core kernel against cuDNN and the compute bound
(`tools/conv_pallas_proto.py`).

    python -m gimmvfi_tpu_torch.tools.conv_proto

Card only: without CUDA `main` raises. At (1,736,1280,256)x(3,3,256,256)
bf16 it times the kernel (`csrc/conv3x3.cu`), cuDNN with an NCHW-contiguous
input, cuDNN with a channels-last input and the plain version, and prints
each in ms and TFLOP/s with its max difference from the plain version, and
the device time of the first three from `torch.profiler` traces, in turns.

Layouts are the JAX probe's: activations (N, H, W, C), weights
(3, 3, Cin, Cout) HWIO. `conv3x3` takes the kernel for CUDA tensors and the
plain version for CPU tensors. The port's model never calls this kernel or
`conv3x3_library`: its convs stay `nn.Conv2d`.
"""

from __future__ import annotations

import ctypes
import statistics

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.kernel_build import CudaKernel
from ..utils.timing import bound_ms, cuda_ms, device_ms, fmt_ms

PROBE_SHAPE = (1, 736, 1280, 256)  # (N, H, W, C) of conv_pallas_proto.main
MAX_TILES = 2**31 - 1  # the kernel counts tiles in an int
TILE_PIXELS, TILE_CHANNELS = 128, 256  # one tile's output pixels and channels (kBM, kBN)


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The 9 shifted products on the zero-padded input, each
    (pixels, Cin) @ (Cin, Cout) in float32, summed in float32 and cast to
    x's dtype. x (N, H, W, Cin), w (3, 3, Cin, Cout)."""
    n, h, wd, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1)).float()
    wf = w.float()
    acc = torch.zeros((n, h, wd, w.shape[3]), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc += xp[:, dy:dy + h, dx:dx + wd, :] @ wf[dy, dx]
    return acc.to(x.dtype)


def library_operands(x: torch.Tensor, w: torch.Tensor, channels_last: bool):
    """x (N, H, W, Cin) and w (3, 3, Cin, Cout) as `F.conv2d` operands
    (N, Cin, H, W) and (Cout, Cin, 3, 3): NCHW-contiguous copies, or
    channels-last (x's permute already is, so no copy of x)."""
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1)
    if channels_last:
        return xc, wc.contiguous(memory_format=torch.channels_last)
    return xc.contiguous(), wc.contiguous()


def conv3x3_library(xc: torch.Tensor, wc: torch.Tensor) -> torch.Tensor:
    """cuDNN's conv as the yardstick: `F.conv2d` with padding 1 on
    `library_operands`, returned as (N, H, W, Cout) (a view)."""
    return F.conv2d(xc, wc, padding=1).permute(0, 2, 3, 1)


def kernel_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO weights (3, 3, Cin, Cout) as the kernel reads them: (3, 3, Cout,
    Cin) contiguous, each tap transposed so that K (Cin) is innermost."""
    return w.permute(0, 1, 3, 2).contiguous()


class Conv3x3Kernel(CudaKernel):
    """The CUDA implicit-GEMM conv (TMA-fed, warp-specialised `wgmma`):
    built at first use, with a launch counter. The weights go to the kernel
    as `kernel_weights(w)`, so that K is innermost for both operands; that
    repack is one copy on the card inside the call."""

    def __init__(self):
        super().__init__(
            name="conv3x3_bf16",
            source="gimmvfi_tpu_torch/csrc/conv3x3.cu",
            symbol="conv3x3_bf16",
            argtypes=[ctypes.c_void_p] * 3 + [ctypes.c_int] * 5,
            replaces="tools/conv_pallas_proto.py:73",
        )

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if x.dim() != 4 or w.dim() != 4:
            raise ValueError(f"conv3x3 takes x (N, H, W, Cin) and w (3, 3, Cin, Cout), "
                             f"got {tuple(x.shape)} and {tuple(w.shape)}")
        n, h, wd, cin = x.shape
        cout = w.shape[3]
        self.check(("x", x, torch.bfloat16),
                   ("w", w, torch.bfloat16, (3, 3, cin, cout), x.device))
        if min(n, h, wd) < 1 or cin % 16 or cout % 16 or cin < 16 or cout < 16:
            raise ValueError(f"conv3x3 takes N, H, W >= 1 and Cin, Cout multiples of 16, "
                             f"got x {tuple(x.shape)}, Cout {cout}")
        if n * h * -(-wd // TILE_PIXELS) * -(-cout // TILE_CHANNELS) > MAX_TILES:
            raise ValueError(f"conv3x3: x {tuple(x.shape)} x Cout {cout} has more tiles "
                             f"than the kernel counts")
        wt = kernel_weights(w)
        out = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
        self.launch(x.device, x.data_ptr(), wt.data_ptr(), out.data_ptr(), n, h, wd, cin, cout)
        return out


CONV3X3_KERNEL = Conv3x3Kernel()


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors, an error for anything else."""
    if x.is_cuda:
        return CONV3X3_KERNEL(x, w)
    if x.device.type == "cpu":
        return conv3x3_plain(x, w)
    raise NotImplementedError(f"no conv3x3 for device {x.device}")


def probe_inputs(shape=PROBE_SHAPE, cout=None, seed=0, device="cuda"):
    """The probe's inputs from a seed: x ~ N(0, 1), w ~ 0.05 N(0, 1), bf16."""
    rng = np.random.default_rng(seed)
    cout = shape[3] if cout is None else cout
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, shape[3], cout), dtype=np.float32) * 0.05)
    return x.to(device, torch.bfloat16), w.to(device, torch.bfloat16)


def conv_flops(x: torch.Tensor, w: torch.Tensor) -> float:
    n, h, wd, cin = x.shape
    return 2.0 * 9 * cin * w.shape[3] * n * h * wd


def conv_bound(x: torch.Tensor, w: torch.Tensor) -> tuple[float, str]:
    """Least time on the card: x and w read once, the output written once,
    against the bf16 operations."""
    n, h, wd, _ = x.shape
    nbytes = (x.numel() + w.numel() + n * h * wd * w.shape[3]) * x.element_size()
    return bound_ms(nbytes, conv_flops(x, w))


def measure(x: torch.Tensor, w: torch.Tensor, iters=20) -> dict:
    """Time the kernel, cuDNN NCHW, cuDNN channels-last and the plain version
    on the card (median of `iters` after one warm-up, CUDA events) and print
    each. Then the first three's own device time from `torch.profiler`
    traces, taken in turns (A B C C B A) because the card's clocks drift
    within a run: `<name>_device_ms` is the mean of a variant's two turns,
    None where a trace shows no device time."""
    flops = conv_flops(x, w)
    ref = conv3x3_plain(x, w).float()
    nchw = library_operands(x, w, channels_last=False)
    nhwc = library_operands(x, w, channels_last=True)
    variants = {
        "kernel": lambda: CONV3X3_KERNEL(x, w),
        "cudnn_nchw": lambda: conv3x3_library(*nchw),
        "cudnn_channels_last": lambda: conv3x3_library(*nhwc),
        "plain": lambda: conv3x3_plain(x, w),
    }
    res = {}
    for name, fn in variants.items():
        ms = cuda_ms(fn, iters=iters)
        diff = float((fn().float() - ref).abs().max())
        res[f"{name}_ms"] = ms
        res[f"{name}_max_diff"] = diff
        print(f"conv3x3 {tuple(x.shape)} {name:22s} {ms:9.4f} ms "
              f"{flops / ms / 1e9:7.1f} TFLOP/s  max diff vs plain {diff:.3e}", flush=True)
    turns = {"kernel": [], "cudnn_channels_last": [], "cudnn_nchw": []}
    for name in list(turns) + list(reversed(turns)):
        dev, by_name = device_ms(variants[name], iters=iters)
        turns[name].append(dev)
        split = "; ".join(f"{k[:60]} {v:.4f}" for k, v in by_name.items())
        print(f"conv3x3 {tuple(x.shape)} {name:22s} device time {fmt_ms(dev)} ({split})",
              flush=True)
    for name, devs in turns.items():
        res[f"{name}_device_ms"] = None if None in devs else statistics.mean(devs)
    res["bound_ms"], res["bound_by"] = conv_bound(x, w)
    print(f"conv3x3 {tuple(x.shape)} bound {res['bound_ms']:.4f} ms ({res['bound_by']}); "
          f"kernel at {100 * res['bound_ms'] / res['kernel_ms']:.1f}% of it", flush=True)
    return res


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this probe needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    return measure(*probe_inputs())


if __name__ == "__main__":
    main()
