"""The windowed correlation lookup of `ops/corr.py: windowed_corr_lookup`
(`csrc/windowed_corr_tf32.cu`, 3xTF32, for a float32 state;
`csrc/windowed_corr_mma.cu` for bf16): f1, the levels and the coordinates
read once and the output written once; two operations a channel for each
tap on its level's map (taps off the map need no dot). `PERF.md` section
6: 54.3 MB and 2.56 GFLOP at 720p F. The bound is the larger of bytes over
HBM and the products over the tensor cores' peak: three TF32 products an
operation for float32, one bf16 product for bf16."""

import torch

from ..peaks import BF16_FLOPS, HBM_BYTES_PER_S, TF32_FLOPS
from ..reference.ops import window_base

REFERENCE_OP = "port_bench.reference.ops:windowed_corr_lookup"
CHARGED = True  # the FLOP count charges a lookup these dots, not its gathers' einsum


def work(wc, coords, radius=4):
    n, p, c = wc.f1.shape
    esize = wc.f1.element_size()
    win, span = 2 * radius + 1, 2 * radius + 2
    nbytes = esize * (wc.f1.numel() + sum(f2.numel() for f2 in wc.f2_levels))
    nbytes += coords.numel() * 4 + n * len(wc.f2_levels) * win * win * p * esize
    flat = coords.float().reshape(n, 2, p)
    ok = torch.isfinite(flat).all(dim=1)
    taps = 0
    for i, f2 in enumerate(wc.f2_levels):
        counts = []
        for axis, size in ((0, f2.shape[2]), (1, f2.shape[1])):
            start, _ = window_base(flat[:, axis] / 2.0**i, radius, size)
            counts.append((torch.clamp(start + span, max=size) - start.clamp(min=0)).clamp(0, span))
        taps += int((counts[0] * counts[1] * ok).sum())
    dots = 2 * c * taps
    products = 3 * dots / TF32_FLOPS if wc.f1.dtype == torch.float32 else dots / BF16_FLOPS
    return nbytes, dots, max(nbytes / HBM_BYTES_PER_S, products)
