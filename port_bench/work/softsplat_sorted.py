"""The sorted splat (`csrc/softsplat_sorted.cu`: keys, sort, gather) of
`ops/softsplat.py: splat_sum`: the values and flow read once and the sum
written once, float32 (`PERF.md` section 6's formula; 135.7 MB at
(1, 736, 1280, 17)). No products: a splat is bound by its bytes."""

from ..peaks import HBM_BYTES_PER_S

REFERENCE_OP = "port_bench.reference.ops:splat_sum"


def work(vals, flow):
    n, h, w, c = vals.shape
    nbytes = 4 * n * h * w * (2 * c + 2)
    return nbytes, 0, nbytes / HBM_BYTES_PER_S
