"""The `subgather` kernel's redesign on the card: its variants against its
plain version, timed in turns.

    python -m gimmvfi_tpu_torch.tools.gather_ablate [--against SOURCE ...]

Card only: without CUDA `main` raises. Each variant is
`csrc/gather_probe.cu` with its subgather kernel and launcher replaced,
built with the kernels' nvcc flags into `build/kernels/ablate/`:
  - kernel: the source as it is (a block owns 64 rows of one 8-lane
    sector column, a thread an output, both loads through the read-only
    path);
  - rows32, rows128: 32 or 128 rows a block (256 or 1024 threads);
  - lanes16: 32 rows of 16 lanes (two sectors) a block;
  - flat: one thread an output in raster order, 256 threads a block (the
    layout of the two other gathers);
  - strip, strip_rows128: a block stages a strip of 8 of x's columns, all
    rows, in shared memory with 16-byte `cp.async` copies while its
    threads load their indices, then gathers from shared memory: one L2
    round trip where the kernel makes two; 64 or 128 output rows a block;
  - cluster: a cluster of 8 blocks shares one staged strip of 8 columns,
    each block staging an eighth of its rows and gathering through
    distributed shared memory.
`--against` adds any other source with the `subgather_f32` launcher, e.g.
an earlier version taken from git history. Every variant is checked
against `subgather_plain` (exactly, NaN at the same places) on the probe's
(512, 128) table with in-range and with negative and out-of-range indices
and on ragged tables, then all are timed at (512, 128) by their device
rows in `torch.profiler` traces, three turns in alternating orders, beside
`torch.gather` and the launch floor.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..utils.kernel_build import CSRC, build_text
from ..utils.timing import device_ms, launch_floor_ms
from .gather_cost_probe import ROWS, gather_bound, gather_tables, subgather_plain

KERNEL_HEAD = "__global__ void __launch_bounds__(kSubRows * kSubLanes)\nsubgather_kernel("
LAUNCHER_HEAD = 'extern "C" int subgather_f32('

STRIP = r'''constexpr int kStrip = 8;       // columns of x a block stages
constexpr int kStripRows = ROWS_PER_BLOCK;  // output rows a block writes
constexpr int kStripThreads = 256;
constexpr int kStripPer = kStripRows * kStrip / kStripThreads;

__global__ void __launch_bounds__(kStripThreads)
subgather_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                 float* __restrict__ out, int rows, int lanes) {
  extern __shared__ float s_x[];  // x[:, j0 : j0 + kStrip], row pitch kStrip
  const int t = threadIdx.x;
  const int j0 = blockIdx.x * kStrip, r0 = blockIdx.y * kStripRows;
  const int w = min(kStrip, lanes - j0);
  for (int k = t; k < rows * kStrip; k += kStripThreads) {
    const int r = k / kStrip, q = k % kStrip;
    if (w == kStrip && lanes % 4 == 0) {
      if (q % 4 == 0) {
        const unsigned s = (unsigned)__cvta_generic_to_shared(s_x + k);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                     "l"(x + (int64_t)r * lanes + j0 + q));
      }
    } else if (q < w) {
      const unsigned s = (unsigned)__cvta_generic_to_shared(s_x + k);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                   "l"(x + (int64_t)r * lanes + j0 + q));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  int v[kStripPer];
#pragma unroll
  for (int u = 0; u < kStripPer; ++u) {
    const int e = t + u * kStripThreads;
    const int r = r0 + e / kStrip, q = e % kStrip;
    v[u] = r < rows && q < w ? __ldg(idx + (int64_t)r * lanes + j0 + q) : 0;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kStripPer; ++u) {
    const int e = t + u * kStripThreads;
    const int r = r0 + e / kStrip, q = e % kStrip;
    if (r >= rows || q >= w) continue;
    const int s = v[u] < 0 ? v[u] + rows : v[u];
    out[(int64_t)r * lanes + j0 + q] = s >= 0 && s < rows ? s_x[s * kStrip + q] : nan_fill();
  }
}
'''
STRIP_LAUNCHER = r'''extern "C" int subgather_f32(const float* x, const int* idx, float* out, int rows, int lanes,
                             void* stream) {
  const int smem = rows * kStrip * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        subgather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((lanes + kStrip - 1) / kStrip, (rows + kStripRows - 1) / kStripRows);
  subgather_kernel<<<grid, kStripThreads, smem, (cudaStream_t)stream>>>(x, idx, out, rows, lanes);
  return (int)cudaGetLastError();
}
'''
CLUSTER = r'''constexpr int kCw = 8, kCk = 8, kCt = 256;  // strip columns, cluster blocks, threads

__global__ void __cluster_dims__(1, kCk, 1) __launch_bounds__(kCt)
subgather_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                 float* __restrict__ out, int rows, int lanes) {
  extern __shared__ float s_x[];  // rows [rank * rb, (rank + 1) * rb) of the strip
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int rb = (rows + kCk - 1) / kCk;
  const int j0 = blockIdx.x * kCw, r0 = rank * rb;
  const int nr = max(0, min(rb, rows - r0));
  const int w = min(kCw, lanes - j0);
  const int t = threadIdx.x;
  for (int k = t; k < nr * kCw; k += kCt) {
    const int r = k / kCw, q = k % kCw;
    if (q < w) s_x[k] = __ldg(x + (int64_t)(r0 + r) * lanes + j0 + q);
  }
  cluster.sync();
  for (int e = t; e < nr * kCw; e += kCt) {
    const int r = r0 + e / kCw, q = e % kCw;
    if (q >= w) continue;
    int s = __ldg(idx + (int64_t)r * lanes + j0 + q);
    if (s < 0) s += rows;
    float val = nan_fill();
    if (s >= 0 && s < rows) val = cluster.map_shared_rank(s_x, s / rb)[(s % rb) * kCw + q];
    out[(int64_t)r * lanes + j0 + q] = val;
  }
  cluster.sync();  // no block leaves while another reads its strip
}
'''
CLUSTER_LAUNCHER = r'''extern "C" int subgather_f32(const float* x, const int* idx, float* out, int rows, int lanes,
                             void* stream) {
  const int rb = (rows + kCk - 1) / kCk;
  const dim3 grid((lanes + kCw - 1) / kCw, kCk);
  subgather_kernel<<<grid, kCt, rb * kCw * 4, (cudaStream_t)stream>>>(x, idx, out, rows, lanes);
  return (int)cudaGetLastError();
}
'''
FLAT = r'''constexpr int kFlat = 256;  // threads a block, one output each, in raster order

__global__ void __launch_bounds__(kFlat)
subgather_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                 float* __restrict__ out, int rows, int lanes) {
  const int t = blockIdx.x * kFlat + threadIdx.x;
  if (t >= rows * lanes) return;
  int v = __ldg(idx + t);
  if (v < 0) v += rows;
  out[t] = (v >= 0 && v < rows) ? __ldg(x + v * lanes + t % lanes) : nan_fill();
}
'''
FLAT_LAUNCHER = r'''extern "C" int subgather_f32(const float* x, const int* idx, float* out, int rows, int lanes,
                             void* stream) {
  const int64_t total = (int64_t)rows * lanes;
  if (total > 0) {
    subgather_kernel<<<(unsigned)((total + kFlat - 1) / kFlat), kFlat, 0, (cudaStream_t)stream>>>(
        x, idx, out, rows, lanes);
  }
  return (int)cudaGetLastError();
}
'''
# variant -> (kernel text or None to keep, launcher text or None, other substitutions)
VARIANTS = {
    "kernel": (None, None, []),
    "rows32": (None, None, [("constexpr int kSubRows = 64;", "constexpr int kSubRows = 32;")]),
    "rows128": (None, None, [("constexpr int kSubRows = 64;", "constexpr int kSubRows = 128;")]),
    "lanes16": (None, None, [("constexpr int kSubRows = 64;", "constexpr int kSubRows = 32;"),
                             ("constexpr int kSubLanes = 8;", "constexpr int kSubLanes = 16;")]),
    "flat": (FLAT, FLAT_LAUNCHER, []),
    "strip": (STRIP.replace("ROWS_PER_BLOCK", "64"), STRIP_LAUNCHER, []),
    "strip_rows128": (STRIP.replace("ROWS_PER_BLOCK", "128"), STRIP_LAUNCHER, []),
    "cluster": (CLUSTER, CLUSTER_LAUNCHER,
                [("#include <cuda_runtime.h>\n",
                  "#include <cooperative_groups.h>\n#include <cuda_runtime.h>\n")]),
}
# (rows, lanes) of the ragged tables each variant is also checked on
RAGGED = [(37, 13), (600, 130), (2000, 20)]


def _span(src: str, head: str) -> tuple[int, int]:
    """The [start, end) of the function that starts at `head` (through its
    closing brace at the start of a line); `head` must occur once."""
    if src.count(head) != 1:
        raise ValueError(f"{head!r} occurs {src.count(head)} times in the source")
    start = src.index(head)
    return start, src.index("\n}\n", start) + 3


def variant_source(name: str, src: str) -> str:
    """`src` with variant `name`'s subgather kernel, launcher and
    substitutions; each substitution must match exactly once."""
    kernel, launcher, subs = VARIANTS[name]
    if launcher is not None:
        start, end = _span(src, LAUNCHER_HEAD)
        src = src[:start] + launcher + src[end:]
    if kernel is not None:
        start, end = _span(src, KERNEL_HEAD)
        head = src.rindex("constexpr int kSubRows", 0, start)
        src = src[:head] + kernel + src[end:]
    for old, new in subs:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} occurs {src.count(old)} times")
        src = src.replace(old, new)
    return src


def build_variant(name: str, text: str):
    """Build `text` as build/kernels/ablate/gather_<name>.cu; returns its
    bound `subgather_f32`."""
    lib, _ = build_text(f"gather_{name}", text)
    fn = lib.subgather_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_tables(seed: int = 0) -> list[tuple[np.ndarray, np.ndarray]]:
    """The probe's table with its indices and with 5% of them negative or
    out of range, then the ragged tables with indices in [-rows - 3, rows + 3)."""
    rng = np.random.default_rng(seed)
    x, idx = gather_tables(seed)["subgather"]
    bad = idx.copy()
    pick = rng.random(idx.shape) < 0.05
    bad[pick] = rng.choice([-1, -ROWS, ROWS, ROWS + 7, -ROWS - 1, 2**31 - 1, -2**31],
                           int(pick.sum()))
    tables = [(x, idx), (x, bad)]
    for rows, lanes in RAGGED:
        tables.append((rng.standard_normal((rows, lanes), dtype=np.float32),
                       rng.integers(-rows - 3, rows + 3, (rows, lanes), dtype=np.int32)))
    return tables


def main(argv=None, iters: int = 50) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", nargs="*", default=[],
                        help="other sources with the subgather_f32 launcher")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this probe needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    src = (CSRC / "gather_probe.cu").read_text()
    texts = {name: variant_source(name, src) for name in VARIANTS}
    texts.update({f"against_{Path(p).stem}": Path(p).read_text() for p in args.against})
    with ThreadPoolExecutor(max_workers=len(texts)) as pool:
        fns = dict(zip(texts, pool.map(lambda n: build_variant(n, texts[n]), texts)))

    def call(fn, x, idx, out):
        def run():
            err = fn(x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"subgather_f32 launch failed: cudaError {err}")
            return out
        return run

    for xn, idxn in check_tables():
        x, idx = torch.from_numpy(xn).cuda(), torch.from_numpy(idxn).cuda()
        ref = subgather_plain(x, idx)
        nan = torch.isnan(ref)
        for name, fn in fns.items():
            got = call(fn, x, idx, torch.empty_like(x))()
            torch.cuda.synchronize()
            if not (torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan], ref[~nan])):
                raise AssertionError(f"subgather variant {name} differs from the plain version "
                                     f"at {tuple(x.shape)}")
    print(f"every variant equals the plain version on {len(check_tables())} tables", flush=True)

    floor = launch_floor_ms()
    xn, idxn = gather_tables()["subgather"]
    x, idx = torch.from_numpy(xn).cuda(), torch.from_numpy(idxn).cuda()
    idx64 = idx.long()
    bound = gather_bound(x)[0]
    runs = {name: call(fn, x, idx, torch.empty_like(x)) for name, fn in fns.items()}
    runs["torch.gather"] = lambda: torch.gather(x, 0, idx64)
    names = list(runs)
    times = {name: [] for name in names}
    for order in (names, names[::-1], names):
        for name in order:
            times[name].append(device_ms(runs[name], iters=iters)[0])
    floor_bound = None if floor is None else max(floor, bound)
    for name, turns in times.items():
        shown = " / ".join("none" if t is None else f"{1e3 * t:.3f}" for t in turns)
        print(f"subgather {tuple(x.shape)} {name:24s} device {shown} us; launch floor "
              f"{'not measured' if floor is None else f'{1e3 * floor:.3f} us'}, bytes bound "
              f"{1e3 * bound:.3f} us; {smi}", flush=True)
    return {"times": times, "floor_ms": floor, "floor_bound_ms": floor_bound, "bound_ms": bound}


if __name__ == "__main__":
    main()
