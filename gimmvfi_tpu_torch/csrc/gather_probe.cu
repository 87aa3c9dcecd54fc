// The gather probe's three kernels on a (rows, lanes) float32 table with an
// int32 index table of the same shape, for sm_90a.
//
// Replaces the Pallas bodies of tools/gather_cost_probe.py:
//   subgather      (subgather_kernel)      out[i, j] = x[idx[i, j], j]
//   subgather_grid (subgather_big_kernel)  out[i, j] = x[(i / 512) * 512 + idx[i, j] mod 512, j]
//                                          (the mod is the JAX wrapper's `idx % 512`)
//   lanegather     (lanegather_kernel)     out[i, j] = x[i, idx[i, j]]
// Indices follow jnp.take_along_axis: a negative index counts from the end
// (idx + n), and an index outside [-n, n) reads nothing and writes NaN, its
// fill for floats. So a bad index can never read out of bounds.
//
// On the TPU these probed whether Mosaic lowers an in-VMEM gather; on
// Hopper a gather is a plain indexed load. What bounds them: bytes (x, idx
// and out once each, 12 B an element). At the probe's 512x128 that is
// 0.8 MB, under a microsecond at 3.35 TB/s and under one launch (the floor,
// an empty kernel, is 0.87 us on an H100 80GB HBM3 at 700 W); at 8192x128,
// 12.6 MB, 3.8 us.
//
// One thread per output element, lanes on neighbouring threads, so the idx
// reads and out writes coalesce; the x reads of a row gather land on a
// different row for each lane, one 32-byte sector each, but the probe's
// tables (256 KB and 4 MB) sit in the 50 MB L2.
//
// subgather (redesigned): at 512x128 the call is a few L2 round trips
// above the launch floor, the idx load and then the x load it addresses,
// and the x loads fetch a 32-byte sector each for their 4 bytes. So a
// block owns kSubRows rows of one 8-lane sector column: the x loads of its
// 512 outputs fall in that column, and where their rows repeat (about a
// third of them at 512 rows) L1 serves the sector again. Both loads take
// the read-only path (ld.global.nc) and index in 32 bits (the wrapper
// keeps rows * lanes under 2**31). Staging a strip of x's columns in
// shared memory, which saves the second round trip, measured slower on
// the card (tools/gather_ablate.py, its "strip" variants): a block must
// stage all rows of its strip, so each SM reads as many L2 sectors for the
// strip as the direct gather reads for its outputs, and waits for them; a
// cluster that shares one staged strip across 8 blocks ("cluster") pays
// more in its launch and barriers.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 512;  // subgather_grid's row tile (the Pallas BlockSpec)

__device__ __forceinline__ float nan_fill() { return __int_as_float(0x7fc00000); }

constexpr int kSubRows = 64;  // subgather: a block's outputs are kSubRows rows x kSubLanes
constexpr int kSubLanes = 8;  // lanes (one 32-byte sector of each row), a thread an output

__global__ void __launch_bounds__(kSubRows * kSubLanes)
subgather_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                 float* __restrict__ out, int rows, int lanes) {
  const int r = blockIdx.x * kSubRows + threadIdx.x / kSubLanes;
  if (r >= rows) return;
  for (int jb = blockIdx.y; jb * kSubLanes < lanes; jb += gridDim.y) {
    const int j = jb * kSubLanes + threadIdx.x % kSubLanes;
    if (j >= lanes) break;
    const int t = r * lanes + j;
    int v = __ldg(idx + t);
    if (v < 0) v += rows;
    out[t] = (v >= 0 && v < rows) ? __ldg(x + v * lanes + j) : nan_fill();
  }
}

__global__ void subgather_grid_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                                      float* __restrict__ out, int rows, int lanes) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)rows * lanes) return;
  const int64_t i = t / lanes;
  const int j = (int)(t % lanes);
  int v = idx[t] % kTile;
  if (v < 0) v += kTile;  // a floor mod, as jnp's `%`: always in [0, 512)
  out[t] = x[(i / kTile * kTile + v) * lanes + j];
}

__global__ void lanegather_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                                  float* __restrict__ out, int rows, int lanes) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)rows * lanes) return;
  const int64_t i = t / lanes;
  int v = idx[t];
  if (v < 0) v += lanes;
  out[t] = (v >= 0 && v < lanes) ? x[i * lanes + v] : nan_fill();
}

int launch(void (*kernel)(const float*, const int*, float*, int, int), const float* x,
           const int* idx, float* out, int rows, int lanes, void* stream) {
  const int64_t total = (int64_t)rows * lanes;
  if (total > 0) {
    const int64_t blocks = (total + kThreads - 1) / kThreads;
    kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(x, idx, out, rows, lanes);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x (rows, lanes) float32, idx (rows, lanes) int32, out (rows, lanes)
// float32: contiguous device pointers. Launch on `stream`; return
// cudaGetLastError(). subgather_grid_f32 needs rows % 512 == 0.
extern "C" int subgather_f32(const float* x, const int* idx, float* out, int rows, int lanes,
                             void* stream) {
  if ((int64_t)rows * lanes >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  if (rows > 0 && lanes > 0) {
    const dim3 grid((rows + kSubRows - 1) / kSubRows,
                    min((lanes + kSubLanes - 1) / kSubLanes, 65535));
    subgather_kernel<<<grid, kSubRows * kSubLanes, 0, (cudaStream_t)stream>>>(x, idx, out, rows,
                                                                              lanes);
  }
  return (int)cudaGetLastError();
}

extern "C" int subgather_grid_f32(const float* x, const int* idx, float* out, int rows,
                                  int lanes, void* stream) {
  return launch(subgather_grid_kernel, x, idx, out, rows, lanes, stream);
}

extern "C" int lanegather_f32(const float* x, const int* idx, float* out, int rows, int lanes,
                              void* stream) {
  return launch(lanegather_kernel, x, idx, out, rows, lanes, stream);
}
