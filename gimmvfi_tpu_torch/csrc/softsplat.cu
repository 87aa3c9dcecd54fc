// Bilinear forward splat, sum core (float32), for sm_90a.
//
// Replaces gimmvfi_tpu/ops/splat_pallas.py:splat_corners_sorted (the TPU's
// sorted-window Pallas kernel). It computes the same function, not the same
// design: the TPU sorts by destination and scatters with a 4-hot matmul
// because TPU scatter is slow; on Hopper a float atomicAdd to global memory
// is cheap, so each source pixel adds its 4 weighted corners directly.
//
// out[n, y, x, :] += vals[n, i, j, :] * w_corner for each of the 4 bilinear
// corners (x, y) around (j + u, i + v). Corners outside the frame are
// dropped; a non-finite position is sent to (-10, -10), off the canvas. The
// geometry follows splat_pallas.py:150-175 in float32, in the same order.
// The caller zeroes `out`.
//
// What bounds it on the H100: at 736x1280 with C = 17 one call reads about
// 19 x 4 B per pixel (~72 MB) and issues 4 x 17 float atomics per pixel
// (~64 M). The design answers that with one geometry computation per
// pixel, channel-contiguous reads, and runs of up to 32 channels per thread.
//
// The order of the atomic adds changes from run to run, so the result is
// not bit-deterministic, unlike the JAX version; it agrees with the plain
// version to float32 rounding. A deterministic sort-and-reduce mode is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannelRun = 32;
constexpr int kThreads = 256;

__global__ void splat_sum_kernel(const float* __restrict__ vals,
                                 const float* __restrict__ flow,
                                 float* __restrict__ out,
                                 int n, int h, int w, int c, int runs) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)n * h * w * runs;
  if (tid >= total) return;
  const int run = (int)(tid % runs);
  const int64_t p = tid / runs;  // (b * h + i) * w + j
  const int j = (int)(p % w);
  const int i = (int)((p / w) % h);
  const int64_t img = p / ((int64_t)h * w);

  float x = (float)j + flow[2 * p];
  float y = (float)i + flow[2 * p + 1];
  if (!(isfinite(x) && isfinite(y))) {
    x = -10.0f;
    y = -10.0f;
  }
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx1 = x - x0f;
  const float wy1 = y - y0f;
  const float wx0 = 1.0f - wx1;
  const float wy0 = 1.0f - wy1;
  // clamp before the int conversion: it keeps every in-bounds decision and
  // avoids overflow for positions far outside the frame
  const int x0 = (int)fminf(fmaxf(x0f, -2.0f), (float)w);
  const int y0 = (int)fminf(fmaxf(y0f, -2.0f), (float)h);

  const int cx[4] = {x0, x0 + 1, x0, x0 + 1};
  const int cy[4] = {y0, y0, y0 + 1, y0 + 1};
  const float cw[4] = {wx0 * wy0, wx1 * wy0, wx0 * wy1, wx1 * wy1};

  const int c_begin = run * kChannelRun;
  const int c_end = min(c, c_begin + kChannelRun);
  const float* src = vals + p * c;
  float v[kChannelRun];
#pragma unroll
  for (int k = 0; k < kChannelRun; ++k) {
    v[k] = (c_begin + k < c_end) ? src[c_begin + k] : 0.0f;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (cx[q] < 0 || cx[q] >= w || cy[q] < 0 || cy[q] >= h) continue;
    float* dst = out + ((img * h + cy[q]) * w + cx[q]) * c;
#pragma unroll
    for (int k = 0; k < kChannelRun; ++k) {
      if (c_begin + k < c_end) atomicAdd(dst + c_begin + k, v[k] * cw[q]);
    }
  }
}

}  // namespace

// vals (N, H, W, C), flow (N, H, W, 2), out (N, H, W, C): contiguous float32
// device pointers. Launches on `stream`; returns cudaGetLastError().
extern "C" int softsplat_sum_f32(const float* vals, const float* flow,
                                 float* out, int n, int h, int w, int c,
                                 void* stream) {
  const int runs = (c + kChannelRun - 1) / kChannelRun;
  const int64_t total = (int64_t)n * h * w * runs;
  if (total > 0) {
    const int64_t blocks = (total + kThreads - 1) / kThreads;
    splat_sum_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        vals, flow, out, n, h, w, c, runs);
  }
  return (int)cudaGetLastError();
}
