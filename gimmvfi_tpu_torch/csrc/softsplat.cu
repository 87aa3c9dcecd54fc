// Bilinear forward splat, sum core (float32), for sm_90a.
//
// Replaces gimmvfi_tpu/ops/splat_pallas.py:splat_corners_sorted (the TPU's
// sorted-window Pallas kernel). It computes the same function, not the same
// design: the TPU sorts by destination and scatters with a 4-hot matmul
// because TPU scatter is slow; on Hopper a float atomic add to global memory
// is cheap, so each source value adds its 4 weighted corners directly.
//
// out[n, y, x, :] += vals[n, i, j, :] * w_corner for each of the 4 bilinear
// corners (x, y) around (j + u, i + v). Corners outside the frame are
// dropped; a non-finite position is sent to (-10, -10), off the canvas. The
// geometry follows splat_pallas.py:150-175 in float32, in the same order.
// The caller zeroes `out`.
//
// What bounds it on the H100: at (1, 736, 1280, 17) one call must read vals
// and flow (72 MB) and write the output (64 MB), 135.7 MB in all, 0.0405 ms
// at 3.35 TB/s. In practice it is the L2's rate of atomic sector updates:
// 4 x 17 float atomics a pixel, 64 M a call. One atomic instruction of a
// warp costs one L2 update for each 32-byte sector its 32 addresses touch.
//
// The design: a block owns kPixels consecutive source pixels (raster order).
//   1. One thread a pixel reads its flow (float2, coalesced), computes the 4
//      destination pixel indices and weights once, and leaves them in shared
//      memory. A masked corner gets index -1 and issues no atomic.
//   2. The block then walks its kPixels x C values as one flat range:
//      consecutive lanes take consecutive elements, so loads are coalesced
//      and a warp-wide atomic covers the contiguous channels of about two
//      pixels (a few sectors) instead of 32 pixels 4C bytes apart. Each
//      element reads its pixel's geometry from shared memory (a broadcast)
//      and issues 4 atomicAdds whose result is unused (RED.E.ADD.F32).
// No thread keeps a channel array; the (pixel, channel) pair of the next
// element is stepped, not divided.
//
// Measured at (1, 736, 1280, 17), flow std 20, on an NVIDIA H100 80GB HBM3
// at a 700 W power limit (tools/splat_ablate.py): 0.19 ms, 21% of the
// bound, against 0.75 ms for one thread a pixel. Without any load it keeps
// 94% of that time, and float2 or float4 atomics (into an output padded to
// their width) take about as long: the L2's sector rate is the limit.
// 16-byte loads spread a warp's atomic over 4x the pixels and are 2.6x
// slower; 256 pixels a block is 1-2% slower than 128.
//
// The order of the atomic adds changes from run to run, so the result is
// not bit-deterministic, unlike the JAX version; it agrees with the plain
// version to float32 rounding. csrc/softsplat_sorted.cu, sorted and
// summed in a fixed order, is the route of every path; this kernel is on
// none and is timed beside it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPixels = 128;  // source pixels a block owns = threads a block

// Adds one source value into its pixel's 4 corners.
__device__ __forceinline__ void splat_value(float v, int4 dst, float4 wgt, int c, int ch,
                                            float* __restrict__ out) {
  if (dst.x >= 0) atomicAdd(out + (int64_t)dst.x * c + ch, v * wgt.x);
  if (dst.y >= 0) atomicAdd(out + (int64_t)dst.y * c + ch, v * wgt.y);
  if (dst.z >= 0) atomicAdd(out + (int64_t)dst.z * c + ch, v * wgt.z);
  if (dst.w >= 0) atomicAdd(out + (int64_t)dst.w * c + ch, v * wgt.w);
}

__global__ void __launch_bounds__(kPixels)
splat_sum_kernel(const float* __restrict__ vals, const float2* __restrict__ flow,
                 float* __restrict__ out, int npix, int h, int w, int c) {
  __shared__ int4 s_dst[kPixels];    // destination pixel of each corner, -1 if masked
  __shared__ float4 s_wgt[kPixels];  // bilinear weight of each corner

  const int t = threadIdx.x;
  const int p0 = blockIdx.x * kPixels;
  const int np = min(kPixels, npix - p0);

  if (t < np) {
    const int p = p0 + t;  // (b * h + i) * w + j
    const int j = p % w;
    const int i = (p / w) % h;
    const int img0 = p - (i * w + j);  // the image's first pixel
    const float2 f = flow[p];
    float x = (float)j + f.x;
    float y = (float)i + f.y;
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
    const bool xin0 = x0 >= 0 && x0 < w, xin1 = x0 + 1 >= 0 && x0 + 1 < w;
    const bool yin0 = y0 >= 0 && y0 < h, yin1 = y0 + 1 >= 0 && y0 + 1 < h;
    const int base = img0 + y0 * w + x0;
    s_dst[t] = make_int4(xin0 && yin0 ? base : -1, xin1 && yin0 ? base + 1 : -1,
                         xin0 && yin1 ? base + w : -1, xin1 && yin1 ? base + w + 1 : -1);
    s_wgt[t] = make_float4(wx0 * wy0, wx1 * wy0, wx0 * wy1, wx1 * wy1);
  }
  __syncthreads();

  const float* __restrict__ src = vals + (int64_t)p0 * c;
  const int m = np * c;  // values this block owns
  const int dq = kPixels / c, dr = kPixels % c;
  int q = t / c, r = t % c;  // pixel and channel of the lane's value
#pragma unroll 4
  for (int e = t; e < m; e += kPixels) {
    splat_value(src[e], s_dst[q], s_wgt[q], c, r, out);
    q += dq;
    r += dr;
    if (r >= c) {
      r -= c;
      ++q;
    }
  }
}

}  // namespace

// vals (N, H, W, C), flow (N, H, W, 2), out (N, H, W, C): contiguous float32
// device pointers, 16-byte aligned; N*H*W below 2**31 and 1 <= C <= 2**22
// (a block's kPixels x C values are counted in an int). Launches on
// `stream`; returns cudaGetLastError().
extern "C" int softsplat_sum_f32(const float* vals, const float* flow,
                                 float* out, int n, int h, int w, int c,
                                 void* stream) {
  const int64_t npix = (int64_t)n * h * w;
  if (npix >= ((int64_t)1 << 31) || c < 1 || c > (1 << 22)) return (int)cudaErrorInvalidValue;
  if (npix > 0) {
    const int blocks = (int)((npix + kPixels - 1) / kPixels);
    splat_sum_kernel<<<blocks, kPixels, 0, (cudaStream_t)stream>>>(
        vals, reinterpret_cast<const float2*>(flow), out, (int)npix, h, w, c);
  }
  return (int)cudaGetLastError();
}
