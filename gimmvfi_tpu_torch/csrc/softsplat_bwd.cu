// Bilinear forward splat, backward of the sum core (float32), for sm_90a.
//
// Replaces gimmvfi_tpu/ops/softsplat.py:_splat_pallas_bwd, the gather-form
// VJP that the TPU's sorted-window splat kernel (splat_pallas.py) carries as
// a jax.custom_vjp. It computes the same function: with out the forward's
// output and g = d loss / d out,
//   d_vals[p, c] = sum_k w_k m_k g[corner_k(p), c]          (a bilinear gather)
//   s_k[p]       = sum_c vals[p, c] g[corner_k(p), c]
//   d_flow[p]    = (-wy0 m00 s00 + wy0 m01 s01 - wy1 m10 s10 + wy1 m11 s11,
//                   -wx0 m00 s00 - wx1 m01 s01 + wx0 m10 s10 + wx1 m11 s11)
// over the 4 bilinear corners k of the splat position (j + u, i + v), with
// m_k 1 where the corner lies in the frame. The geometry is the forward
// kernel's (softsplat.cu), in the same float32 order: a non-finite position
// goes to (-10, -10), and positions are clamped to [-2, size] before the
// integer conversion. Each source pixel owns its outputs: no atomic touches
// global memory.
//
// What bounds it on the H100: at (32, 256, 256, 17), stage-1 GIMM's training
// splat, one call must read vals, flow and g and write d_vals and d_flow,
// 461 MB, 0.138 ms at 3.35 TB/s. Without d_flow it reads flow and g and
// writes d_vals, 302 MB. The gathers of g touch each destination's channels
// up to 4 times; L1 and L2 catch most of that for smooth flows.
//
// The design follows the forward kernel's: a block owns kPixels consecutive
// source pixels (raster order).
//   1. One thread a pixel reads its flow (float2, coalesced), computes the 4
//      corner indices and weights once and leaves them in shared memory; it
//      keeps its own bilinear factors in registers for step 3.
//   2. The block walks its kPixels x C values as one flat range in rounds of
//      kPixels: consecutive lanes take consecutive elements, so vals is read
//      and d_vals written coalesced, and the gathers of g read contiguous
//      channels of a few destination pixels a warp. Each element writes its
//      d_vals value and, when d_flow is asked for, its 4 products
//      vals * g_k. A segmented sum over the warp's lanes (shuffles, keyed by
//      pixel) leaves each pixel's share of the round in its first lane,
//      which adds it into the pixel's 4 sums in shared memory: a pixel's C
//      channels meet in ceil(C / 32) + 1 such adds at most.
//   3. One thread a pixel reads its 4 sums and writes d_flow (float2).
//
// Determinism: d_vals is bit-deterministic (each element sums its 4 corners
// in a fixed order). d_flow is not: the shared-memory adds of step 2 from
// different warps land in the order the warps run. Both agree with the plain
// version (ops/softsplat.py: splat_sum_backward_plain) to float32 rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPixels = 128;  // source pixels a block owns = threads a block
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float gather(const float* __restrict__ g, int dst, int c, int ch) {
  return dst >= 0 ? __ldg(g + (int64_t)dst * c + ch) : 0.0f;
}

__global__ void __launch_bounds__(kPixels)
splat_sum_bwd_kernel(const float* __restrict__ vals, const float2* __restrict__ flow,
                     const float* __restrict__ g, float* __restrict__ d_vals,
                     float2* __restrict__ d_flow, int npix, int h, int w, int c) {
  __shared__ int4 s_dst[kPixels];     // destination pixel of each corner, -1 if masked
  __shared__ float4 s_wgt[kPixels];   // bilinear weight of each corner
  __shared__ float s_sum[4][kPixels];  // s_k of each pixel

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int p0 = blockIdx.x * kPixels;
  const int np = min(kPixels, npix - p0);
  const bool want_flow = d_flow != nullptr;

  float wx0 = 0.0f, wx1 = 0.0f, wy0 = 0.0f, wy1 = 0.0f;
  int4 dst = make_int4(-1, -1, -1, -1);
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
    wx1 = x - x0f;
    wy1 = y - y0f;
    wx0 = 1.0f - wx1;
    wy0 = 1.0f - wy1;
    const int x0 = (int)fminf(fmaxf(x0f, -2.0f), (float)w);
    const int y0 = (int)fminf(fmaxf(y0f, -2.0f), (float)h);
    const bool xin0 = x0 >= 0 && x0 < w, xin1 = x0 + 1 >= 0 && x0 + 1 < w;
    const bool yin0 = y0 >= 0 && y0 < h, yin1 = y0 + 1 >= 0 && y0 + 1 < h;
    const int base = img0 + y0 * w + x0;
    dst = make_int4(xin0 && yin0 ? base : -1, xin1 && yin0 ? base + 1 : -1,
                    xin0 && yin1 ? base + w : -1, xin1 && yin1 ? base + w + 1 : -1);
    s_dst[t] = dst;
    s_wgt[t] = make_float4(wx0 * wy0, wx1 * wy0, wx0 * wy1, wx1 * wy1);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) s_sum[k][t] = 0.0f;
  __syncthreads();

  const float* __restrict__ src = vals + (int64_t)p0 * c;
  float* __restrict__ dv = d_vals + (int64_t)p0 * c;
  const int m = np * c;  // values this block owns
  const int rounds = (m + kPixels - 1) / kPixels;  // the same for every lane
  const int dq = kPixels / c, dr = kPixels % c;
  int q = t / c, r = t % c;  // pixel and channel of the lane's value
  for (int it = 0; it < rounds; ++it) {
    const int e = it * kPixels + t;
    const bool live = e < m;
    float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f, g3 = 0.0f;
    if (live) {
      const int4 d = s_dst[q];
      const float4 wt = s_wgt[q];
      g0 = gather(g, d.x, c, r);
      g1 = gather(g, d.y, c, r);
      g2 = gather(g, d.z, c, r);
      g3 = gather(g, d.w, c, r);
      dv[e] = wt.x * g0 + wt.y * g1 + wt.z * g2 + wt.w * g3;
    }
    if (want_flow) {  // uniform over the block: every lane shuffles
      const float v = live ? src[e] : 0.0f;
      float a0 = v * g0, a1 = v * g1, a2 = v * g2, a3 = v * g3;
      const int key = live ? q : -1 - lane;  // a dead lane is a segment of its own
      // after the step of offset o, a lane holds the sum of its segment's
      // lanes in [lane, lane + 2o): at the end the segment's first lane
      // holds the whole segment
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int ko = __shfl_down_sync(kFullMask, key, o);
        const float b0 = __shfl_down_sync(kFullMask, a0, o);
        const float b1 = __shfl_down_sync(kFullMask, a1, o);
        const float b2 = __shfl_down_sync(kFullMask, a2, o);
        const float b3 = __shfl_down_sync(kFullMask, a3, o);
        if (lane + o < 32 && ko == key) {
          a0 += b0;
          a1 += b1;
          a2 += b2;
          a3 += b3;
        }
      }
      const int kprev = __shfl_up_sync(kFullMask, key, 1);
      if (live && (lane == 0 || kprev != key)) {
        atomicAdd(&s_sum[0][q], a0);
        atomicAdd(&s_sum[1][q], a1);
        atomicAdd(&s_sum[2][q], a2);
        atomicAdd(&s_sum[3][q], a3);
      }
    }
    q += dq;
    r += dr;
    if (r >= c) {
      r -= c;
      ++q;
    }
  }

  if (!want_flow) return;
  __syncthreads();
  if (t < np) {
    const float m00 = dst.x >= 0 ? 1.0f : 0.0f, m01 = dst.y >= 0 ? 1.0f : 0.0f;
    const float m10 = dst.z >= 0 ? 1.0f : 0.0f, m11 = dst.w >= 0 ? 1.0f : 0.0f;
    const float s00 = s_sum[0][t], s01 = s_sum[1][t], s10 = s_sum[2][t], s11 = s_sum[3][t];
    const float du = -wy0 * m00 * s00 + wy0 * m01 * s01 - wy1 * m10 * s10 + wy1 * m11 * s11;
    const float dvv = -wx0 * m00 * s00 - wx1 * m01 * s01 + wx0 * m10 * s10 + wx1 * m11 * s11;
    d_flow[p0 + t] = make_float2(du, dvv);
  }
}

}  // namespace

// vals, g, d_vals (N, H, W, C) and flow, d_flow (N, H, W, 2): contiguous
// float32 device pointers, 16-byte aligned; N*H*W below 2**31 and
// 1 <= C <= 2**22. d_flow may be null: then only d_vals is computed and vals
// is not read. Writes every element of d_vals (and d_flow). Launches on
// `stream`; returns cudaGetLastError().
extern "C" int softsplat_sum_bwd_f32(const float* vals, const float* flow, const float* g,
                                     float* d_vals, float* d_flow, int n, int h, int w, int c,
                                     void* stream) {
  const int64_t npix = (int64_t)n * h * w;
  if (npix >= ((int64_t)1 << 31) || c < 1 || c > (1 << 22)) return (int)cudaErrorInvalidValue;
  if (npix > 0) {
    const int blocks = (int)((npix + kPixels - 1) / kPixels);
    splat_sum_bwd_kernel<<<blocks, kPixels, 0, (cudaStream_t)stream>>>(
        vals, reinterpret_cast<const float2*>(flow), g, d_vals,
        reinterpret_cast<float2*>(d_flow), (int)npix, h, w, c);
  }
  return (int)cudaGetLastError();
}
