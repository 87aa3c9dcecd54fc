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
// over the 4 bilinear corners k of the splat position (j + u, i + v), in the
// order (0,0), (1,0), (0,1), (1,1), with m_k 1 where the corner lies in the
// frame. The geometry is the forward kernel's (softsplat.cu), in the same
// float32 order: a non-finite position goes to (-10, -10), and positions
// are clamped to [-2, size] before the integer conversion. Each source pixel
// owns its outputs: no atomic is used anywhere.
//
// What bounds it on the H100: at (32, 256, 256, 17), stage-1 GIMM's training
// splat, one call must read vals, flow and g and write d_vals and d_flow,
// 461 MB, 0.138 ms at 3.35 TB/s. Without d_flow (every path's mode: the
// flows carry no gradient) it reads flow and g and writes d_vals, 302 MB,
// 0.090 ms. The gathers of g read each destination's channels up to 4
// times; L1 and L2 catch most of that, but for a random field of std 8 px
// each source pixel still pulls its two corner pairs (2 x 136 B) into L1
// from L2, so the L2-to-SM traffic, not the device memory, is what the
// gathers cost (tools/splat_ablate.py --backward: one gather instead of
// four takes a fifth off the d_vals mode).
//
// Design: a block owns a tile of kPixels source pixels of one image: a run
// of one row without d_flow, kTileRowsFlow rows with it (the 2D tile was
// slower on a random field without d_flow, and faster with it).
//   1. One thread a pixel reads its flow (float2, coalesced along a tile
//      row), computes the 4 corner indices and weights once and leaves them,
//      with the pixel's own index, in shared memory.
//   2. The block walks the tile's (pixel, channel) values as one flat range:
//      consecutive lanes take consecutive channels, so each gather of g reads
//      contiguous channels of a few destination pixels a warp, and d_vals is
//      written in runs of a pixel's channels. A thread loads kUnrollVals
//      (kUnrollFlow with d_flow) values before it uses them: without d_flow
//      a full SM of 31-38-register threads hides the latency better than
//      more loads a thread.
//   3. With d_flow, the walk goes over chunks of at most kPitch channels and
//      also reads vals (coalesced) and leaves the 4 products vals * g_k of
//      each value in shared memory as one float4, at a pixel pitch of kPitch
//      float4s (odd, so step 4 is free of bank conflicts). After each chunk,
//      the thread of each pixel adds its products into its 4 sums s_k in
//      registers, in channel order. Chunks of 9 and a cap of 64 registers
//      let 8 blocks share an SM.
//   4. That thread writes d_flow (float2).
// Without d_flow the kernel reads no vals, keeps no products and walks all
// channels at once.
//
// Determinism: both outputs are bit-deterministic. Every d_vals value sums
// its 4 corners in a fixed order, and every s_k is summed by one thread in
// channel order. Both agree with the plain version
// (ops/softsplat.py: splat_sum_backward_plain) to float32 rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPixels = 128;       // source pixels of a block's tile = threads a block
constexpr int kTileRowsVals = 1;   // d_vals alone: the tile is a run of one image row
constexpr int kTileRowsFlow = 4;   // with d_flow: 4 rows of 32 pixels
constexpr int kUnrollVals = 1;     // values a thread loads before it uses them, d_vals alone
constexpr int kUnrollFlow = 4;     // the same with d_flow
constexpr int kPitch = 9;          // channels of a d_flow chunk, and its pitch in float4 (odd)
constexpr int kMinBlocksFlow = 8;  // blocks an SM the d_flow kernel's registers must allow

__device__ __forceinline__ float gather(const float* __restrict__ g, int dst, int c, int ch) {
  return dst >= 0 ? __ldg(g + (int64_t)dst * c + ch) : 0.0f;
}

// Step 2 (and 3 with kFlow) over channels [c0, c0 + ck) of the tile's np
// pixels: value e = q * ck + r is channel c0 + r of the tile's pixel q.
template <bool kFlow, int kUnroll = kFlow ? kUnrollFlow : kUnrollVals>
__device__ __forceinline__ void walk(const float* __restrict__ vals, const float* __restrict__ g,
                                     float* __restrict__ d_vals, const int* s_src,
                                     const int4* s_dst, const float4* s_wgt, float4* s_prod,
                                     int np, int c, int c0, int ck) {
  const int t = threadIdx.x;
  const int m = np * ck;
  const int dq = kPixels / ck, dr = kPixels % ck;
  int q = t / ck, r = t % ck;
  for (int e0 = t; e0 < m; e0 += kUnroll * kPixels) {
    float gk[kUnroll][4], v[kUnroll];
    int qs[kUnroll], rs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      int4 d = make_int4(-1, -1, -1, -1);
      v[u] = 0.0f;
      qs[u] = -1;  // no value
      rs[u] = r;
      if (e0 + u * kPixels < m) {
        qs[u] = q;
        d = s_dst[q];
        if constexpr (kFlow) v[u] = __ldg(vals + (int64_t)s_src[q] * c + c0 + r);
      }
      gk[u][0] = gather(g, d.x, c, c0 + r);
      gk[u][1] = gather(g, d.y, c, c0 + r);
      gk[u][2] = gather(g, d.z, c, c0 + r);
      gk[u][3] = gather(g, d.w, c, c0 + r);
      q += dq;
      r += dr;
      if (r >= ck) {
        r -= ck;
        ++q;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (qs[u] < 0) continue;
      const float4 wt = s_wgt[qs[u]];
      d_vals[(int64_t)s_src[qs[u]] * c + c0 + rs[u]] =
          wt.x * gk[u][0] + wt.y * gk[u][1] + wt.z * gk[u][2] + wt.w * gk[u][3];
      if constexpr (kFlow) {
        s_prod[qs[u] * kPitch + rs[u]] =
            make_float4(v[u] * gk[u][0], v[u] * gk[u][1], v[u] * gk[u][2], v[u] * gk[u][3]);
      }
    }
  }
}

template <bool kFlow>
__global__ void __launch_bounds__(kPixels, kFlow ? kMinBlocksFlow : 1)
splat_sum_bwd_kernel(const float* __restrict__ vals, const float2* __restrict__ flow,
                     const float* __restrict__ g, float* __restrict__ d_vals,
                     float2* __restrict__ d_flow, int h, int w, int c, int tiles_x,
                     int tiles_y) {
  constexpr int kRows = kFlow ? kTileRowsFlow : kTileRowsVals, kCols = kPixels / kRows;
  __shared__ int s_src[kPixels];     // the global index of the tile's pixel q
  __shared__ int4 s_dst[kPixels];    // destination pixel of each corner, -1 if masked
  __shared__ float4 s_wgt[kPixels];  // bilinear weight of each corner
  __shared__ float4 s_prod[kFlow ? kPixels * kPitch : 1];  // vals * g_k for k = 0..3, [q][r]

  const int t = threadIdx.x;
  // the tile: image b, rows [i0, i0 + rows), columns [j0, j0 + cols); its
  // pixels are numbered row by row, q = (i - i0) * cols + (j - j0)
  const int tx = blockIdx.x % tiles_x;
  const int ty = (blockIdx.x / tiles_x) % tiles_y;
  const int b = blockIdx.x / tiles_x / tiles_y;
  const int i0 = ty * kRows, j0 = tx * kCols;
  const int rows = min(kRows, h - i0), cols = min(kCols, w - j0);
  const int np = rows * cols;

  float wx0 = 0.0f, wx1 = 0.0f, wy0 = 0.0f, wy1 = 0.0f;
  int4 dst = make_int4(-1, -1, -1, -1);
  int p = 0;
  if (t < np) {
    const int i = i0 + t / cols, j = j0 + t % cols;
    const int img0 = b * h * w;  // the image's first pixel
    p = img0 + i * w + j;
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
    s_src[t] = p;
    s_dst[t] = dst;
    s_wgt[t] = make_float4(wx0 * wy0, wx1 * wy0, wx0 * wy1, wx1 * wy1);
  }
  __syncthreads();

  if constexpr (!kFlow) {
    walk<false>(vals, g, d_vals, s_src, s_dst, s_wgt, s_prod, np, c, 0, c);
  } else {
    float s00 = 0.0f, s01 = 0.0f, s10 = 0.0f, s11 = 0.0f;
    for (int c0 = 0; c0 < c; c0 += kPitch) {
      const int ck = min(kPitch, c - c0);
      walk<true>(vals, g, d_vals, s_src, s_dst, s_wgt, s_prod, np, c, c0, ck);
      __syncthreads();
      if (t < np) {
        const float4* sp = s_prod + t * kPitch;
        for (int r = 0; r < ck; ++r) {
          const float4 a = sp[r];
          s00 += a.x;
          s01 += a.y;
          s10 += a.z;
          s11 += a.w;
        }
      }
      __syncthreads();
    }
    if (t < np) {
      const float m00 = dst.x >= 0 ? 1.0f : 0.0f, m01 = dst.y >= 0 ? 1.0f : 0.0f;
      const float m10 = dst.z >= 0 ? 1.0f : 0.0f, m11 = dst.w >= 0 ? 1.0f : 0.0f;
      const float du = -wy0 * m00 * s00 + wy0 * m01 * s01 - wy1 * m10 * s10 + wy1 * m11 * s11;
      const float dv = -wx0 * m00 * s00 - wx1 * m01 * s01 + wx0 * m10 * s10 + wx1 * m11 * s11;
      d_flow[p] = make_float2(du, dv);
    }
  }
}

template <bool kFlow>
void launch_bwd(const float* vals, const float2* flow, const float* g, float* d_vals,
                float2* d_flow, int n, int h, int w, int c, cudaStream_t stream) {
  constexpr int kRows = kFlow ? kTileRowsFlow : kTileRowsVals, kCols = kPixels / kRows;
  const int tiles_x = (w + kCols - 1) / kCols;
  const int tiles_y = (h + kRows - 1) / kRows;
  const int blocks = (int)((int64_t)n * tiles_x * tiles_y);
  splat_sum_bwd_kernel<kFlow><<<blocks, kPixels, 0, stream>>>(vals, flow, g, d_vals, d_flow, h,
                                                               w, c, tiles_x, tiles_y);
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
    const float2* f = reinterpret_cast<const float2*>(flow);
    if (d_flow != nullptr) {
      launch_bwd<true>(vals, f, g, d_vals, reinterpret_cast<float2*>(d_flow), n, h, w, c,
                       (cudaStream_t)stream);
    } else {
      launch_bwd<false>(vals, f, g, d_vals, nullptr, n, h, w, c, (cudaStream_t)stream);
    }
  }
  return (int)cudaGetLastError();
}
