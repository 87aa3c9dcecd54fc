// Backward of the windowed correlation lookup, for sm_90a.
//
// Replaces the gradient of gimmvfi_tpu/ops/corr.py:windowed_corr_lookup, which
// the JAX package takes by XLA autodiff (an XLA function, no Pallas kernel).
// It computes d_f1, d_levels and d_coords of the lookup of
// csrc/windowed_corr.cu from the output's gradient g; its plain version is
// ops/corr.py:windowed_corr_lookup_backward_plain.
//
// For each query q = (n, p) and level l, with gv[j][i] = g[n, l*(2r+1)^2 +
// i*(2r+1) + j, p] (x offset i outer, as the forward's channels):
//   s[a][b]   = <f1[q], f2_l[y0 + a, x0 + b]>, a tap off the map 0
//   sy[j][b]  = s[j][b] (1 - fy) + s[j+1][b] fy               (the forward's)
//   dsy[j][i] += gv[j][i] (1 - fx),  dsy[j][i+1] += gv[j][i] fx
//   dfx       = sum gv[j][i] (sy[j][i+1] - sy[j][i])
//   ds[j][b]  += dsy[j][b] (1 - fy), ds[j+1][b]  += dsy[j][b] fy
//   dfy       = sum dsy[j][b] (s[j+1][b] - s[j][b])
//   d_f1[q]            += ds[a][b] f2_l[y0 + a, x0 + b]   (taps on the map)
//   d_f2_l[y0+a, x0+b] += ds[a][b] f1[q]                  (taps on the map)
//   d_coords[q]        += (dfx, dfy) / 2^l                (floor: no gradient)
// A query with a non-finite coordinate has NaN fx or fy, so NaN ds: as in
// autograd of the plain lookup, whose taps off the map are zeros times ds,
// its d_f1 is NaN (the kernel adds sum(ds * 0) over the taps off the map to
// every channel) and it adds nothing to d_levels (every tap is off the map).
//
// Layouts as the forward's: f1 (N, P, C) pre-scaled by 1/sqrt(C); level l
// (N, h_l, w_l, C); coords (N, 2, H, W) float32; g (N, L*(2r+1)^2, H, W);
// d_f1 as f1; d_f2_l (N, h_l, w_l, C) float32, zero-filled by the caller;
// d_coords (N, 2, H, W) float32, or null when not needed. f1, the levels, g
// and d_f1 are float32, or bf16; sums are float32.
//
// What bounds it on the H100: for each tap on the map, the dot again (two
// operations a channel, products of the features' type summed in float32:
// the bf16 tensor-core peak of 989 TFLOP/s for bf16, 67 TFLOP/s on the CUDA
// cores for float32) and d_f1's and d_f2's shares (four float32 operations
// a channel, 67 TFLOP/s). At the 2048x1088 DS 1.0 RAFT lookup (N = 2,
// P = 34,816, C = 256, 4 levels, r = 4, in-frame coordinates, bf16) that is
// ~13 GFLOP of dots and ~25 GFLOP of products, ~0.39 ms, where its bytes
// (~0.2 GB) take ~0.06 ms. So it is bound by operations.
//
// The design, simple first: a block of 8 warps owns 8 consecutive queries,
// one a warp, and first stages their rows of g in shared memory (the rows
// are read along P, coalesced; a query's own values lie P apart). The warp
// sweeps the levels. At each it recomputes the (2r+2)^2 dots as
// csrc/windowed_corr.cu does (4 groups of 8 lanes, a tap a group, 8-channel
// chunks a lane, f1's chunks in registers, three shuffles a tap), blends
// back in shared memory (dsy, then ds over the dots), then walks the taps
// again: each group reads its tap's pixel once more, adds ds * f2 into the
// lane's d_f1 chunks (registers) and ds * f1 into d_f2 by 16-byte float32
// atomics (sm_90's float4 atomicAdd: a quarter of the scalar atomics'
// count).
// d_f1 is reduced over the 4 groups by shuffles and written once a query,
// d_coords once a query by lane 0, both in a fixed order; d_levels' atomic
// order changes from call to call. Without d_coords (RAFT's lookups: their
// coordinates are detached) the first walk, the dots, is skipped. A
// destination-ordered d_levels and tensor-core products are later work.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit
// (tools/windowed_ablate.py --bwd, device time): 0.74 ms at the stage-2 AMT
// lookup (4,28,28) float32, 5.17 ms at the 720p F AMT lookup (1,92,160)
// float32, 24.8 ms at the 2048x1088 DS 1.0 RAFT lookup (2,136,256) bf16,
// 1.6-2.2% of the bound. With scalar atomics 2.83, 20.8 and 101-102 ms;
// without d_f2's atomics (not the backward) 0.25, 1.25 and 5.68 ms: the
// atomics are about three quarters of its time. Without d_coords
// (chip_smoke.py phase 7) 0.66, 5.11 and 24.72 ms: the dots' walk hides
// behind the atomics. ptxas: 126-128 registers, no spills, 17,744 B of
// shared memory a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQueries = kWarps;           // consecutive queries a block owns, one a warp
constexpr int kGroup = 8;                  // lanes sharing one tap
constexpr int kTapsPerStep = 32 / kGroup;  // taps a warp takes at once
constexpr int kMaxChunks = 4;              // 8-channel chunks a lane keeps: C <= 256
constexpr int kBlocksPerSM = 2;            // asks ptxas for <= 128 registers
constexpr int kMaxLevels = 4;
constexpr int kMaxRadius = 4;
constexpr int kMaxWin = 2 * kMaxRadius + 1;
constexpr int kMaxSpan = kMaxWin + 1;

struct Levels {
  const void* f2[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

struct LevelGrads {
  float* f2[kMaxLevels];
};

__device__ __forceinline__ void load8(const float* __restrict__ p, float v[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// 8 bf16 values (16 bytes, held as their bits) to float32: a bf16 is the
// high half of a float.
__device__ __forceinline__ void load8(const uint16_t* __restrict__ p, float v[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store8(uint16_t* p, const float v[8]) {
  uint4 u;
  u.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
  u.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
  u.z = bf16_bits(v[4]) | (bf16_bits(v[5]) << 16);
  u.w = bf16_bits(v[6]) | (bf16_bits(v[7]) << 16);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(uint16_t v) { return __uint_as_float((uint32_t)v << 16); }

// Window start floor(c) - r, clamped in float to [-span - 1, size + 1]
// (NaN takes the low end), as the forward's.
__device__ __forceinline__ int window_start(float fl, int radius, int span, int size) {
  return (int)fminf(fmaxf(fl - (float)radius, (float)(-span - 1)), (float)(size + 1));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// T is float, or uint16_t holding bf16 bits.
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
windowed_corr_bwd_kernel(const T* __restrict__ f1, Levels lv, const float* __restrict__ coords,
                         const T* __restrict__ g, T* __restrict__ d_f1, LevelGrads dl,
                         float* __restrict__ d_coords, int nq, int p, int c, int levels,
                         int radius) {
  __shared__ float s_g[kMaxLevels * kMaxWin * kMaxWin][kQueries + 1];
  __shared__ float s_tap[kWarps][kMaxSpan * kMaxSpan];  // the dots s, then ds
  __shared__ float s_dsy[kWarps][kMaxWin * kMaxSpan];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / kGroup;  // the tap this lane's group takes in a step
  const int gl = lane % kGroup;   // the lane's place in its group
  const int win = 2 * radius + 1, span = win + 1;
  const int ntaps = span * span, nout = win * win;
  const int nchunks = c >> 3;
  const int q0 = blockIdx.x * kQueries;
  const int rows = levels * nout;
  // ds, d_f1, d_levels and the NaN term depend on g, fx and fy only; the
  // dots and their blend differences are d_coords' alone
  const bool want_coords = d_coords != nullptr;

  // the block's rows of g, read along P
  for (int e = threadIdx.x; e < rows * kQueries; e += kThreads) {
    const int row = e / kQueries, lq = e - row * kQueries;
    const int q = q0 + lq;
    float v = 0.0f;
    if (q < nq) {
      const int n = q / p, pi = q - n * p;
      v = to_float(g[((int64_t)n * rows + row) * p + pi]);
    }
    s_g[row][lq] = v;
  }
  __syncthreads();

  float* __restrict__ st = s_tap[warp];
  float* __restrict__ sd = s_dsy[warp];
  for (int lq = warp; lq < kQueries; lq += kWarps) {
    const int q = q0 + lq;
    if (q >= nq) break;  // warp-uniform
    const int n = q / p, pi = q - n * p;
    const float cx = coords[(int64_t)(2 * n) * p + pi];
    const float cy = coords[(int64_t)(2 * n + 1) * p + pi];

    float a[kMaxChunks][8], df[kMaxChunks][8];
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
      const int ch = gl + k * kGroup;
      if (ch < nchunks) {
        load8(f1 + (int64_t)q * c + ch * 8, a[k]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) a[k][j] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) df[k][j] = 0.0f;
    }
    float dcx = 0.0f, dcy = 0.0f;
    float off = 0.0f;  // sum of ds * 0 over the taps off the map: NaN iff one ds is

    for (int l = 0; l < levels; ++l) {
      const int hl = lv.h[l], wl = lv.w[l];
      const float scale = 1.0f / (float)(1 << l);  // exact: a power of two
      const float cxl = cx * scale, cyl = cy * scale;
      const float flx = floorf(cxl), fly = floorf(cyl);
      const float fx = cxl - flx, fy = cyl - fly;
      const float ofx = 1.0f - fx, ofy = 1.0f - fy;
      const int x0 = window_start(flx, radius, span, wl);
      const int y0 = window_start(fly, radius, span, hl);
      const int64_t base = (int64_t)n * hl * wl * c;
      const T* __restrict__ f2 = static_cast<const T*>(lv.f2[l]) + base;
      float* __restrict__ d2 = dl.f2[l] + base;

      // 1. the dots, as the forward takes them; only d_coords needs them
      for (int t0 = 0; want_coords && t0 < ntaps; t0 += kTapsPerStep) {
        const int t = t0 + grp;
        const int ty = t / span, tx = t - ty * span;
        const int y = y0 + ty, x = x0 + tx;
        float acc = 0.0f;
        if (t < ntaps && y >= 0 && y < hl && x >= 0 && x < wl) {
          const T* __restrict__ px = f2 + ((int64_t)y * wl + x) * c;
          float part[kMaxChunks];
#pragma unroll
          for (int k = 0; k < kMaxChunks; ++k) {
            part[k] = 0.0f;
            const int ch = gl + k * kGroup;
            if (ch < nchunks) {
              float b[8];
              load8(px + ch * 8, b);
#pragma unroll
              for (int j = 0; j < 8; ++j) part[k] = fmaf(a[k][j], b[j], part[k]);
            }
          }
          acc = (part[0] + part[1]) + (part[2] + part[3]);
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 4);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        if (gl == 0 && t < ntaps) st[t] = acc;
      }
      __syncwarp();

      // 2. back through the x blend: dsy[j][b] (b < span) and dfx, dfy
      const float* __restrict__ gv = &s_g[l * nout][lq];  // gv[j][i] at row i*win + j
      float pfx = 0.0f, pfy = 0.0f;
      for (int k = lane; k < win * span; k += 32) {
        const int j = k / span, b = k - j * span;
        const float g0 = b < win ? gv[(b * win + j) * (kQueries + 1)] : 0.0f;
        const float g1 = b > 0 ? gv[((b - 1) * win + j) * (kQueries + 1)] : 0.0f;
        const float d = b == 0 ? g0 * ofx : b == win ? g1 * fx : g0 * ofx + g1 * fx;
        sd[k] = d;
        if (want_coords) {
          const float s0 = st[j * span + b], s1 = st[(j + 1) * span + b];
          pfy += d * (s1 - s0);
          if (b < win) {
            const float sy0 = s0 * ofy + s1 * fy;
            const float sy1 = st[j * span + b + 1] * ofy + st[(j + 1) * span + b + 1] * fy;
            pfx += g0 * (sy1 - sy0);
          }
        }
      }
      if (want_coords) {
        dcx += warp_sum(pfx) * scale;
        dcy += warp_sum(pfy) * scale;
      }
      __syncwarp();

      // 3. back through the y blend: ds in place of the dots
      for (int t = lane; t < ntaps; t += 32) {
        const int ty = t / span, b = t - ty * span;
        st[t] = ty == 0     ? sd[b] * ofy
                : ty == win ? sd[(win - 1) * span + b] * fy
                            : sd[ty * span + b] * ofy + sd[(ty - 1) * span + b] * fy;
      }
      __syncwarp();

      // 4. each tap's shares of d_f1 (registers) and of its pixel's d_f2 (atomics)
      for (int t0 = 0; t0 < ntaps; t0 += kTapsPerStep) {
        const int t = t0 + grp;
        if (t < ntaps) {
          const float ds = st[t];
          const int ty = t / span, tx = t - ty * span;
          const int y = y0 + ty, x = x0 + tx;
          if (y >= 0 && y < hl && x >= 0 && x < wl) {
            const int64_t pix = ((int64_t)y * wl + x) * c;
#pragma unroll
            for (int k = 0; k < kMaxChunks; ++k) {
              const int ch = gl + k * kGroup;
              if (ch < nchunks) {
                float b[8];
                load8(f2 + pix + ch * 8, b);
                float* __restrict__ dst = d2 + pix + ch * 8;
#pragma unroll
                for (int j = 0; j < 8; ++j) df[k][j] = fmaf(ds, b[j], df[k][j]);
                // 16-byte atomics (sm_90): a quarter of the scalar ones' count
                atomicAdd(reinterpret_cast<float4*>(dst),
                          make_float4(ds * a[k][0], ds * a[k][1], ds * a[k][2], ds * a[k][3]));
                atomicAdd(reinterpret_cast<float4*>(dst) + 1,
                          make_float4(ds * a[k][4], ds * a[k][5], ds * a[k][6], ds * a[k][7]));
              }
            }
          } else {
            off += __fmul_rn(ds, 0.0f);
          }
        }
      }
      __syncwarp();  // st and sd are the next level's
    }

    // d_f1: the 4 groups' sums (lanes gl, gl + 8, gl + 16, gl + 24 hold the
    // same chunks), written by group 0
    off = warp_sum(off);
#pragma unroll
    for (int k = 0; k < kMaxChunks; ++k) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        df[k][j] += __shfl_xor_sync(0xffffffffu, df[k][j], 8);
        df[k][j] += __shfl_xor_sync(0xffffffffu, df[k][j], 16);
        df[k][j] += off;
      }
      const int ch = gl + k * kGroup;
      if (grp == 0 && ch < nchunks) store8(d_f1 + (int64_t)q * c + ch * 8, df[k]);
    }
    if (want_coords && lane == 0) {
      d_coords[(int64_t)(2 * n) * p + pi] = dcx;
      d_coords[(int64_t)(2 * n + 1) * p + pi] = dcy;
    }
  }
}

}  // namespace

// f1 (N, P, C); f2_l (N, h_l, w_l, C) for l < levels; coords (N, 2, H, W)
// float32 with H*W = P; g (N, levels*(2r+1)^2, H, W); d_f1 (N, P, C); d_f2_l
// (N, h_l, w_l, C) float32, zero-filled; d_coords (N, 2, H, W) float32, or
// null to skip it. f1, the levels, g and d_f1 are float32, or bf16 when
// is_bf16; all are contiguous, 16-byte aligned device pointers (unused level
// pointers may be null). C a multiple of 8 in [8, 256], 1 <= levels <= 4,
// 0 <= radius <= 4, N*P < 2**31. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int windowed_corr_bwd(const void* f1, const void* f2_0, const void* f2_1,
                                 const void* f2_2, const void* f2_3, const float* coords,
                                 const void* g, void* d_f1, float* d_f2_0, float* d_f2_1,
                                 float* d_f2_2, float* d_f2_3, float* d_coords, int n, int p,
                                 int c, int levels, int radius, int is_bf16, int h0, int h1,
                                 int h2, int h3, int w0, int w1, int w2, int w3, void* stream) {
  const int64_t nq = (int64_t)n * p;
  if (nq >= ((int64_t)1 << 31) || n < 0 || p < 0 || c < 8 || c > 8 * kGroup * kMaxChunks ||
      c % 8 || levels < 1 || levels > kMaxLevels || radius < 0 || radius > kMaxRadius) {
    return (int)cudaErrorInvalidValue;
  }
  const Levels lv = {{f2_0, f2_1, f2_2, f2_3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  const LevelGrads dl = {{d_f2_0, d_f2_1, d_f2_2, d_f2_3}};
  for (int l = 0; l < levels; ++l) {
    if (lv.h[l] < 0 || lv.w[l] < 0) return (int)cudaErrorInvalidValue;
  }
  if (nq > 0) {
    const int blocks = (int)((nq + kQueries - 1) / kQueries);
    cudaStream_t s = (cudaStream_t)stream;
    if (is_bf16) {
      windowed_corr_bwd_kernel<uint16_t><<<blocks, kThreads, 0, s>>>(
          static_cast<const uint16_t*>(f1), lv, coords, static_cast<const uint16_t*>(g),
          static_cast<uint16_t*>(d_f1), dl, d_coords, (int)nq, p, c, levels, radius);
    } else {
      windowed_corr_bwd_kernel<float><<<blocks, kThreads, 0, s>>>(
          static_cast<const float*>(f1), lv, coords, static_cast<const float*>(g),
          static_cast<float*>(d_f1), dl, d_coords, (int)nq, p, c, levels, radius);
    }
  }
  return (int)cudaGetLastError();
}
