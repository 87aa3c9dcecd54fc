// Windowed correlation lookup (RAFT's on-the-fly correlation), for sm_90a.
//
// Replaces gimmvfi_tpu/ops/corr.py:windowed_corr_lookup, an XLA function (no
// Pallas kernel): the JAX package's memory-efficient lookup, used when the
// all-pairs volume would pass its size limit. It computes the function of
// the reference's alt_cuda_corr.
//
// For each query q = (n, p), level l and window tap:
//   s[dy][dx] = <f1[n, p, :], f2_l[n, y0 + dy, x0 + dx, :]>,  dy, dx in [0, 2r+2)
// where (x0, y0) = floor(coord / 2^l) - r and a tap off the map counts as
// zero. The (2r+2)^2 sums accumulate in float32; a tent blend with the
// shared fractional offset (fx, fy) turns them into the (2r+1)^2 real-valued
// taps, in the order of corr.py:304-310:
//   sy[j][x] = s[j][x] * (1 - fy) + s[j+1][x] * fy
//   v[j][i]  = sy[j][i] * (1 - fx) + sy[j][i+1] * fx
// and v is cast once to the feature type. Output channel l*(2r+1)^2 +
// i*(2r+1) + j holds v[j][i] (x offset outer). A non-finite coordinate
// makes fx or fy NaN, so all of that query's outputs are NaN, as in JAX.
// The window start is clamped in float before the int conversion: past
// either end every tap is off the map, so the clamp changes no result.
//
// Layouts: f1 (N, P, C) pre-scaled by 1/sqrt(C); level l (N, h_l, w_l, C),
// channels last, so one pixel's C values are contiguous; coords (N, 2, H, W)
// float32 pixel (x, y); out (N, L*(2r+1)^2, H, W). float32 or bf16.
//
// What bounds it on the H100: at the 2048x1088 RAFT lookup (N = 2,
// P = 34,816, C = 256, bf16, 4 levels) it must move ~129 MB (0.038 ms at
// 3.35 TB/s) and do up to 14.3 GFLOP of dots (12.7 for coordinates in the
// frame; 0.013-0.014 ms on the bf16 tensor cores, ~0.2 ms as float32 FMAs
// on the CUDA cores). This kernel runs the dots as float32 FMAs and reads
// each window's pixels through L1 (100 x 512 B a query and level, 12.7 GB
// at that shape), far above the bound.
//
// The design, simple first: a block owns 32 consecutive queries. It sweeps
// one level at a time, its 8 warps one query each at a time, so the warps
// read neighbouring windows of the same map together. A warp splits into 4
// groups of 8 lanes; each group takes one tap, its 8 lanes take 8-channel
// chunks (16-byte loads in bf16) of the tap's pixel, so a group reads 128
// contiguous bytes a step, and a lane keeps up to 4 chunks of f1 (C <= 256)
// in registers. A lane's chunks are summed in separate chains; three
// shuffles reduce a tap. The sums go to shared memory, the warp blends
// them, and the block's outputs are staged in shared memory so that the
// stores run along P (32 consecutive queries a row) instead of at a stride
// of H*W. Tensor-core dots over the banded rows are later work.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit: 1.680 ms of
// device time at the 2048x1088 DS 1.0 RAFT lookup (2.3% of the bound),
// 0.706 ms at the 720p one, where the materialized grid_sample lookup
// takes 2.332 ms (chip_smoke.py phase 7). ptxas: 80 registers (78 for
// bf16), no spills. tools/windowed_ablate.py: of the design's steps only
// the register cap for 3 blocks an SM (24 warps) pays, 1.85 -> 1.67 ms;
// without the window loads it takes 1.19 ms, without the FMAs 1.09 ms,
// without both 0.56 ms: the loads, the FMAs and the rest (bounds checks,
// shuffles, blend, stores) cost about a third each, and they add up.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQueries = 32;               // consecutive queries a block owns
constexpr int kGroup = 8;                  // lanes sharing one tap's dot product
constexpr int kTapsPerStep = 32 / kGroup;  // taps a warp takes at once
constexpr int kMaxChunks = 4;              // 8-channel chunks a lane keeps: C <= 256
constexpr int kBlocksPerSM = 3;            // asks ptxas for <= 85 registers
constexpr int kMaxLevels = 4;
constexpr int kMaxRadius = 4;
constexpr int kMaxWin = 2 * kMaxRadius + 1;
constexpr int kMaxSpan = kMaxWin + 1;

struct Levels {
  const void* f2[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
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

__device__ __forceinline__ float to_out(float v, float) { return v; }
__device__ __forceinline__ uint16_t to_out(float v, uint16_t) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Window start floor(c) - r, clamped in float to [-span - 1, size + 1]
// (NaN takes the low end).
__device__ __forceinline__ int window_start(float fl, int radius, int span, int size) {
  return (int)fminf(fmaxf(fl - (float)radius, (float)(-span - 1)), (float)(size + 1));
}

// T is float, or uint16_t holding bf16 bits.
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
windowed_corr_kernel(const T* __restrict__ f1, Levels lv, const float* __restrict__ coords,
                     T* __restrict__ out, int nq, int p, int c, int levels, int radius) {
  __shared__ float s_dot[kWarps][kMaxSpan * kMaxSpan];
  // a row of kQueries + 1: a warp's blend writes one column (lq fixed, 32
  // rows), which a row of kQueries puts in one bank (two in bf16); the
  // conflicts cost no measured time (tools/windowed_ablate.py)
  __shared__ T s_out[kMaxLevels * kMaxWin * kMaxWin][kQueries + 1];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane / kGroup;   // the tap this lane's group takes in a step
  const int gl = lane % kGroup;  // the lane's place in its group
  const int win = 2 * radius + 1, span = win + 1;
  const int ntaps = span * span, nout = win * win;
  const int nchunks = c >> 3;
  const int q0 = blockIdx.x * kQueries;
  const T zero_t{};

  // level outside, queries inside: the block's warps work on one level's
  // neighbouring windows at a time
  for (int l = 0; l < levels; ++l) {
    const int hl = lv.h[l], wl = lv.w[l];
    const float scale = 1.0f / (float)(1 << l);  // exact: a power of two
    for (int lq = warp; lq < kQueries; lq += kWarps) {
      const int q = q0 + lq;
      if (q >= nq) break;  // warp-uniform
      const int n = q / p, pi = q - n * p;
      const float cx = coords[(int64_t)(2 * n) * p + pi] * scale;
      const float cy = coords[(int64_t)(2 * n + 1) * p + pi] * scale;
      const float flx = floorf(cx), fly = floorf(cy);
      const float fx = cx - flx, fy = cy - fly;
      const int x0 = window_start(flx, radius, span, wl);
      const int y0 = window_start(fly, radius, span, hl);
      const T* __restrict__ f2 = static_cast<const T*>(lv.f2[l]) + (int64_t)n * hl * wl * c;

      float a[kMaxChunks][8];
#pragma unroll
      for (int k = 0; k < kMaxChunks; ++k) {
        const int ch = gl + k * kGroup;
        if (ch < nchunks) {
          load8(f1 + (int64_t)q * c + ch * 8, a[k]);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) a[k][j] = 0.0f;
        }
      }

#pragma unroll 2
      for (int t0 = 0; t0 < ntaps; t0 += kTapsPerStep) {
        const int t = t0 + g;
        const int ty = t / span, tx = t - ty * span;
        const int y = y0 + ty, x = x0 + tx;
        float acc = 0.0f;
        if (t < ntaps && y >= 0 && y < hl && x >= 0 && x < wl) {
          const T* __restrict__ px = f2 + ((int64_t)y * wl + x) * c;
          float b[kMaxChunks][8];
#pragma unroll
          for (int k = 0; k < kMaxChunks; ++k) {
            const int ch = gl + k * kGroup;
            if (ch < nchunks) {
              load8(px + ch * 8, b[k]);
            } else {
#pragma unroll
              for (int j = 0; j < 8; ++j) b[k][j] = 0.0f;
            }
          }
          // one chain a chunk, so the FMAs of the chunks overlap
          float part[kMaxChunks];
#pragma unroll
          for (int k = 0; k < kMaxChunks; ++k) {
            part[k] = a[k][0] * b[k][0];
#pragma unroll
            for (int j = 1; j < 8; ++j) part[k] = fmaf(a[k][j], b[k][j], part[k]);
          }
          acc = (part[0] + part[1]) + (part[2] + part[3]);
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 4);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        if (gl == 0 && t < ntaps) s_dot[warp][t] = acc;
      }
      __syncwarp();

      // tent blend, no contraction into FMAs: the plain version's order
      const float ofy = 1.0f - fy, ofx = 1.0f - fx;
      for (int k = lane; k < nout; k += 32) {
        const int i = k / win, j = k - i * win;  // x offset i (outer), y offset j
        const float* r0 = &s_dot[warp][j * span + i];
        const float* r1 = r0 + span;
        const float sy0 = __fadd_rn(__fmul_rn(r0[0], ofy), __fmul_rn(r1[0], fy));
        const float sy1 = __fadd_rn(__fmul_rn(r0[1], ofy), __fmul_rn(r1[1], fy));
        const float v = __fadd_rn(__fmul_rn(sy0, ofx), __fmul_rn(sy1, fx));
        s_out[l * nout + k][lq] = to_out(v, zero_t);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // a row of the output (one level and tap) over the block's queries
  const int rows = levels * nout;
  for (int e = threadIdx.x; e < rows * kQueries; e += kThreads) {
    const int row = e / kQueries, lq = e - row * kQueries;
    const int q = q0 + lq;
    if (q < nq) {
      const int n = q / p, pi = q - n * p;
      out[((int64_t)n * rows + row) * p + pi] = s_out[row][lq];
    }
  }
}

}  // namespace

// f1 (N, P, C); f2_l (N, h_l, w_l, C) for l < levels (unused pointers may be
// null); coords (N, 2, H, W) float32 with H*W = P; out (N, levels*(2r+1)^2,
// H, W). f1, the levels and out are float32, or bf16 when is_bf16; all are
// contiguous, 16-byte aligned device pointers. C a multiple of 8 in
// [8, 256], 1 <= levels <= 4, 0 <= radius <= 4, N*P < 2**31. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int windowed_corr_lookup(const void* f1, const void* f2_0, const void* f2_1,
                                    const void* f2_2, const void* f2_3, const float* coords,
                                    void* out, int n, int p, int c, int levels, int radius,
                                    int is_bf16, int h0, int h1, int h2, int h3, int w0, int w1,
                                    int w2, int w3, void* stream) {
  const int64_t nq = (int64_t)n * p;
  if (nq >= ((int64_t)1 << 31) || n < 0 || p < 0 || c < 8 || c > 8 * kGroup * kMaxChunks ||
      c % 8 || levels < 1 || levels > kMaxLevels || radius < 0 || radius > kMaxRadius) {
    return (int)cudaErrorInvalidValue;
  }
  const Levels lv = {{f2_0, f2_1, f2_2, f2_3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  for (int l = 0; l < levels; ++l) {
    if (lv.h[l] < 0 || lv.w[l] < 0) return (int)cudaErrorInvalidValue;
  }
  if (nq > 0) {
    const int blocks = (int)((nq + kQueries - 1) / kQueries);
    cudaStream_t s = (cudaStream_t)stream;
    if (is_bf16) {
      windowed_corr_kernel<uint16_t><<<blocks, kThreads, 0, s>>>(
          static_cast<const uint16_t*>(f1), lv, coords, static_cast<uint16_t*>(out), (int)nq, p,
          c, levels, radius);
    } else {
      windowed_corr_kernel<float><<<blocks, kThreads, 0, s>>>(
          static_cast<const float*>(f1), lv, coords, static_cast<float*>(out), (int)nq, p, c,
          levels, radius);
    }
  }
  return (int)cudaGetLastError();
}
