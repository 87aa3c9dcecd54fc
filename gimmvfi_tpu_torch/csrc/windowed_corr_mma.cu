// Windowed correlation lookup in bf16 on the tensor cores, for sm_90a.
//
// Replaces gimmvfi_tpu/ops/corr.py:windowed_corr_lookup, an XLA function (no
// Pallas kernel), for bf16 features; float32 stays on windowed_corr.cu. The
// function is the one stated at the top of windowed_corr.cu:
//   s[dy][dx] = <f1[n, p, :], f2_l[n, y0 + dy, x0 + dx, :]>,  dy, dx in [0, 2r+2)
// with f32 sums, (x0, y0) = floor(coord / 2^l) - r, a tap off the map zero;
// the tent blend in JAX's order, in f32 without contraction,
//   sy[j][x] = s[j][x] * (1 - fy) + s[j+1][x] * fy
//   v[j][i]  = sy[j][i] * (1 - fx) + sy[j][i+1] * fx
// one cast to bf16, output channel l*(2r+1)^2 + i*(2r+1) + j (x offset
// outer). A non-finite coordinate makes fx or fy NaN, so all its outputs
// are NaN.
//
// Layouts: f1 (N, H*W, C) bf16, pre-scaled by 1/sqrt(C); level l
// (N, h_l, w_l, C) bf16, channels last; coords (N, 2, H, W) float32 pixel
// (x, y); out (N, L*(2r+1)^2, H, W) bf16.
//
// What bounds it on the H100: at the 2048x1088 RAFT lookup (N = 2,
// 136x256 queries, C = 256, 4 levels) it must move ~129 MB (0.038 ms at
// 3.35 TB/s) and do 12.7 GFLOP of dots for coordinates in the frame
// (0.013 ms on the bf16 tensor cores). windowed_corr.cu reads each query's
// 100 window pixels per level through L1 (12.7 GB) and dots them as f32
// FMAs; the loads, the FMAs and its per-tap checks and shuffles cost about a
// third each (tools/windowed_ablate.py).
//
// The design: a warp owns a tile of 16 consecutive queries of one image row,
// the M of mma.sync m16n8k16 (bf16 in, f32 accumulators). Their f1 rows go
// through shared memory once (cp.async, K zero-padded to a multiple of 16)
// and into registers with ldmatrix, for all levels. For each level the warp
// takes the union of its queries' windows: only queries whose window touches
// the map count (a non-finite coordinate's window start is clamped off the
// map), clipped to the map. It walks the union one row at a time; a row's
// columns are those of the windows that cover the row. A ring of 2 stages of
// 16 target pixels is filled with cp.async, so each pixel is read once a
// tile and level instead of once a query; the levels are channels last, so a
// pixel's 8 channels are one 16-byte ldmatrix row (a pixel padded by 16
// bytes, so the 8 rows of a matrix fall in 8 bank groups), and a stage is
// one or two n-tiles of 8 pixels, K = C. The inner loop has no per-tap
// bounds check and no shuffle. Each accumulator (query, pixel) goes to that
// query's (2r+2)^2 sums in shared memory if the pixel lies in its window;
// then the blend, and stores of 16 consecutive queries (32 bytes) a channel
// row along P. A warp is a block, with 23.4 KB of shared memory at C = 256
// (the ring 16.9, the sums 6.5): 9 warps an SM. Shared memory bounds the
// warps an SM holds, and the warps bound how much of the staging is in
// flight: 2 stages of 16 pixels ran faster than 3 or 4 (7 or 5 warps an SM)
// and than 2 of 32. Sharing staged rows across the warps of a block (a 2D
// patch of queries) is later work.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit
// (chip_smoke.py phase 7): at the 2048x1088 RAFT lookup 0.347 ms of device
// time on smooth coordinates (11% of the bound), 0.462 ms on independent
// in-frame ones, 0.319 ms on the DS 1.0 path's own first RAFT lookup,
// against 1.67-1.70 ms for windowed_corr.cu; 0.223 ms at 720p. ptxas: 158
// registers, no spills. tools/windowed_ablate.py --mma: without the dots it
// is no faster (they hide under the rest); without the staging copies it
// saves ~0.1 ms; the walk, the scatter, the blend and the stores take the
// remaining ~0.25 ms, with ~2 warps a scheduler to hide their latency.
//
// That is the fast case: at most 4 levels and a radius of at most 4, every
// path's lookups. Any other radius and level count takes the general case,
// `windowed_corr_mma_lookup_general`, the same kernel with two additions:
//   - the levels in groups of at most 4, a launch a group; a launch takes
//     its first level's index (the coordinates' scale 2^-l) and the total
//     level count (the output's channels are level-major);
//   - the window in tap tiles: the (2r+1)^2 outputs cut into a grid of
//     tiles of at most 9 x 9 (the fast case's largest window), tile (i, j)
//     needing the (ni+1) x (nj+1) integer taps from (x0 + i0, y0 + j0). Each
//     tile is walked, scattered and blended as the fast case walks its one
//     window, in the same shared memory, so any radius fits; a tile shares
//     its last tap row and column with the next tile's first, which are
//     dotted twice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileQ = 16;         // queries a warp's tile: the mma's M
constexpr int kStagePx = 16;       // target pixels a ring stage holds
constexpr int kStages = 2;         // ring stages; kStages - 1 copies in flight
constexpr int kNT = kStagePx / 8;  // n-tiles of a stage
static_assert(kStagePx == 16 && kStages >= 2, "a stage is two n-tiles of 8 pixels");
constexpr int kMaxC = 256;
constexpr int kMaxKSteps = kMaxC / 16;
constexpr int kMaxLevels = 4;
constexpr int kMaxRadius = 4;
constexpr int kMaxSpan = 2 * kMaxRadius + 2;
constexpr int kMaxWin = kMaxSpan - 1;  // outputs a tap tile of the general case a side
// a query's integer taps in shared memory, an odd count so that the blend's
// 16 queries read 16 banks
constexpr int kSRow = kMaxSpan * kMaxSpan + 1;
constexpr int kFar = 1 << 30;      // an empty extent is [kFar, -kFar)
constexpr unsigned kAll = 0xffffffffu;

struct Levels {
  const uint16_t* f2[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t addr, uint32_t r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Window start floor(c) - r, clamped in float to [-span - 1, size + 1]
// (NaN takes the low end), as windowed_corr.cu clamps it.
__device__ __forceinline__ int window_start(float fl, int radius, int span, int size) {
  return (int)fminf(fmaxf(fl - (float)radius, (float)(-span - 1)), (float)(size + 1));
}

// One staged row piece: union row y, columns [x, x + npx), npx <= kStagePx.
// `end` is the row's last column + 1; y == y_end when the walk is done.
struct Stage {
  int y, x, end;
};

// The product of the tile's f1 rows and the first NT (1 or 2) n-tiles of a
// staged piece, two accumulator chains an n-tile (even and odd k-steps);
// one ldmatrix.x4 reads both n-tiles' B fragments.
template <int NT>
__device__ __forceinline__ void stage_dots(const uint32_t (&a)[kMaxKSteps][4], uint32_t bbase,
                                           int nks, float (&acc)[kNT][2][4]) {
#pragma unroll
  for (int ks = 0; ks < kMaxKSteps; ++ks) {
    if (ks < nks) {
      uint32_t b[4];
      if (NT == 2) {
        ldmatrix_x4(bbase + ks * 32, b);
      } else {
        ldmatrix_x2(bbase + ks * 32, b);
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        mma_bf16(acc[t][ks & 1], a[ks], b[2 * t], b[2 * t + 1]);
      }
    }
  }
}

// Copy pixels [0, npx) of a staged piece to a ring stage, kch 16-byte chunks
// a pixel (chunks >= nch are K padding, written as zeros). Lane steps over
// the flat (pixel, chunk) range by 32 without dividing; where kch divides 32
// and there is no padding (C = 16, 32, 64, 128, 256), a lane keeps one chunk.
__device__ __forceinline__ void stage_pixels(uint32_t dst, const uint16_t* __restrict__ row,
                                             const uint16_t* __restrict__ any, int npx, int c,
                                             int nch, int kch, int px_bytes, int lane, int dq,
                                             int dr) {
  int px = lane / kch, ch = lane - px * kch;
  if (dr == 0 && kch == nch) {
    const uint16_t* src = row + px * c + ch * 8;
    uint32_t to = dst + px * px_bytes + ch * 16;
#pragma unroll 4
    for (; px < npx; px += dq, src += dq * c, to += dq * px_bytes) {
      cp_async16(to, src, 16);
    }
    return;
  }
  while (px < npx) {
    const bool real = ch < nch;
    cp_async16(dst + px * px_bytes + ch * 16, real ? row + px * c + ch * 8 : any, real ? 16 : 0);
    px += dq;
    ch += dr;
    if (ch >= kch) {
      ch -= kch;
      ++px;
    }
  }
}

// kGeneral: levels [level0, level0 + levels) of out_levels, the window in
// tap tiles; else the fast case (level0 0, out_levels = levels, one tile)
template <bool kGeneral>
__global__ void __launch_bounds__(32)
windowed_corr_mma_kernel(const uint16_t* __restrict__ f1, Levels lv,
                         const float* __restrict__ coords, uint16_t* __restrict__ out, int h,
                         int w, int c, int levels, int radius, int level0, int out_levels) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int nch = c >> 3;                // 8-channel chunks of a pixel
  const int kch = ((c + 15) >> 4) << 1;  // the same, K padded to 16
  const int nks = kch >> 1;              // k-steps of 16 channels
  const int px_bytes = kch * 16 + 16;    // a staged pixel, 16 bytes of padding
  const int stage_bytes = kStagePx * px_bytes;
  const int dq = 32 / kch, dr = 32 - dq * kch;
  const uint32_t ring = smem_addr(smem);
  float* s = reinterpret_cast<float*>(smem + kStages * stage_bytes);  // [kTileQ][kSRow]

  const int win = 2 * radius + 1, span = win + 1, nout = win * win;
  // tap tiles a side: ceil(win / kMaxWin) in the general case
  const int parts = kGeneral ? (win + kMaxWin - 1) / kMaxWin : 1;
  const int p = h * w;
  const int tiles_x = (w + kTileQ - 1) / kTileQ;
  const int n = blockIdx.x / (h * tiles_x);
  const int rest = blockIdx.x - n * h * tiles_x;
  const int qy = rest / tiles_x;
  const int qx0 = (rest - qy * tiles_x) * kTileQ;
  const int64_t q0 = (int64_t)n * p + (int64_t)qy * w + qx0;  // the tile's first query
  const int rq = lane & (kTileQ - 1);  // the query whose geometry and blend this lane holds
  const bool q_ok = qx0 + rq < w;

  // f1 rows of the tile through ring stage 0 into mma A fragments (rows past
  // the image row are zeros), kept in registers for every level
  for (int e = lane; e < kTileQ * kch; e += 32) {
    const int r = e / kch, ch = e - r * kch;
    const bool real = ch < nch && qx0 + r < w;
    cp_async16(ring + r * px_bytes + ch * 16, real ? f1 + (q0 + r) * c + ch * 8 : f1, real ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  uint32_t a[kMaxKSteps][4];
  {
    const uint32_t abase = ring + (lane & 15) * px_bytes + (lane >> 4) * 16;
#pragma unroll
    for (int ks = 0; ks < kMaxKSteps; ++ks) {
      if (ks < nks) {
        ldmatrix_x4(abase + ks * 32, a[ks]);
      } else {
        a[ks][0] = a[ks][1] = a[ks][2] = a[ks][3] = 0u;
      }
    }
  }
  __syncwarp();

  const float* cq = coords + (int64_t)2 * n * p + (int64_t)qy * w + qx0 + rq;
  const float cx_full = q_ok ? cq[0] : 0.0f, cy_full = q_ok ? cq[p] : 0.0f;
  // this lane's accumulator rows are queries g and g + 8; its columns 2t, 2t+1
  const int g = lane >> 2, col = (lane & 3) * 2;
  // ldmatrix rows of the B operand: lanes 0-7 / 8-15 the first n-tile's
  // pixels at k 0-7 / 8-15, lanes 16-31 the second n-tile's
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_chunk = (lane >> 3) & 1;

  for (int l = 0; l < levels; ++l) {
    const int hl = lv.h[l], wl = lv.w[l];
    const uint16_t* __restrict__ f2 = lv.f2[l] + (int64_t)n * hl * wl * c;
    // exact: a power of two
    const float scale = kGeneral ? ldexpf(1.0f, -(level0 + l)) : 1.0f / (float)(1 << l);
    const float cx = cx_full * scale, cy = cy_full * scale;
    const float flx = floorf(cx), fly = floorf(cy);
    const float fx = cx - flx, fy = cy - fly;
    int x0_full = window_start(flx, radius, span, wl);
    const int y0_full = window_start(fly, radius, span, hl);
    if (!q_ok) x0_full = -span - 1;  // a query past the image row takes no tap
    for (int tile = 0; tile < parts * parts; ++tile) {
      // tap tile (ti, tj): outputs x offset i0 .. i0 + ni - 1, y offset j0 ..
      // j0 + nj - 1, from the integer taps sx = ni + 1 a row, sy = nj + 1 rows
      const int ti = tile / parts, tj = tile - ti * parts;
      const int i0 = kGeneral ? ti * win / parts : 0, j0 = kGeneral ? tj * win / parts : 0;
      const int ni = kGeneral ? (ti + 1) * win / parts - i0 : win;
      const int nj = kGeneral ? (tj + 1) * win / parts - j0 : win;
      const int sx = kGeneral ? ni + 1 : span, sy = kGeneral ? nj + 1 : span;
      const int x0 = x0_full + i0, y0 = y0_full + j0;
      // the tile's window part on the map; empty off it (and for non-finite
      // coordinates: their window starts off the map)
      int wx0 = max(x0, 0), wx1 = min(x0 + sx, wl);
      int wy0 = max(y0, 0), wy1 = min(y0 + sy, hl);
      if (wx0 >= wx1 || wy0 >= wy1) {
        wx0 = wy0 = kFar;
        wx1 = wy1 = -kFar;
      }
      const int x0_lo = __shfl_sync(kAll, x0, g), y0_lo = __shfl_sync(kAll, y0, g);
      const int x0_hi = __shfl_sync(kAll, x0, g + 8), y0_hi = __shfl_sync(kAll, y0, g + 8);
      const int uy0 = __reduce_min_sync(kAll, wy0), uy1 = __reduce_max_sync(kAll, wy1);

      // the next union row at or after y that some window covers, as a stage
      // at its first column; y == uy1 when there is none
      auto row_from = [&](int y) -> Stage {
        for (; y < uy1; ++y) {
          const bool in = wy0 <= y && y < wy1;
          const int rx0 = __reduce_min_sync(kAll, in ? wx0 : kFar);
          const int rx1 = __reduce_max_sync(kAll, in ? wx1 : -kFar);
          if (rx0 < rx1) return Stage{y, rx0, rx1};
        }
        return Stage{uy1, 0, 0};
      };
      auto next = [&](Stage st) -> Stage {
        return st.x + kStagePx < st.end ? Stage{st.y, st.x + kStagePx, st.end} : row_from(st.y + 1);
      };
      auto issue = [&](Stage st, int slot) {
        stage_pixels(ring + slot * stage_bytes, f2 + ((int64_t)st.y * wl + st.x) * c, f1,
                     min(kStagePx, st.end - st.x), c, nch, kch, px_bytes, lane, dq, dr);
      };

      float4* s4 = reinterpret_cast<float4*>(s);
      for (int i = lane; i < kTileQ * kSRow / 4; i += 32) s4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      __syncwarp();

      Stage load = row_from(uy0 < uy1 ? uy0 : uy1);
      Stage comp = load;
#pragma unroll
      for (int i = 0; i < kStages - 1; ++i) {
        if (load.y < uy1) {
          issue(load, i);
          load = next(load);
        }
        cp_async_commit();
      }
      int slot = 0;
      while (comp.y < uy1) {
        // the slot kStages - 1 ahead was computed last step (and synced)
        if (load.y < uy1) {
          issue(load, slot == 0 ? kStages - 1 : slot - 1);
          load = next(load);
        }
        cp_async_commit();
        cp_async_wait<kStages - 1>();
        __syncwarp();

        const int npx = min(kStagePx, comp.end - comp.x);
        const int nt = (npx + 7) >> 3;
        float acc[kNT][2][4] = {};
        const uint32_t bbase = ring + slot * stage_bytes + b_row * px_bytes + b_chunk * 16;
        if (nt == 2) {
          stage_dots<2>(a, bbase, nks, acc);
        } else {
          stage_dots<1>(a, bbase, nks, acc);
        }
        // scatter: (query, pixel) into the query's sums if the pixel is in its
        // window; columns past the piece hold no copied pixel
#pragma unroll
        for (int t = 0; t < kNT; ++t) {
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int dy = comp.y - (hi ? y0_hi : y0_lo);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int px = 8 * t + col + j;
              const int dx = comp.x + px - (hi ? x0_hi : x0_lo);
              if (px < npx && (unsigned)dy < (unsigned)sy && (unsigned)dx < (unsigned)sx) {
                s[(g + 8 * hi) * kSRow + dy * sx + dx] = acc[t][0][2 * hi + j] + acc[t][1][2 * hi + j];
              }
            }
          }
        }
        __syncwarp();
        comp = next(comp);
        slot = slot + 1 == kStages ? 0 : slot + 1;
      }
      cp_async_wait<0>();
      __syncwarp();

      // tent blend, no contraction into FMAs: the plain version's order; lanes
      // 0-15 and 16-31 take two output channels, 16 queries each
      const float ofy = 1.0f - fy, ofx = 1.0f - fx;
      const float* sq = s + rq * kSRow;
      uint16_t* o = out + ((int64_t)n * (kGeneral ? out_levels : levels) * nout +
                           (int64_t)(kGeneral ? level0 + l : l) * nout) * p +
                    (int64_t)qy * w + qx0 + rq;
      if (kGeneral) {
        // the tile's outputs k = il * nj + jl, channel (i0 + il) * win + j0 + jl
        for (int k = lane >> 4; k < ni * nj; k += 2) {
          const int il = k / nj, jl = k - il * nj;
          const float* r0 = sq + jl * sx + il;
          const float* r1 = r0 + sx;
          const float sy0 = __fadd_rn(__fmul_rn(r0[0], ofy), __fmul_rn(r1[0], fy));
          const float sy1 = __fadd_rn(__fmul_rn(r0[1], ofy), __fmul_rn(r1[1], fy));
          const float v = __fadd_rn(__fmul_rn(sy0, ofx), __fmul_rn(sy1, fx));
          if (q_ok) {
            o[(int64_t)((i0 + il) * win + j0 + jl) * p] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
          }
        }
      } else {
        int k = lane >> 4;
        int i = 0, j = k;  // k = i * win + j: x offset i (outer), y offset j
        for (; k < nout; k += 2) {
          const float* r0 = sq + j * span + i;
          const float* r1 = r0 + span;
          const float sy0 = __fadd_rn(__fmul_rn(r0[0], ofy), __fmul_rn(r1[0], fy));
          const float sy1 = __fadd_rn(__fmul_rn(r0[1], ofy), __fmul_rn(r1[1], fy));
          const float v = __fadd_rn(__fmul_rn(sy0, ofx), __fmul_rn(sy1, fx));
          if (q_ok) o[(int64_t)k * p] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
          j += 2;
          if (j >= win) {
            j -= win;
            ++i;
          }
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

namespace {

template <bool kGeneral>
int launch(const void* f1, const void* f2_0, const void* f2_1, const void* f2_2, const void* f2_3,
           const float* coords, void* out, int n, int h, int w, int c, int levels, int radius,
           int level0, int out_levels, int h0, int h1, int h2, int h3, int w0, int w1, int w2,
           int w3, void* stream) {
  const int64_t nq = (int64_t)n * h * w;
  if (nq >= ((int64_t)1 << 31) || n < 0 || h < 0 || w < 0 || c < 8 || c > kMaxC || c % 8 ||
      levels < 1 || levels > kMaxLevels || radius < 0 ||
      (kGeneral ? (int64_t)(2 * radius + 2) * (2 * radius + 2) >= ((int64_t)1 << 31) || level0 < 0 ||
                      level0 + levels > out_levels
                : radius > kMaxRadius)) {
    return (int)cudaErrorInvalidValue;
  }
  const Levels lv = {{static_cast<const uint16_t*>(f2_0), static_cast<const uint16_t*>(f2_1),
                      static_cast<const uint16_t*>(f2_2), static_cast<const uint16_t*>(f2_3)},
                     {h0, h1, h2, h3},
                     {w0, w1, w2, w3}};
  for (int l = 0; l < levels; ++l) {
    if (lv.h[l] < 0 || lv.w[l] < 0) return (int)cudaErrorInvalidValue;
  }
  const int64_t tiles = (int64_t)n * h * ((w + kTileQ - 1) / kTileQ);
  if (tiles > 0) {
    const int kch = ((c + 15) >> 4) << 1;
    const size_t smem = (size_t)kStages * kStagePx * (kch * 16 + 16) + kTileQ * kSRow * sizeof(float);
    windowed_corr_mma_kernel<kGeneral><<<(int)tiles, 32, smem, (cudaStream_t)stream>>>(
        static_cast<const uint16_t*>(f1), lv, coords, static_cast<uint16_t*>(out), h, w, c,
        levels, radius, level0, out_levels);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The fast case. f1 (N, H*W, C); f2_l (N, h_l, w_l, C) for l < levels
// (unused pointers may be null); coords (N, 2, H, W) float32; out (N,
// levels*(2r+1)^2, H, W). f1, the levels and out are bf16 (their bits); all
// are contiguous, 16-byte aligned device pointers. C a multiple of 8 in
// [8, 256], 1 <= levels <= 4, 0 <= radius <= 4, N*H*W < 2**31. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int windowed_corr_mma_lookup(const void* f1, const void* f2_0, const void* f2_1,
                                        const void* f2_2, const void* f2_3, const float* coords,
                                        void* out, int n, int h, int w, int c, int levels,
                                        int radius, int h0, int h1, int h2, int h3, int w0,
                                        int w1, int w2, int w3, void* stream) {
  return launch<false>(f1, f2_0, f2_1, f2_2, f2_3, coords, out, n, h, w, c, levels, radius, 0,
                       levels, h0, h1, h2, h3, w0, w1, w2, w3, stream);
}

// The general case: any radius >= 0, and levels [level0, level0 + levels)
// (1 <= levels <= 4, their maps f2_0 ..) of a lookup of out_levels levels,
// written to their channels of out (N, out_levels*(2r+1)^2, H, W); the rest
// as the fast case's.
extern "C" int windowed_corr_mma_lookup_general(const void* f1, const void* f2_0,
                                                const void* f2_1, const void* f2_2,
                                                const void* f2_3, const float* coords, void* out,
                                                int n, int h, int w, int c, int levels, int radius,
                                                int level0, int out_levels, int h0, int h1, int h2,
                                                int h3, int w0, int w1, int w2, int w3,
                                                void* stream) {
  return launch<true>(f1, f2_0, f2_1, f2_2, f2_3, coords, out, n, h, w, c, levels, radius, level0,
                      out_levels, h0, h1, h2, h3, w0, w1, w2, w3, stream);
}
