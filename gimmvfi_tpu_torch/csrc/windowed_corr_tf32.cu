// Windowed correlation lookup in float32 on the tensor cores (3xTF32), for
// sm_90a.
//
// Replaces gimmvfi_tpu/ops/corr.py:windowed_corr_lookup, an XLA function (no
// Pallas kernel), for float32 features; bf16 goes to windowed_corr_mma.cu.
// The function is the one stated at the top of windowed_corr.cu:
//   s[dy][dx] = <f1[n, p, :], f2_l[n, y0 + dy, x0 + dx, :]>,  dy, dx in [0, 2r+2)
// with float32 sums, (x0, y0) = floor(coord / 2^l) - r, a tap off the map
// zero; the tent blend in JAX's order, in float32 without contraction,
//   sy[j][x] = s[j][x] * (1 - fy) + s[j+1][x] * fy
//   v[j][i]  = sy[j][i] * (1 - fx) + sy[j][i+1] * fx
// output channel l*(2r+1)^2 + i*(2r+1) + j (x offset outer). A non-finite
// coordinate makes fx or fy NaN, so all its outputs are NaN.
//
// Layouts: f1 (N, H*W, C) float32, pre-scaled by 1/sqrt(C); level l
// (N, h_l, w_l, C) float32, channels last; coords (N, 2, H, W) float32
// pixel (x, y); out (N, L*(2r+1)^2, H, W) float32.
//
// What bounds it on the H100: at the 720p GIMM-VFI-F AMT lookup (N = 1,
// 92x160 queries, C = 256, 4 levels) it must move ~54 MB (0.0162 ms at
// 3.35 TB/s); its 2.56 GFLOP of float32 dots are three TF32 products each
// here, 0.0155 ms at the 495 TFLOP/s dense TF32 peak, so the bytes bound
// it. windowed_corr.cu runs the dots as FMAs on the CUDA cores (0.038 ms at
// their 67 TFLOP/s peak), a warp a query, reading each query's 100 window
// pixels a level through L1; its loads, FMAs and checks cost about a third
// each and do not overlap.
//
// The walk is windowed_corr_mma.cu's. A block owns a tile of 16 consecutive
// queries of one image row, the M of mma.sync m16n8k8 (tf32 in, float32
// accumulators). For each level the block takes the union of its live
// queries' windows (a finite coordinate whose window touches the map),
// clipped to the map, and walks it one row at a time; a row's columns are
// those of the windows that cover the row, in pieces of up to 16 pixels.
// Each pixel is read once a tile and level; there is no per-tap bounds check
// and no shuffle in the dots.
//
// The dots are 3xTF32 (CUTLASS's float32-accurate mode): each operand x is
// split into big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big) (by
// the integer steps ptxas itself emits for cvt.rna before an mma), and
// big*big, small*big and big*small go through three mma; the dropped
// small*small term is ~2^-22 relative, and the products are exact in the
// float32 accumulators. One pass of TF32 (a 10-bit mantissa) misses the
// 1e-5 * max|plain| tolerance at C = 256
// (tests/test_torch_corr_windowed_tf32.py).
//
// The block's kWarps warps split the channels: warp w takes k-steps (of 8
// channels) [w * K / kWarps, (w + 1) * K / kWarps). It keeps its slice of
// the tile's f1 rows in registers as A fragments, split into big and small
// once for all levels, and stages only its slice of each piece's pixels,
// with cp.async into a ring of its own (no block barrier for the copies).
// So the per-piece work of a warp is a quarter of the tile's and an SM
// holds 16 warps where a warp a tile held 4 (a 16-pixel stage of all 256
// channels and the f1 tile took 34 KB a warp); a first design with one
// warp a tile ran slower than windowed_corr.cu, latency-bound at one warp a
// scheduler (PERF.md). ldmatrix is b16 only, so B fragments come from shared
// memory by plain loads; the dot is a sum over channels, so any order of the
// channels within a k-step that A and B share gives it: lane (g, t) =
// (lane / 4, lane % 4) takes channels 2t and 2t + 1 of a k-step as the
// mma's k indices t and t + 4, and reads each B pixel (pixel g of an
// n-tile) with one 64-bit load, from rows padded to 8 (mod 32) floats, so
// each half-warp's 16 loads of 8 bytes fall in 32 banks. After a piece, each
// warp writes its partial sums to shared memory (two buffers, so one block
// barrier a piece), and warp w adds up the elements it owns in a fixed
// order and puts each (query, pixel) into that query's (2r+2)^2 sums if the
// pixel lies in its window. Then the blend, and stores of 16 consecutive
// queries (64 bytes) a channel row along P. tools/windowed_ablate.py --tf32
// times the configurations and ablations.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit: on the 720p
// F path's captured AMT lookup 0.248 ms of device time (6.5% of its
// 0.0162 ms bytes bound) against 0.629 ms for windowed_corr.cu in the same
// run (chip_smoke.py phase 9 (a)); at that shape 0.36 ms on independent
// in-frame coordinates and 0.27 ms on smooth ones. ptxas: 128 registers,
// 8 bytes of spills; 51.5 KB of shared memory a block, 4 blocks (16 warps)
// an SM. tools/windowed_ablate.py --tf32 (in-frame): without the staging
// copies it is 0.11 ms faster, without the mma 0.12 ms; 8-pixel stages and
// a 4-deep ring are slower.
//
// That is the fast case: at most 4 levels and a radius of at most 4. Any
// other radius and level count takes the general case,
// `windowed_corr_tf32_lookup_general`, with windowed_corr_mma.cu's two
// additions: levels in groups of at most 4 (a launch a group, with its first
// level's index and the total level count), and the window in tap tiles of
// at most 9 x 9 outputs, each walked as the fast case walks its window.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileQ = 16;         // queries a block's tile: the mma's M
constexpr int kWarps = 4;          // warps a block, each a slice of the channels
constexpr int kStagePx = 16;       // target pixels a ring stage holds
constexpr int kStages = 2;         // ring stages a warp; kStages - 1 copies in flight
constexpr int kNT = kStagePx / 8;  // n-tiles of a stage
constexpr int kElems = 4 * kNT;    // accumulator elements a lane, summed over the chains
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 16 / kWarps;  // asks ptxas for <= 128 registers
static_assert((kStagePx == 8 || kStagePx == 16) && kStages >= 2 && 32 % kWarps == 0,
              "a stage is one or two n-tiles of 8 pixels; the warps split 32 k-steps");
constexpr int kMaxC = 256;
constexpr int kMaxKs = kMaxC / 8 / kWarps;  // k-steps a warp at most
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
  const float* f2[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

// Floats from one staged row of k channels to the next: k padded to 8
// (mod 32), so a half-warp's 64-bit loads of 4 rows x 8 floats hit 32 banks.
__host__ __device__ constexpr int row_floats(int k) { return k + ((8 - k) & 31); }

// Channels of the widest warp slice at C = c.
__host__ __device__ constexpr int slice_channels(int c) {
  return 8 * ((c / 8 + kWarps - 1) / kWarps);
}

// Bytes of dynamic shared memory at C = c: the warps' rings, the partial
// sums (two buffers), the taps' sums.
__host__ __device__ constexpr int smem_bytes(int c) {
  return (kWarps * kStages * kStagePx * row_floats(slice_channels(c)) +
          2 * kWarps * kElems * 32 + kTileQ * kSRow) * (int)sizeof(float);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = big + small as mma operands, big = cvt.rna.tf32(x) and small =
// cvt.rna.tf32(x - big), computed as ptxas lowers cvt.rna.tf32.f32 for an
// mma operand: half a TF32 step (0x1000) is added to the bits, and the
// tensor cores read only the top 19 bits, so they see x rounded to nearest,
// ties away from zero; big with its low 13 bits cleared makes x - big exact
// in float32. Without cvt's check for a non-finite x (two more instructions
// an operand): the features are finite.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) + 0x1000u;
  small = __float_as_uint(__fsub_rn(x, __uint_as_float(big & 0xffffe000u))) + 0x1000u;
}

// d += a (16x8, row) * b (8x8, col), tf32 in, float32 accumulators
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of the k-step at channel k of f1 rows r0 (query g) and r1
// (query g + 8, null past the image row: zeros): channels k + 2t (the mma's
// k index t) and k + 2t + 1 (k index t + 4).
__device__ __forceinline__ void load_a(const float* __restrict__ r0, const float* __restrict__ r1,
                                       int k, int t, float v[4]) {
  const float2 lo = r0 ? __ldg(reinterpret_cast<const float2*>(r0 + k + 2 * t)) : make_float2(0.f, 0.f);
  const float2 hi = r1 ? __ldg(reinterpret_cast<const float2*>(r1 + k + 2 * t)) : make_float2(0.f, 0.f);
  v[0] = lo.x;
  v[1] = hi.x;
  v[2] = lo.y;
  v[3] = hi.y;
}

// The B fragment of the k-step at channel k of n-tile nt of a stage (row
// stride rs): pixel g of the n-tile at the same two channels.
__device__ __forceinline__ float2 load_b(const float* stage, int rs, int nt, int k, int g, int t) {
  return *reinterpret_cast<const float2*>(stage + (8 * nt + g) * rs + k + 2 * t);
}

// A piece's dots over the warp's nks k-steps: the tile's f1 slice (big and
// small, in registers) by the first NT (1 or 2) n-tiles of the staged
// piece, 3xTF32 into two accumulator chains an n-tile: big*big, and
// small*big + big*small. kFull: nks is kMaxKs, and the k-steps have no
// branch between them, so the loads of later k-steps issue early.
template <int NT, bool kFull>
__device__ __forceinline__ void stage_dots(const uint32_t (&ahi)[kMaxKs][4],
                                           const uint32_t (&alo)[kMaxKs][4], const float* stage,
                                           int rs, int nks, int g, int t,
                                           float (&acc)[kNT][2][4]) {
#pragma unroll
  for (int ks = 0; ks < kMaxKs; ++ks) {
    if (kFull || ks < nks) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 bv = load_b(stage, rs, nt, 8 * ks, g, t);
        uint32_t bhi[2], blo[2];
        split_tf32(bv.x, bhi[0], blo[0]);
        split_tf32(bv.y, bhi[1], blo[1]);
        mma_tf32(acc[nt][0], ahi[ks], bhi[0], bhi[1]);
        mma_tf32(acc[nt][1], alo[ks], bhi[0], bhi[1]);
        mma_tf32(acc[nt][1], ahi[ks], blo[0], blo[1]);
      }
    }
  }
}

// Copy the warp's kw channels of pixels [0, npx) of a staged piece to its
// ring stage (row stride rs floats), in 16-byte pieces; a lane steps over
// the flat (pixel, piece) range by 32 without dividing.
__device__ __forceinline__ void stage_pixels(float* dst, const float* __restrict__ src, int npx,
                                             int kw, int c, int rs, int lane) {
  const int q = kw >> 2;  // 16-byte pieces a pixel
  if (q == 0) return;
  const int dq = 32 / q, dr = 32 - dq * q;
  int px = lane / q, ch = lane - px * q;
  while (px < npx) {
    cp_async16(smem_addr(dst + px * rs + 4 * ch), src + px * c + 4 * ch);
    px += dq;
    ch += dr;
    if (ch >= q) {
      ch -= q;
      ++px;
    }
  }
}

// Window start floor(c) - r, clamped in float to [-span - 1, size + 1]
// (NaN takes the low end), as windowed_corr.cu clamps it.
__device__ __forceinline__ int window_start(float fl, int radius, int span, int size) {
  return (int)fminf(fmaxf(fl - (float)radius, (float)(-span - 1)), (float)(size + 1));
}

// One staged piece: union row y, columns [x, x + npx) with npx <= kStagePx.
// `end` is the row's last column + 1; y == y_end when the walk is done.
struct Stage {
  int y, x, end;
};

// kGeneral: levels [level0, level0 + levels) of out_levels, the window in
// tap tiles; else the fast case (level0 0, out_levels = levels, one tile)
template <bool kGeneral>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
windowed_corr_tf32_kernel(const float* __restrict__ f1, Levels lv,
                          const float* __restrict__ coords, float* __restrict__ out, int h,
                          int w, int c, int levels, int radius, int level0, int out_levels) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // this warp's channel slice: k-steps [ks0, ks0 + nks)
  const int ksteps = c >> 3;
  const int ks0 = warp * ksteps / kWarps;
  const int nks = (warp + 1) * ksteps / kWarps - ks0;
  const int kw0 = 8 * ks0, kw = 8 * nks;
  const int rs = row_floats(slice_channels(c));
  const int stage_floats = kStagePx * rs;
  float* ring = smem + warp * kStages * stage_floats;     // [kStages][kStagePx][rs], this warp's
  float* red = smem + kWarps * kStages * stage_floats;    // [2][kWarps][kElems][32]
  float* s = red + 2 * kWarps * kElems * 32;              // [kTileQ][kSRow]

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
  // this lane's accumulator rows are queries g and g + 8, its columns 2t, 2t+1
  const int g = lane >> 2, t4 = lane & 3, col = t4 * 2;

  // the warp's slice of the tile's f1 rows as A fragments, big and small,
  // for every level (rows past the image row are zeros)
  uint32_t ahi[kMaxKs][4], alo[kMaxKs][4];
  {
    const float* r0 = qx0 + g < w ? f1 + (q0 + g) * c + kw0 : nullptr;
    const float* r1 = qx0 + g + 8 < w ? f1 + (q0 + g + 8) * c + kw0 : nullptr;
#pragma unroll
    for (int ks = 0; ks < kMaxKs; ++ks) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (ks < nks) load_a(r0, r1, 8 * ks, t4, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(v[i], ahi[ks][i], alo[ks][i]);
    }
  }

  const float* cq = coords + (int64_t)2 * n * p + (int64_t)qy * w + qx0 + rq;
  const float cx_full = q_ok ? cq[0] : 0.0f, cy_full = q_ok ? cq[p] : 0.0f;
  int buf = 0;  // the partial sums' buffer of the next piece

  for (int l = 0; l < levels; ++l) {
    const int hl = lv.h[l], wl = lv.w[l];
    const float* __restrict__ f2 = lv.f2[l] + (int64_t)n * hl * wl * c + kw0;
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
      // at its first column; y == uy1 when there is none (every warp walks
      // the same rows)
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
        stage_pixels(ring + slot * stage_floats, f2 + ((int64_t)st.y * wl + st.x) * c,
                     min(kStagePx, st.end - st.x), kw, c, rs, lane);
      };

      __syncthreads();  // the last tile's blend has read the sums
      float4* s4 = reinterpret_cast<float4*>(s);
      for (int i = threadIdx.x; i < kTileQ * kSRow / 4; i += kThreads) {
        s4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncthreads();

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
        float acc[kNT][2][4] = {};
        const float* stage = ring + slot * stage_floats;
        if (nks == kMaxKs) {
          if (kNT == 2 && npx > 8) {
            stage_dots<kNT, true>(ahi, alo, stage, rs, nks, g, t4, acc);
          } else {
            stage_dots<1, true>(ahi, alo, stage, rs, nks, g, t4, acc);
          }
        } else if (kNT == 2 && npx > 8) {
          stage_dots<kNT, false>(ahi, alo, stage, rs, nks, g, t4, acc);
        } else {
          stage_dots<1, false>(ahi, alo, stage, rs, nks, g, t4, acc);
        }
        // the warp's partial sums, element e of n-tile t at [buf][warp][4t + e][lane]
        float* part = red + buf * kWarps * kElems * 32;
#pragma unroll
        for (int t = 0; t < kNT; ++t) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            part[(warp * kElems + 4 * t + e) * 32 + lane] = acc[t][0][e] + acc[t][1][e];
          }
        }
        __syncthreads();
        // warp w owns elements w, w + kWarps, ...: their sums over the warps
        // in a fixed order, each (query, pixel) into the query's sums if the
        // pixel is in its window; columns past the piece hold no copied pixel
#pragma unroll
        for (int i = warp; i < kElems; i += kWarps) {
          const int t = i >> 2, hi = (i >> 1) & 1, px = 8 * t + col + (i & 1);
          const int dy = comp.y - (hi ? y0_hi : y0_lo);
          const int dx = comp.x + px - (hi ? x0_hi : x0_lo);
          if (px < npx && (unsigned)dy < (unsigned)sy && (unsigned)dx < (unsigned)sx) {
            float v = part[i * 32 + lane];
#pragma unroll
            for (int u = 1; u < kWarps; ++u) v += part[(u * kElems + i) * 32 + lane];
            s[(g + 8 * hi) * kSRow + dy * sx + dx] = v;
          }
        }
        buf ^= 1;
        __syncwarp();
        comp = next(comp);
        slot = slot + 1 == kStages ? 0 : slot + 1;
      }
      cp_async_wait<0>();
      __syncthreads();  // every piece's sums are in

      // tent blend, no contraction into FMAs: the plain version's order; each
      // half-warp takes an output channel, 16 queries
      const float ofy = 1.0f - fy, ofx = 1.0f - fx;
      const float* sq = s + rq * kSRow;
      float* o = out + ((int64_t)n * (kGeneral ? out_levels : levels) * nout +
                        (int64_t)(kGeneral ? level0 + l : l) * nout) * p + (int64_t)qy * w + qx0 + rq;
      // the tile's outputs k = i * nj + j, x offset i0 + i (outer), y offset j0 + j
      for (int k = 2 * warp + (lane >> 4); k < ni * nj; k += 2 * kWarps) {
        const int i = k / nj, j = k - i * nj;
        const float* r0 = sq + j * sx + i;
        const float* r1 = r0 + sx;
        const float sy0 = __fadd_rn(__fmul_rn(r0[0], ofy), __fmul_rn(r1[0], fy));
        const float sy1 = __fadd_rn(__fmul_rn(r0[1], ofy), __fmul_rn(r1[1], fy));
        const float v = __fadd_rn(__fmul_rn(sy0, ofx), __fmul_rn(sy1, fx));
        if (q_ok) o[(int64_t)((i0 + i) * win + j0 + j) * p] = v;
      }
    }
  }
}

// Above 48 KB a block's dynamic shared memory must be allowed; the carveout
// asks for all of the SM's 228 KB as shared memory. Set once an instance.
template <bool kGeneral>
cudaError_t configure() {
  static bool configured = false;
  if (configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(windowed_corr_tf32_kernel<kGeneral>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes(kMaxC));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(windowed_corr_tf32_kernel<kGeneral>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  }
  configured = err == cudaSuccess;
  return err;
}

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
  const Levels lv = {{static_cast<const float*>(f2_0), static_cast<const float*>(f2_1),
                      static_cast<const float*>(f2_2), static_cast<const float*>(f2_3)},
                     {h0, h1, h2, h3},
                     {w0, w1, w2, w3}};
  for (int l = 0; l < levels; ++l) {
    if (lv.h[l] < 0 || lv.w[l] < 0) return (int)cudaErrorInvalidValue;
  }
  const int64_t tiles = (int64_t)n * h * ((w + kTileQ - 1) / kTileQ);
  if (tiles > 0) {
    const cudaError_t err = configure<kGeneral>();
    if (err != cudaSuccess) return (int)err;
    windowed_corr_tf32_kernel<kGeneral><<<(int)tiles, kThreads, smem_bytes(c), (cudaStream_t)stream>>>(
        static_cast<const float*>(f1), lv, coords, static_cast<float*>(out), h, w, c, levels,
        radius, level0, out_levels);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory a block takes at C = c.
extern "C" int windowed_corr_tf32_smem_bytes(int c) { return smem_bytes(c); }

// Blocks of the kernel an SM holds at C = c (each kWarps warps), or -1 on an
// error.
extern "C" int windowed_corr_tf32_blocks_per_sm(int c) {
  int blocks = 0;
  if (configure<false>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, windowed_corr_tf32_kernel<false>, kThreads,
                                                    smem_bytes(c)) != cudaSuccess) {
    return -1;
  }
  return blocks;
}

// The fast case. f1 (N, H*W, C); f2_l (N, h_l, w_l, C) for l < levels
// (unused pointers may be null); coords (N, 2, H, W); out (N,
// levels*(2r+1)^2, H, W); all float32, contiguous, 16-byte aligned device
// pointers. C a multiple of 8 in [8, 256], 1 <= levels <= 4, 0 <= radius <=
// 4, N*H*W < 2**31. Launches on `stream`; returns the first CUDA error
// (cudaGetLastError()).
extern "C" int windowed_corr_tf32_lookup(const void* f1, const void* f2_0, const void* f2_1,
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
extern "C" int windowed_corr_tf32_lookup_general(const void* f1, const void* f2_0,
                                                 const void* f2_1, const void* f2_2,
                                                 const void* f2_3, const float* coords, void* out,
                                                 int n, int h, int w, int c, int levels,
                                                 int radius, int level0, int out_levels, int h0,
                                                 int h1, int h2, int h3, int w0, int w1, int w2,
                                                 int w3, void* stream) {
  return launch<true>(f1, f2_0, f2_1, f2_2, f2_3, coords, out, n, h, w, c, levels, radius, level0,
                      out_levels, h0, h1, h2, h3, w0, w1, w2, w3, stream);
}
