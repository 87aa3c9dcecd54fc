// Backward of the windowed correlation lookup, for sm_90a.
//
// Replaces the gradient of gimmvfi_tpu/ops/corr.py:windowed_corr_lookup, which
// the JAX package takes by XLA autodiff (an XLA function, no Pallas kernel).
// It computes d_f1, d_levels and d_coords of the lookup of
// csrc/windowed_corr_mma.cu / csrc/windowed_corr_tf32.cu from the output's
// gradient g; its plain version is ops/corr.py:windowed_corr_lookup_backward_plain.
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
// ds depends on g, fx and fy only; the dots s only d_coords needs. A query
// with a non-finite coordinate has NaN fx or fy, so NaN ds: as in autograd
// of the plain lookup, whose taps off the map are zeros times ds, its d_f1 is
// NaN (a non-finite ds on a tap off the map makes the query's d_f1 NaN) and
// it adds nothing to d_levels (every tap is off the map).
//
// Layouts as the forward's: f1 (N, P, C) pre-scaled by 1/sqrt(C); level l
// (N, h_l, w_l, C); coords (N, 2, H, W) float32; g (N, L*(2r+1)^2, H, W);
// d_f1 as f1; d_f2_l as level l; d_coords (N, 2, H, W) float32, or null when
// not needed. f1, the levels, g, d_f1 and d_levels are float32, or bf16.
//
// What bounds it on the H100: for each tap on the map, the dot again (two
// operations a channel; only d_coords needs it) and d_f1's and d_f2's
// shares (four operations a channel), on the tensor cores as this kernel
// takes them: bf16 dots at the dense bf16 peak (989 TFLOP/s), 3xTF32 dots
// and the ds x feature products (two TF32 products each for bf16 features,
// three for float32) at the dense TF32 peak (495 TFLOP/s;
// tools/windowed_ablate.py: bwd_bound). At the 2048x1088 DS 1.0 RAFT lookup
// (N = 2, P = 34,816, C = 256, 4 levels, r = 4, in-frame coordinates, bf16)
// that is ~13 GFLOP of dots and ~25 GFLOP of products, 0.116 ms, where its
// bytes (~0.21 GB) take 0.063 ms: operations bound it.
//
// The kernel it replaces (a warp a query) took 2-3% of the CUDA-core bound:
// about three quarters of its time were d_levels' float32 atomics (many
// queries' windows overlap on a pooled map: ~6,400 adds a pixel a channel
// at the coarsest level of that lookup), and every tap's pixel was read
// from global memory twice a query. This design has two parts, run by one
// wrapper call on one stream, with no atomic anywhere:
//
// 1. The query side (`windowed_corr_bwd_query_kernel`): the walk of the
//    forward tile kernels. A block of 4 warps owns 16 consecutive queries of
//    one image row; each warp a slice of the channels. For each level it
//    computes the 16 queries' ds from g (in shared memory, and into a
//    float32 scratch (N, L, P, (2r+2)^2) for part 2), each query's key (the
//    8x8 tile of the padded map its window's base falls in) and base; then
//    walks the union of the tile's windows a row at a time, pieces of 16
//    pixels staged once by cp.async into each warp's ring. From each piece:
//      - d_f1 += ds_piece (16 queries x 16 pixels, zero off a query's window)
//        x pixels (16 x the warp's channels) on the tensor cores: mma.sync
//        m16n8k8 TF32 with ds split in two TF32 parts (big, small); a
//        float32 pixel also split, 3 products (3xTF32: ~2^-22 a product), a
//        bf16 pixel is exact in TF32, 2 products;
//      - with d_coords, the dots as the forward kernels take them (bf16
//        m16n8k8 mma for bf16, 3xTF32 for float32), the 4 warps' partial
//        sums added in shared memory in a fixed order, then dfx, dfy.
//    So each window pixel is read from global memory once a tile and level,
//    and d_f1 and d_coords are written once a query. Where the tiles are few
//    (`ops/corr.py: bwd_split_levels`: the stage-2 step's 28x28 lookups,
//    720p F's AMT lookup) a block takes one (tile, level), level 0's first,
//    and `windowed_corr_bwd_level_sum_kernel` adds the levels' d_f1 and
//    d_coords in level order.
// 2. The destination side, d_levels written once an element: torch.sort
//    (stable) orders the (query, level) entries by key (between the two
//    launchers, in the wrapper); `windowed_corr_bwd_offsets_kernel` finds
//    each key's first entry; `windowed_corr_bwd_plan_kernel` (one block)
//    counts each 8x8 destination tile's candidates, the entries of the 3 x
//    3 key tiles whose windows can reach it (a window of up to 10 pixels
//    reaches at most 3 tiles of 8 along each axis; the 3 key tiles of a key
//    row are one contiguous run of sorted entries), cuts each tile's list
//    into chunks of `chunk_q` entries (`ops/corr.py: bwd_chunk_queries`)
//    and lays the chunks out by a scan; `windowed_corr_bwd_dest_kernel`
//    takes one chunk a block: batches of 32 candidates, of which it keeps
//    those whose window reaches the tile (in list order) and stages their
//    f1 and ds rows by cp.async; D (64 pixels x C) += DS (64 pixels x 8
//    entries) x F1 (8 entries x C) a k-step at a time on the tensor cores
//    (ds split in two TF32 parts, as above; each k-step summed from zero
//    and added to D by a float32 add: chained in the tensor cores'
//    accumulators, a d_levels element's thousands of k-steps drifted past
//    one bf16 step of the plain sums); a tile of one chunk writes its
//    d_f2 in the features' dtype, a tile of several writes float32
//    partials, and `windowed_corr_bwd_chunk_sum_kernel` adds them in chunk
//    order. Every sum has one fixed order: the result is bitwise repeatable
//    from call to call.
// tools/windowed_ablate.py: bwd_order_model is this partition and order in
// plain torch.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit, device time
// of the whole call (tools/windowed_ablate.py --bwd, in turns with the
// atomic kernel it replaces, that kernel's own time beside it): 0.287 ms at
// the stage-2 AMT lookup (4, 28x28, C 256, float32; 0.73 before),
// 1.28-1.30 ms at the 720p F AMT lookup (1, 92x160, float32; 5.12-5.18),
// 3.97-4.03 ms at the 2048x1088 DS 1.0 RAFT lookup (2, 136x256, bf16;
// 24.74), 2.5-3.6% of the bound above. The query side is 56-69% of it (its
// tile walk; deeper cp.async rings gained nothing), the destination side
// 21-26%, the sort, offsets and plan 0.04-0.06 ms. ptxas: the query kernel
// 168 registers (float32: 28 bytes of spill stores; bf16: none), the
// destination kernel 128 (16 bytes of spill stores, both dtypes).
// chip_smoke.py phase 12 (e): the windowed stage-2 step's 42 backwards
// 6.96 ms of their own kernels' time (31.30 before).
//
// That is the fast case: at most 4 levels and a radius of at most 4. Any
// other radius and level count takes the general case, the same two parts
// with three changes:
//   - levels in groups of at most 4, each group a backward of its own (its
//     keys, sort, plan and destination side; its first level's index gives
//     the coordinates' scale and g's channels); the query side
//     (`windowed_corr_bwd_query_general_kernel`) takes a block a (tile,
//     level) and writes float32 parts of d_f1 and d_coords a level, which
//     `windowed_corr_bwd_level_sum` adds over all levels in level order;
//   - the window in tap tiles of at most 9 x 9 outputs, as the forward
//     kernels' general case: the query side computes every tap's ds from g
//     (in global memory) into the scratch first, then walks each tile's
//     (ni+1) x (nj+1) taps as the fast case walks its window: the dots of
//     the tile's taps give the tile's outputs' terms of dfx and dfy, and
//     d_f1 takes ds x pixel on the taps the tile owns (its first ni and nj
//     tap columns and rows, the last tile of a row or column also the
//     window's last), so each tap counts once;
//   - the key geometry follows the span: keys are 8x8 tiles of window bases
//     on the map padded by pad = 8 ceil((span - 1) / 8) on its low sides, and
//     a destination tile's candidates are the reach x reach key tiles from
//     its own (reach = pad / 8 + 1; the fast case keeps pad 16 and reach 3);
//     the destination side stages, for each kept candidate, the 8x8 block of
//     its ds that falls on the tile (zeros off its window).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 256;
constexpr int kMaxLevels = 4;
constexpr int kMaxRadius = 4;
constexpr int kMaxSpan = 2 * kMaxRadius + 2;
constexpr int kMaxWin = kMaxSpan - 1;  // outputs a tap tile of the general case a side
constexpr int kKeyPad = 16;  // a live window's base x0 >= -(span - 1) >= -9, so x0 + 16 >= 0
constexpr int kReach = 3;    // key tiles a side of a destination tile's candidates (fast case)
constexpr int kTile = 8;     // destination tiles: 8x8 pixels of a level's map
constexpr int kFar = 1 << 30;  // an empty extent is [kFar, -kFar)
constexpr unsigned kAll = 0xffffffffu;

// part 1, the query side
constexpr int kTileQ = 16;         // queries a block's tile: the mma's M
constexpr int kWarps = 4;          // warps a block, each a slice of the channels
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 3;      // asks ptxas for <= 170 registers
constexpr int kStagePx = 16;       // target pixels a ring stage holds
constexpr int kStages = 2;         // ring stages a warp; kStages - 1 copies in flight
constexpr int kNT = kStagePx / 8;  // n-tiles of a stage (the dots), k-steps of it (d_f1)
constexpr int kElems = 4 * kNT;    // dot accumulator elements a lane
constexpr int kMaxKs = kMaxC / 8 / kWarps;  // k-steps of 8 channels a warp at most
// a query's integer taps in shared memory, an odd count so that 16 queries
// read 16 banks
constexpr int kSRow = kMaxSpan * kMaxSpan + 1;

// part 2, the destination side
constexpr int kDestThreads = 256;  // 8 warps: 4 pairs of pixel rows x 2 channel halves
constexpr int kBatch = 32;         // candidates a staging batch: warp 0's lanes
constexpr int kDestStages = 2;     // batches staged at once; kDestStages - 1 in flight
constexpr int kPlanThreads = 1024;
constexpr int kOffsetThreads = 256;
constexpr int kSumThreads = 256;

template <typename T>
struct Levels {
  const T* f2[kMaxLevels];
};

template <typename T>
struct LevelGrads {
  T* f2[kMaxLevels];
};

// The levels' sizes, key tiles and destination tiles. Keys: level l's
// (KY_l, KX_l) = ((h_l + pad + 7) / 8, (w_l + pad + 7) / 8) tiles of 8x8
// bases of the map padded by `pad` on the low sides (16 in the fast case:
// (h_l + 23) / 8); image n, level l, base (x0, y0) has key n *
// keys_per_image + key_base[l] + ((y0 + pad) / 8) * KX_l + (x0 + pad) / 8;
// a window off the map (or a non-finite coordinate) the sentinel n_images *
// keys_per_image. A destination tile's candidates are the reach x reach key
// tiles from its own row and column. Destination tiles: (TY_l, TX_l) =
// ((h_l + 7) / 8, (w_l + 7) / 8) a level, numbered image, level, row, column.
struct Geometry {
  int h[kMaxLevels], w[kMaxLevels];
  int kx[kMaxLevels], key_base[kMaxLevels];
  int tx[kMaxLevels], tile_base[kMaxLevels];
  int keys_per_image, tiles_per_image, sentinel;
  int pad, reach;
};

// The key padding of a span's general case: a live window's base x0 >=
// -(span - 1), padded to a multiple of 8.
int general_pad(int span) { return 8 * ((span - 1 + 7) / 8); }

Geometry make_geometry(int n, int levels, const int* h, const int* w, int pad = kKeyPad) {
  Geometry geo = {};
  geo.pad = pad;
  geo.reach = pad / 8 + 1;
  for (int l = 0; l < levels; ++l) {
    geo.h[l] = h[l];
    geo.w[l] = w[l];
    geo.kx[l] = (w[l] + pad + 7) / 8;
    geo.key_base[l] = geo.keys_per_image;
    geo.keys_per_image += geo.kx[l] * ((h[l] + pad + 7) / 8);
    geo.tx[l] = (w[l] + 7) / 8;
    geo.tile_base[l] = geo.tiles_per_image;
    geo.tiles_per_image += geo.tx[l] * ((h[l] + 7) / 8);
  }
  geo.sentinel = n * geo.keys_per_image;
  return geo;
}

// Destination tile `tile` as (image, level, tile row, tile column).
__device__ __forceinline__ void tile_coords(const Geometry& geo, int levels, int tile, int& n, int& l,
                                            int& ty, int& tx) {
  n = tile / geo.tiles_per_image;
  const int r = tile - n * geo.tiles_per_image;
  l = 0;
  while (l + 1 < levels && geo.tile_base[l + 1] <= r) ++l;
  const int in_level = r - geo.tile_base[l];
  ty = in_level / geo.tx[l];
  tx = in_level - ty * geo.tx[l];
}

// The first key of a destination tile's first candidate key row: its key
// rows are ty .. ty + reach - 1, each the key tiles tx .. tx + reach - 1.
__device__ __forceinline__ int first_candidate_key(const Geometry& geo, int n, int l, int ty, int tx) {
  return n * geo.keys_per_image + geo.key_base[l] + ty * geo.kx[l] + tx;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, asynchronous
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
// 16 bytes, of which the first src_bytes come from src and the rest are zeros
__device__ __forceinline__ void cp_async16z(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}
// 4 bytes, from src if src_bytes is 4, else a zero
__device__ __forceinline__ void cp_async4z(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = big + small as TF32 mma operands, big = cvt.rna.tf32(x) and small =
// cvt.rna.tf32(x - big), by the integer steps ptxas emits for cvt.rna before
// an mma (windowed_corr_tf32.cu): the tensor cores read the top 19 bits.
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

// d += a (16x8, row) * b (8x8, col), bf16 in, float32 accumulators
__device__ __forceinline__ void mma_bf16(float d[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(uint16_t v) { return __uint_as_float((uint32_t)v << 16); }

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  // round to nearest even; a NaN stays a NaN
  const uint32_t u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

// 4 consecutive values of a staged row, as float
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const uint16_t* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(uint16_t* p, const float v[8]) {
  uint4 u;
  u.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
  u.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
  u.z = bf16_bits(v[4]) | (bf16_bits(v[5]) << 16);
  u.w = bf16_bits(v[6]) | (bf16_bits(v[7]) << 16);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(uint16_t* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf16_bits(v.x) | (bf16_bits(v.y) << 16),
                                            bf16_bits(v.z) | (bf16_bits(v.w) << 16));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(uint16_t* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = bf16_bits(a) | (bf16_bits(b) << 16);
}

// d += t, a k-step's products summed by the tensor cores: their float32
// accumulation is not rounded to nearest as an add is, and its error grows
// with a sum's length, so each k-step starts from zero and a long sum (a
// d_levels element takes up to thousands of k-steps) is carried by float32
// adds, as the plain version's.
__device__ __forceinline__ void add_step(float d[4], const float t[4]) {
  d[0] += t[0];
  d[1] += t[1];
  d[2] += t[2];
  d[3] += t[3];
}

// What the query side does differently for float32 and bf16 features: the
// staged rows' stride, the dots' A and B fragments and mma, and a pixel as a
// TF32 operand of the d_f1 product.
template <typename T>
struct Feat;

template <>
struct Feat<float> {
  // a staged row of `slice` channels padded to 8 (mod 32) words: a
  // half-warp's 64-bit loads of 4 rows x 8 floats hit 32 banks, and the
  // d_f1 product's loads (4 rows x 8 channels) too
  __host__ __device__ static constexpr int row_elems(int slice) { return slice + ((8 - slice) & 31); }
  // the dots' A fragment of the k-step at channel k (rows r0, r1: queries g,
  // g + 8; null past the image row): channels k + 2t, k + 2t + 1 as the
  // mma's k indices t and t + 4
  static __device__ __forceinline__ void load_a(const float* r0, const float* r1, int k, int t,
                                                uint32_t a[4]) {
    const float2 lo = r0 ? __ldg(reinterpret_cast<const float2*>(r0 + k + 2 * t)) : make_float2(0.f, 0.f);
    const float2 hi = r1 ? __ldg(reinterpret_cast<const float2*>(r1 + k + 2 * t)) : make_float2(0.f, 0.f);
    a[0] = __float_as_uint(lo.x);
    a[1] = __float_as_uint(hi.x);
    a[2] = __float_as_uint(lo.y);
    a[3] = __float_as_uint(hi.y);
  }
  // one k-step of the dots (3xTF32) by the first NT n-tiles of a stage
  template <int NT>
  static __device__ __forceinline__ void dots(float (&acc)[kNT][2][4], const uint32_t a[4],
                                              const float* stage, int rs, int k, int g, int t) {
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[i]), ahi[i], alo[i]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 bv = *reinterpret_cast<const float2*>(stage + (8 * nt + g) * rs + k + 2 * t);
      uint32_t bhi[2], blo[2];
      split_tf32(bv.x, bhi[0], blo[0]);
      split_tf32(bv.y, bhi[1], blo[1]);
      mma_tf32(acc[nt][0], ahi, bhi[0], bhi[1]);
      mma_tf32(acc[nt][1], alo, bhi[0], bhi[1]);
      mma_tf32(acc[nt][1], ahi, blo[0], blo[1]);
    }
  }
  static __device__ __forceinline__ float pixel(const float* stage, int rs, int px, int ch) {
    return stage[px * rs + ch];
  }
  // d += ds (big + small) x pixels: 3 products, the small x small dropped,
  // into a zeroed step sum, added to d by one float32 add (`add_step`)
  static __device__ __forceinline__ void product(float d[4], const uint32_t ahi[4],
                                                 const uint32_t alo[4], float b0, float b1) {
    uint32_t bhi[2], blo[2];
    split_tf32(b0, bhi[0], blo[0]);
    split_tf32(b1, bhi[1], blo[1]);
    float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_tf32(t, ahi, bhi[0], bhi[1]);
    mma_tf32(t, alo, bhi[0], bhi[1]);
    mma_tf32(t, ahi, blo[0], blo[1]);
    add_step(d, t);
  }
};

template <>
struct Feat<uint16_t> {
  // a staged row padded to 4 (mod 32) words: the dots' 32-bit loads of 8
  // rows x 4 words hit 32 banks, and the d_f1 product's (4 rows x 4 words)
  __host__ __device__ static constexpr int row_elems(int slice) {
    return 2 * (slice / 2 + ((4 - slice / 2) & 31));
  }
  // the bf16 m16n8k8 A fragment: channels k + 2t, k + 2t + 1 of queries g, g + 8
  static __device__ __forceinline__ void load_a(const uint16_t* r0, const uint16_t* r1, int k, int t,
                                                uint32_t a[4]) {
    a[0] = r0 ? __ldg(reinterpret_cast<const unsigned int*>(r0 + k + 2 * t)) : 0u;
    a[1] = r1 ? __ldg(reinterpret_cast<const unsigned int*>(r1 + k + 2 * t)) : 0u;
    a[2] = a[3] = 0u;
  }
  template <int NT>
  static __device__ __forceinline__ void dots(float (&acc)[kNT][2][4], const uint32_t a[4],
                                              const uint16_t* stage, int rs, int k, int g, int t) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint32_t b = *reinterpret_cast<const uint32_t*>(stage + (8 * nt + g) * rs + k + 2 * t);
      mma_bf16(acc[nt][k & 8 ? 1 : 0], a[0], a[1], b);
    }
  }
  static __device__ __forceinline__ float pixel(const uint16_t* stage, int rs, int px, int ch) {
    return to_float(stage[px * rs + ch]);
  }
  // a bf16 pixel is exact in TF32: d += ds (big + small) x pixels, 2
  // products, as Feat<float>'s
  static __device__ __forceinline__ void product(float d[4], const uint32_t ahi[4],
                                                 const uint32_t alo[4], float b0, float b1) {
    float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_tf32(t, ahi, __float_as_uint(b0), __float_as_uint(b1));
    mma_tf32(t, alo, __float_as_uint(b0), __float_as_uint(b1));
    add_step(d, t);
  }
};

// Channels of the widest warp slice at C = c.
__host__ __device__ constexpr int slice_channels(int c) { return 8 * ((c / 8 + kWarps - 1) / kWarps); }

template <typename T>
__host__ __device__ constexpr int ring_bytes(int c) {
  return kWarps * kStages * kStagePx * Feat<T>::row_elems(slice_channels(c)) * (int)sizeof(T);
}

// Bytes of the query side's dynamic shared memory at C = c: the warps'
// rings, the dots' partial sums (two buffers), g then the dots, ds, the
// queries' geometry, the d_coords partials, the NaN flags.
template <typename T>
__host__ __device__ constexpr int query_smem_bytes(int c) {
  return ring_bytes<T>(c) +
         (2 * kWarps * kElems * 32 + 2 * kTileQ * kSRow + 2 * kTileQ + 2 * kWarps * kTileQ) * 4 +
         3 * kTileQ * 4;
}

// Copy the warp's kw channels of pixels [0, npx) of a staged piece to its
// ring stage (row stride rs elements), in 16-byte pieces; a lane steps over
// the flat (pixel, piece) range by 32 without dividing.
template <typename T>
__device__ __forceinline__ void stage_pixels(T* dst, const T* __restrict__ src, int npx, int kw,
                                             int c, int rs, int lane) {
  constexpr int per = 16 / (int)sizeof(T);  // elements a 16-byte piece
  const int q = kw / per;                   // pieces a pixel
  if (q == 0) return;
  const int dq = 32 / q, dr = 32 - dq * q;
  int px = lane / q, ch = lane - px * q;
  while (px < npx) {
    cp_async16(smem_addr(dst + px * rs + per * ch), src + px * c + per * ch);
    px += dq;
    ch += dr;
    if (ch >= q) {
      ch -= q;
      ++px;
    }
  }
}

// Window start floor(c) - r, clamped in float to [-span - 1, size + 1]
// (NaN takes the low end), as the forward kernels clamp it.
__device__ __forceinline__ int window_start(float fl, int radius, int span, int size) {
  return (int)fminf(fmaxf(fl - (float)radius, (float)(-span - 1)), (float)(size + 1));
}

// One staged piece: union row y, columns [x, x + npx) with npx <= kStagePx.
// `end` is the row's last column + 1; y == y_end when the walk is done.
struct Stage {
  int y, x, end;
};

// kGeneral: a block a (tile, level) of the group [level0, level0 + levels) of
// a lookup of out_levels levels, the window in tap tiles, float32 parts of
// d_f1 and d_coords a level; else the fast case (level0 0, out_levels =
// levels, one tile, `split` choosing the blocks).
template <typename T, bool kGeneral>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
windowed_corr_bwd_query_kernel(const T* __restrict__ f1, Levels<T> lv, Geometry geo,
                               const float* __restrict__ coords, const T* __restrict__ g,
                               T* __restrict__ d_f1, float* __restrict__ d_coords,
                               float* __restrict__ d_f1_part, float* __restrict__ d_coords_part,
                               float* __restrict__ ds_out, int* __restrict__ keys,
                               int* __restrict__ bases, int h, int w, int c, int levels,
                               int radius, int split, int level0, int out_levels) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this warp's channel slice: k-steps [ks0, ks0 + nks) of 8 channels
  const int ksteps = c >> 3;
  const int ks0 = warp * ksteps / kWarps;
  const int nks = (warp + 1) * ksteps / kWarps - ks0;
  const int kw0 = 8 * ks0, kw = 8 * nks;
  const int rs = Feat<T>::row_elems(slice_channels(c));
  const int stage_elems = kStagePx * rs;
  T* ring = reinterpret_cast<T*>(smem) + warp * kStages * stage_elems;  // this warp's
  float* red = reinterpret_cast<float*>(smem + ring_bytes<T>(c));      // [2][kWarps][kElems][32]
  // [kTileQ][kSRow]: a level's g, then its dots (general: a tap tile's dots)
  float* s = red + 2 * kWarps * kElems * 32;
  // [kTileQ][kSRow]: a level's ds (general: a tap tile's, on the taps it owns)
  float* sds = s + kTileQ * kSRow;
  float* sfxy = sds + kTileQ * kSRow;          // [kTileQ][2]: fx, fy
  float* spart = sfxy + 2 * kTileQ;            // [kWarps][kTileQ][2]: dfx, dfy partials
  int* sxy = reinterpret_cast<int*>(spart + 2 * kWarps * kTileQ);  // [kTileQ][2]: x0, y0
  int* sbad = sxy + 2 * kTileQ;  // [kTileQ]: a non-finite ds on a tap off the map, any level

  const int win = 2 * radius + 1, span = win + 1, nout = win * win, ntaps = span * span;
  // tap tiles a side: ceil(win / kMaxWin) in the general case
  const int parts = kGeneral ? (win + kMaxWin - 1) / kMaxWin : 1;
  const int p = h * w;
  const int tiles_x = (w + kTileQ - 1) / kTileQ;
  // split: a block a (tile, level), level 0's (the longest walks) first;
  // else a block a tile and every level
  const int ntiles = gridDim.x / (split ? levels : 1);
  const int tile = split ? blockIdx.x % ntiles : blockIdx.x;
  const int l_begin = split ? blockIdx.x / ntiles : 0;
  const int l_end = split ? l_begin + 1 : levels;
  const int n = tile / (h * tiles_x);
  const int rest = tile - n * h * tiles_x;
  const int qy = rest / tiles_x;
  const int qx0 = (rest - qy * tiles_x) * kTileQ;
  const int nq = min(kTileQ, w - qx0);  // the tile's queries
  const int pq0 = qy * w + qx0;         // the tile's first query in its image
  const int64_t q0 = (int64_t)n * p + pq0;
  const int rq = lane & (kTileQ - 1);  // the query whose geometry this lane holds
  const bool q_ok = rq < nq;
  // this lane's accumulator rows are queries gq and gq + 8; its columns 2t, 2t+1
  const int gq = lane >> 2, t4 = lane & 3;
  const bool want_coords = (split ? d_coords_part : d_coords) != nullptr;

  // the dots' A fragments: the warp's slice of the tile's f1 rows
  uint32_t af[kMaxKs][4];
  {
    const T* r0 = gq < nq ? f1 + (q0 + gq) * c + kw0 : nullptr;
    const T* r1 = gq + 8 < nq ? f1 + (q0 + gq + 8) * c + kw0 : nullptr;
#pragma unroll
    for (int ks = 0; ks < kMaxKs; ++ks) {
      af[ks][0] = af[ks][1] = af[ks][2] = af[ks][3] = 0u;
      if (want_coords && ks < nks) Feat<T>::load_a(r0, r1, 8 * ks, t4, af[ks]);
    }
  }
  float acc[kMaxKs][4];  // d_f1 of queries gq, gq + 8 at n-tile nt of the slice
#pragma unroll
  for (int nt = 0; nt < kMaxKs; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  float dcx = 0.0f, dcy = 0.0f;  // query rq's d_coords (warp 0)
  if (tid < kTileQ) sbad[tid] = 0;

  const float* cq = coords + (int64_t)2 * n * p + pq0 + rq;
  const float cx_full = q_ok ? cq[0] : 0.0f, cy_full = q_ok ? cq[p] : 0.0f;
  int buf = 0;  // the dots' partial sums' buffer of the next piece

  for (int l = l_begin; l < l_end; ++l) {
    const int hl = geo.h[l], wl = geo.w[l];
    const T* __restrict__ f2 = lv.f2[l] + (int64_t)n * hl * wl * c + kw0;
    // exact: a power of two
    const float scale = kGeneral ? ldexpf(1.0f, -(level0 + l)) : 1.0f / (float)(1 << l);
    const float cx = cx_full * scale, cy = cy_full * scale;
    const float flx = floorf(cx), fly = floorf(cy);
    const float fx = cx - flx, fy = cy - fly;
    int x0_full = window_start(flx, radius, span, wl);
    const int y0_full = window_start(fly, radius, span, hl);
    if (!q_ok) x0_full = -span - 1;  // a query past the image row takes no tap
    // the whole window on the map (its key), or off it
    const bool live = max(x0_full, 0) < min(x0_full + span, wl) && max(y0_full, 0) < min(y0_full + span, hl);
    const int pad = kGeneral ? geo.pad : kKeyPad;
    const int64_t entry0 = ((int64_t)n * levels + l) * p + pq0;  // the tile's first entry

    __syncthreads();  // the last level's readers of s, sds and the geometry are done
    if (warp == 0 && lane < kTileQ) {
      sfxy[2 * lane] = fx;
      sfxy[2 * lane + 1] = fy;
      sxy[2 * lane] = x0_full;
      sxy[2 * lane + 1] = y0_full;
      if (q_ok) {
        keys[entry0 + lane] = live ? n * geo.keys_per_image + geo.key_base[l] +
                                         ((y0_full + pad) >> 3) * geo.kx[l] + ((x0_full + pad) >> 3)
                                   : geo.sentinel;
        bases[entry0 + lane] = (x0_full & 0xffff) | (int)((uint32_t)y0_full << 16);
      }
    }
    // this level's g of the tile's queries, gv[i * win + j] at (i * win + j) * p
    const T* __restrict__ gl =
        g + ((int64_t)n * (kGeneral ? out_levels : levels) * nout +
             (int64_t)(kGeneral ? level0 + l : l) * nout) * p + pq0;
    if (kGeneral) {
      __syncthreads();
      // ds of each query and tap into the scratch (the tile's entries' rows
      // are contiguous there), g read from global memory
      for (int64_t e = tid; e < (int64_t)nq * ntaps; e += kThreads) {
        const int qq = (int)(e / ntaps), t = (int)(e - (int64_t)qq * ntaps);
        const int a = t / span, b = t - a * span;
        const float qfx = sfxy[2 * qq], qfy = sfxy[2 * qq + 1];
        const float ofx = 1.0f - qfx, ofy = 1.0f - qfy;
        const T* gv = gl + qq;
        auto gat = [&](int i, int j) { return to_float(gv[((int64_t)i * win + j) * p]); };
        auto dsy = [&](int j) {
          return b == 0     ? gat(0, j) * ofx
                 : b == win ? gat(win - 1, j) * qfx
                            : gat(b, j) * ofx + gat(b - 1, j) * qfx;
        };
        const float d = a == 0 ? dsy(0) * ofy : a == win ? dsy(win - 1) * qfy : dsy(a) * ofy + dsy(a - 1) * qfy;
        ds_out[(entry0 + qq) * ntaps + t] = d;
        const int y = sxy[2 * qq + 1] + a, x = sxy[2 * qq] + b;
        if (!(y >= 0 && y < hl && x >= 0 && x < wl) && !isfinite(d)) sbad[qq] = 1;
      }
    } else {
      for (int e = tid; e < nout * kTileQ; e += kThreads) {
        const int k = e >> 4, qq = e & (kTileQ - 1);
        s[qq * kSRow + k] = qq < nq ? to_float(gl[(int64_t)k * p + qq]) : 0.0f;
      }
      __syncthreads();

      // ds of each query and tap, into sds and the scratch (the tile's
      // entries' rows are contiguous there)
      for (int e = tid; e < nq * ntaps; e += kThreads) {
        const int qq = e / ntaps, t = e - qq * ntaps;
        const int a = t / span, b = t - a * span;
        const float qfx = sfxy[2 * qq], qfy = sfxy[2 * qq + 1];
        const float ofx = 1.0f - qfx, ofy = 1.0f - qfy;
        const float* gv = s + qq * kSRow;  // gv[i * win + j]
        auto dsy = [&](int j) {
          return b == 0     ? gv[j] * ofx
                 : b == win ? gv[(win - 1) * win + j] * qfx
                            : gv[b * win + j] * ofx + gv[(b - 1) * win + j] * qfx;
        };
        const float d = a == 0 ? dsy(0) * ofy : a == win ? dsy(win - 1) * qfy : dsy(a) * ofy + dsy(a - 1) * qfy;
        sds[qq * kSRow + t] = d;
        ds_out[entry0 * ntaps + e] = d;
        const int y = sxy[2 * qq + 1] + a, x = sxy[2 * qq] + b;
        if (!(y >= 0 && y < hl && x >= 0 && x < wl) && !isfinite(d)) sbad[qq] = 1;
      }
    }
    __syncthreads();

    for (int tt = 0; tt < parts * parts; ++tt) {
      // tap tile (ti, tj): outputs x offset i0 .. i0 + ni - 1, y offset j0 ..
      // j0 + nj - 1, from the integer taps sx = ni + 1 a row, sy = nj + 1
      // rows; it owns its first ni columns and nj rows of them (the last
      // tile of a row or column also the window's last)
      const int ti = tt / parts, tj = tt - ti * parts;
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
      const int x0_lo = __shfl_sync(kAll, x0, gq), y0_lo = __shfl_sync(kAll, y0, gq);
      const int x0_hi = __shfl_sync(kAll, x0, gq + 8), y0_hi = __shfl_sync(kAll, y0, gq + 8);
      const int uy0 = __reduce_min_sync(kAll, wy0), uy1 = __reduce_max_sync(kAll, wy1);

      if (kGeneral) {
        // the tile's ds on the taps it owns, zeros on the others
        const int ox = ni + (ti == parts - 1), oy = nj + (tj == parts - 1);
        __syncthreads();  // the last tile's readers of s and sds are done
        for (int e = tid; e < nq * sy * sx; e += kThreads) {
          const int qq = e / (sy * sx), r = e - qq * (sy * sx);
          const int da = r / sx, db = r - da * sx;
          sds[qq * kSRow + r] =
              da < oy && db < ox ? __ldcg(ds_out + (entry0 + qq) * ntaps + (j0 + da) * span + i0 + db)
                                 : 0.0f;
        }
      }
      if (want_coords) {
        float4* s4 = reinterpret_cast<float4*>(s);
        for (int i = tid; i < kTileQ * kSRow / 4; i += kThreads) s4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (kGeneral || want_coords) __syncthreads();

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
        stage_pixels<T>(ring + slot * stage_elems, f2 + ((int64_t)st.y * wl + st.x) * c,
                        min(kStagePx, st.end - st.x), kw, c, rs, lane);
      };

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
        const T* stage = ring + slot * stage_elems;
        if (want_coords) {
          // the dots of the tile's queries with the piece's pixels, summed
          // over the warp's channels, then over the warps
          float dacc[kNT][2][4] = {};
#pragma unroll
          for (int ks = 0; ks < kMaxKs; ++ks) {
            if (ks < nks) {
              if (npx > 8) {
                Feat<T>::template dots<2>(dacc, af[ks], stage, rs, 8 * ks, gq, t4);
              } else {
                Feat<T>::template dots<1>(dacc, af[ks], stage, rs, 8 * ks, gq, t4);
              }
            }
          }
          float* part = red + buf * kWarps * kElems * 32;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              part[(warp * kElems + 4 * nt + e) * 32 + lane] = dacc[nt][0][e] + dacc[nt][1][e];
            }
          }
          __syncthreads();
          // warp w owns elements w, w + kWarps, ...: their sums over the warps
          // in a fixed order, each (query, pixel) into the query's dots if the
          // pixel is in its window
#pragma unroll
          for (int i = warp; i < kElems; i += kWarps) {
            const int nt = i >> 2, hi = (i >> 1) & 1, px = 8 * nt + 2 * t4 + (i & 1);
            const int dy = comp.y - (hi ? y0_hi : y0_lo);
            const int dx = comp.x + px - (hi ? x0_hi : x0_lo);
            if (px < npx && (unsigned)dy < (unsigned)sy && (unsigned)dx < (unsigned)sx) {
              float v = part[i * 32 + lane];
#pragma unroll
              for (int u = 1; u < kWarps; ++u) v += part[(u * kElems + i) * 32 + lane];
              s[(gq + 8 * hi) * kSRow + dy * sx + dx] = v;
            }
          }
          buf ^= 1;
        }
        // d_f1 += ds_piece x pixels: k-step kp takes the piece's pixels
        // 8kp .. 8kp + 7 (lane's: 8kp + t4 and 8kp + t4 + 4); pixels past the
        // piece are zeros on both sides (their ring rows hold stale values).
        // The slice's groups of 4 n-tiles take channel 32 j + 4 n + r as
        // n-tile 4 j + r's column n (one load of 4 channels a pixel); the
        // n-tiles past the last whole group take channel 8 nt + n.
        const float* row_lo = sds + gq * kSRow + (comp.y - y0_lo) * sx;
        const float* row_hi = sds + (gq + 8) * kSRow + (comp.y - y0_hi) * sx;
        const bool in_lo = (unsigned)(comp.y - y0_lo) < (unsigned)sy;
        const bool in_hi = (unsigned)(comp.y - y0_hi) < (unsigned)sy;
#pragma unroll
        for (int kp = 0; kp < kNT; ++kp) {
          if (nks > 0 && 8 * kp < npx) {
            const int px0 = 8 * kp + t4, px1 = px0 + 4;
            const bool ok0 = px0 < npx, ok1 = px1 < npx;
            const int dx_lo = comp.x + px0 - x0_lo, dx_hi = comp.x + px0 - x0_hi;
            uint32_t ahi[4], alo[4];
            split_tf32(ok0 && in_lo && (unsigned)dx_lo < (unsigned)sx ? row_lo[dx_lo] : 0.0f,
                       ahi[0], alo[0]);
            split_tf32(ok0 && in_hi && (unsigned)dx_hi < (unsigned)sx ? row_hi[dx_hi] : 0.0f,
                       ahi[1], alo[1]);
            split_tf32(ok1 && in_lo && (unsigned)(dx_lo + 4) < (unsigned)sx ? row_lo[dx_lo + 4] : 0.0f,
                       ahi[2], alo[2]);
            split_tf32(ok1 && in_hi && (unsigned)(dx_hi + 4) < (unsigned)sx ? row_hi[dx_hi + 4] : 0.0f,
                       ahi[3], alo[3]);
            const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int jg = 0; jg < kMaxKs / 4; ++jg) {
              if (4 * jg + 3 < nks) {
                const float4 b0 = ok0 ? load4(stage + px0 * rs + 32 * jg + 4 * gq) : zero;
                const float4 b1 = ok1 ? load4(stage + px1 * rs + 32 * jg + 4 * gq) : zero;
                Feat<T>::product(acc[4 * jg], ahi, alo, b0.x, b1.x);
                Feat<T>::product(acc[4 * jg + 1], ahi, alo, b0.y, b1.y);
                Feat<T>::product(acc[4 * jg + 2], ahi, alo, b0.z, b1.z);
                Feat<T>::product(acc[4 * jg + 3], ahi, alo, b0.w, b1.w);
              }
            }
#pragma unroll
            for (int nt = 0; nt < kMaxKs; ++nt) {
              if (nt >= nks / 4 * 4 && nt < nks) {
                const float b0 = ok0 ? Feat<T>::pixel(stage, rs, px0, 8 * nt + gq) : 0.0f;
                const float b1 = ok1 ? Feat<T>::pixel(stage, rs, px1, 8 * nt + gq) : 0.0f;
                Feat<T>::product(acc[nt], ahi, alo, b0, b1);
              }
            }
          }
        }
        __syncwarp();
        comp = next(comp);
        slot = slot + 1 == kStages ? 0 : slot + 1;
      }
      cp_async_wait<0>();
      __syncthreads();  // every piece's dots are in

      if (want_coords) {
        // dfx and dfy of each query: 8 threads a query, each a share of the
        // terms, added over the threads in a fixed order
        const int qq = tid & (kTileQ - 1), part = tid >> 4;
        float pfx = 0.0f, pfy = 0.0f;
        if (qq < nq) {
          const float qfx = sfxy[2 * qq], qfy = sfxy[2 * qq + 1];
          const float ofx = 1.0f - qfx, ofy = 1.0f - qfy;
          const T* __restrict__ gq_ = gl + qq;  // gv[i * win + j] at (i * win + j) * p
          const float* sq = s + qq * kSRow;
          if (kGeneral) {
            // the tile's outputs (x offset i0 + i, y offset j0 + j): g times
            // the derivatives of their blends in x and in y
            for (int k = part; k < ni * nj; k += kThreads / kTileQ) {
              const int i = k / nj, j = k - i * nj;
              const float gv = to_float(gq_[((int64_t)(i0 + i) * win + j0 + j) * p]);
              const float s00 = sq[j * sx + i], s01 = sq[j * sx + i + 1];
              const float s10 = sq[(j + 1) * sx + i], s11 = sq[(j + 1) * sx + i + 1];
              pfx += gv * ((s01 * ofy + s11 * qfy) - (s00 * ofy + s10 * qfy));
              pfy += gv * (ofx * (s10 - s00) + qfx * (s11 - s01));
            }
          } else {
            for (int k = part; k < win * span; k += kThreads / kTileQ) {
              const int j = k / span, b = k - j * span;
              const float g0 = b < win ? to_float(gq_[(int64_t)(b * win + j) * p]) : 0.0f;
              const float g1 = b > 0 ? to_float(gq_[(int64_t)((b - 1) * win + j) * p]) : 0.0f;
              const float d = b == 0 ? g0 * ofx : b == win ? g1 * qfx : g0 * ofx + g1 * qfx;
              const float s0 = sq[j * span + b], s1 = sq[(j + 1) * span + b];
              pfy += d * (s1 - s0);
              if (b < win) {
                const float sy0 = s0 * ofy + s1 * qfy;
                const float sy1 = sq[j * span + b + 1] * ofy + sq[(j + 1) * span + b + 1] * qfy;
                pfx += g0 * (sy1 - sy0);
              }
            }
          }
        }
        pfx += __shfl_xor_sync(kAll, pfx, 16);
        pfy += __shfl_xor_sync(kAll, pfy, 16);
        if (lane < kTileQ) {
          spart[2 * (warp * kTileQ + lane)] = pfx;
          spart[2 * (warp * kTileQ + lane) + 1] = pfy;
        }
        __syncthreads();
        if (warp == 0 && lane < kTileQ) {
          float sx_ = 0.0f, sy_ = 0.0f;
#pragma unroll
          for (int u = 0; u < kWarps; ++u) {
            sx_ += spart[2 * (u * kTileQ + lane)];
            sy_ += spart[2 * (u * kTileQ + lane) + 1];
          }
          dcx += sx_ * scale;
          dcy += sy_ * scale;
        }
      }
    }
  }
  __syncthreads();  // sbad is complete

  // d_f1: the warp's channels of queries gq and gq + 8, plus NaN where a
  // non-finite ds fell on a tap off the map; split, this level's part
  const float nan_lo = sbad[gq] ? __int_as_float(0x7fc00000) : 0.0f;
  const float nan_hi = sbad[gq + 8] ? __int_as_float(0x7fc00000) : 0.0f;
  // the queries of all images: a level's part of d_f1 holds nq_all rows
  const int64_t nq_all = (int64_t)ntiles / (h * tiles_x) * p;
  // the level's index among the parts
  const int64_t l_part = kGeneral ? level0 + l_begin : l_begin;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (gq + 8 * r < nq) {
      const int64_t q = q0 + gq + 8 * r;
      const float nan = r ? nan_hi : nan_lo;
      float* part = d_f1_part + (l_part * nq_all + q) * c + kw0;
      T* out = d_f1 + q * c + kw0;
      // a whole group's D: channels 32 j + 8 t .. + 7
#pragma unroll
      for (int jg = 0; jg < kMaxKs / 4; ++jg) {
        if (4 * jg + 3 < nks) {
          float v[8];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            v[u] = acc[4 * jg + u][2 * r] + nan;
            v[4 + u] = acc[4 * jg + u][2 * r + 1] + nan;
          }
          if (split) {
            store8(part + 32 * jg + 8 * t4, v);
          } else {
            store8(out + 32 * jg + 8 * t4, v);
          }
        }
      }
      // the other n-tiles' D: channels 8 nt + 2 t, + 1
#pragma unroll
      for (int nt = 0; nt < kMaxKs; ++nt) {
        if (nt >= nks / 4 * 4 && nt < nks) {
          if (split) {
            store2(part + 8 * nt + 2 * t4, acc[nt][2 * r] + nan, acc[nt][2 * r + 1] + nan);
          } else {
            store2(out + 8 * nt + 2 * t4, acc[nt][2 * r] + nan, acc[nt][2 * r + 1] + nan);
          }
        }
      }
    }
  }
  if (want_coords && warp == 0 && lane < kTileQ && q_ok) {
    float* dc = split ? d_coords_part + l_part * 2 * nq_all : d_coords;
    dc[(int64_t)2 * n * p + pq0 + lane] = dcx;
    dc[(int64_t)(2 * n + 1) * p + pq0 + lane] = dcy;
  }
}

// Split query side: d_f1 (and d_coords) the levels' parts added in level
// order, d_f1 cast once to the features' dtype; a thread 4 values.
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
windowed_corr_bwd_level_sum_kernel(const float* __restrict__ d_f1_part,
                                   const float* __restrict__ d_coords_part, T* __restrict__ d_f1,
                                   float* __restrict__ d_coords, int64_t nf4, int64_t nc, int levels) {
  const int64_t i = (int64_t)blockIdx.x * kSumThreads + threadIdx.x;
  if (i < nf4) {
    const float4* src = reinterpret_cast<const float4*>(d_f1_part) + i;
    float4 v = src[0];
    for (int l = 1; l < levels; ++l) {
      const float4 x = src[l * nf4];
      v.x += x.x;
      v.y += x.y;
      v.z += x.z;
      v.w += x.w;
    }
    store4(d_f1 + 4 * i, v);
  }
  if (d_coords != nullptr && i < nc) {
    float v = d_coords_part[i];
    for (int l = 1; l < levels; ++l) v += d_coords_part[l * nc + i];
    d_coords[i] = v;
  }
}

// offsets[k] = the first sorted entry whose key is >= k, for k in [0, sentinel]:
// entry i fills the keys in (key[i - 1], key[i]].
__global__ void __launch_bounds__(kOffsetThreads)
windowed_corr_bwd_offsets_kernel(const int* __restrict__ sorted_keys, int entries, int sentinel,
                                 int* __restrict__ offsets) {
  const int i = blockIdx.x * kOffsetThreads + threadIdx.x;
  if (i > entries) return;
  const int prev = i == 0 ? -1 : sorted_keys[i - 1];
  const int cur = i == entries ? sentinel : sorted_keys[i];
  for (int k = prev + 1; k <= cur; ++k) offsets[k] = i;
}

// One block: each destination tile's candidates (the entries of its reach
// key rows' runs: 3 in the fast case), its chunks max(1, ceil(count /
// chunk_q)) and their first index by an exclusive scan in tile order;
// chunk_start[tiles] is the total.
template <bool kGeneral>
__global__ void __launch_bounds__(kPlanThreads)
windowed_corr_bwd_plan_kernel(const int* __restrict__ offsets, Geometry geo, int levels, int tiles,
                              int chunk_q, int* __restrict__ chunk_start) {
  __shared__ int warp_sums[kPlanThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int carry = 0;
  for (int base = 0; base < tiles; base += kPlanThreads) {
    const int tile = base + tid;
    int count = 0;
    if (tile < tiles) {
      int n, l, ty, tx;
      tile_coords(geo, levels, tile, n, l, ty, tx);
      const int k0 = first_candidate_key(geo, n, l, ty, tx);
      const int reach = kGeneral ? geo.reach : kReach;
      int m = 0;
#pragma unroll
      for (int r = 0; r < reach; ++r) {
        m += offsets[k0 + r * geo.kx[l] + reach] - offsets[k0 + r * geo.kx[l]];
      }
      count = max(1, (m + chunk_q - 1) / chunk_q);
    }
    int v = count;  // inclusive scan in the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kAll, v, d);
      if (lane >= d) v += y;
    }
    if (lane == 31) warp_sums[warp] = v;
    __syncthreads();
    if (warp == 0) {
      int s = warp_sums[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kAll, s, d);
        if (lane >= d) s += y;
      }
      warp_sums[lane] = s;
    }
    __syncthreads();
    if (tile < tiles) chunk_start[tile] = carry + v - count + (warp ? warp_sums[warp - 1] : 0);
    carry += warp_sums[kPlanThreads / 32 - 1];
    __syncthreads();  // warp_sums is the next round's
  }
  if (tid == 0) chunk_start[tiles] = carry;
}

// Staged rows of the destination side: an f1 row of C zero-padded to a
// multiple of 32 channels (the B loads' groups), its stride padded to 8
// (mod 32) words, so that a quarter-warp's 16-byte loads (4 entries x 2 x 4
// channels, float32) and a half-warp's 8-byte ones (bf16) hit 32 banks; a ds
// row padded to 8 (mod 32) words, so that the A loads (4 entries x 8 pixel
// columns) do too.
__host__ __device__ constexpr int f1_channels(int c) { return (c + 31) / 32 * 32; }
template <typename T>
__host__ __device__ constexpr int f1_stride(int c) {
  return (f1_channels(c) * (int)sizeof(T) / 4 + ((8 - f1_channels(c) * (int)sizeof(T) / 4) & 31)) *
         4 / (int)sizeof(T);
}
__host__ __device__ constexpr int ds_stride(int ntaps) { return ntaps + ((8 - ntaps) & 31); }


// Bytes of the destination side's dynamic shared memory: kDestStages
// batches of f1 rows, ds rows, bases and entries, and the batches' counts;
// in the general case the ds rows are the 8x8 blocks on the tile, and the
// candidates' reach runs (start, first position) follow.
template <typename T>
__host__ __device__ constexpr int dest_smem_bytes(int c, int ntaps) {
  return kDestStages * (kBatch * (f1_stride<T>(c) * (int)sizeof(T) + ds_stride(ntaps) * 4 + 8) + 4);
}
template <typename T>
__host__ __device__ constexpr int dest_general_smem_bytes(int c, int reach) {
  return dest_smem_bytes<T>(c, kTile * kTile) + 2 * (reach + 1) * 4;
}

// One chunk a block: D (the tile's 64 pixels x C) += DS (64 pixels x the
// chunk's entries) x F1 (entries x C) on the tensor cores, in list order.
// kGeneral: reach x reach candidate key tiles (runs in shared memory), and
// each kept candidate's ds staged as the 8x8 block on the tile.
// The chunk's candidates come in batches of kBatch; warp 0 keeps only those
// whose window reaches the tile (in list order), and the block stages their
// f1 and ds rows by cp.async. k-steps of 8 entries: warp w owns the pixel
// rows 2 (w % 4), 2 (w % 4) + 1 (the mma's M: pixel column g of both rows)
// and half of the channels' groups of 32; a lane builds its A values (ds at
// its pixels, 0 off an entry's window) and splits them in two TF32 parts.
// The 4 n-tiles of a group take channel 32j + 4n + r as n-tile r's column
// n, so one load of 4 channels gives a lane its B values of all 4, and its
// D values are 8 consecutive channels a pixel. A float32 f1 is split too
// (3 products), a bf16 one is exact (2).
template <typename T, bool kGeneral>
__global__ void __launch_bounds__(kDestThreads, 2)
windowed_corr_bwd_dest_kernel(const T* __restrict__ f1, const float* __restrict__ ds,
                              const int64_t* __restrict__ order, const int* __restrict__ bases,
                              const int* __restrict__ offsets, const int* __restrict__ chunk_start,
                              Geometry geo, float* __restrict__ partial, LevelGrads<T> out, int p,
                              int c, int levels, int radius, int chunk_q, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunk = blockIdx.x;
  if (chunk >= chunk_start[tiles]) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int span = 2 * radius + 2, ntaps = span * span;
  // a staged ds row: the window's taps, or (general) the 8x8 block on the tile
  const int fs = f1_stride<T>(c), dst = ds_stride(kGeneral ? kTile * kTile : ntaps);
  // the chunk's tile: the last tile whose first chunk is <= chunk
  int lo = 0, hi = tiles;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (chunk_start[mid] <= chunk) lo = mid;
    else hi = mid;
  }
  const int tile = lo;
  const int j = chunk - chunk_start[tile];
  const int nchunks = chunk_start[tile + 1] - chunk_start[tile];
  int n, l, ty, tx;
  tile_coords(geo, levels, tile, n, l, ty, tx);
  const int hl = geo.h[l], wl = geo.w[l];
  const int k0 = first_candidate_key(geo, n, l, ty, tx);
  int run_start[kReach], run_len[kReach];
  int m = 0;
  if (!kGeneral) {
#pragma unroll
    for (int r = 0; r < kReach; ++r) {
      run_start[r] = offsets[k0 + r * geo.kx[l]];
      run_len[r] = offsets[k0 + r * geo.kx[l] + kReach] - run_start[r];
    }
    m = run_len[0] + run_len[1] + run_len[2];
  }
  const int64_t level_entry0 = ((int64_t)n * levels + l) * p;
  const int col0 = tx * kTile, row0 = ty * kTile;

  // [kDestStages][kBatch][fs] f1 rows, [..][kBatch][dst] ds rows,
  // [..][kBatch] bases, [..][kBatch] entries, [..] counts; general: the
  // runs' starts [reach] and first positions [reach + 1]
  T* sf1 = reinterpret_cast<T*>(smem);
  float* sds = reinterpret_cast<float*>(smem + kDestStages * kBatch * fs * sizeof(T));
  int* sbase = reinterpret_cast<int*>(sds + kDestStages * kBatch * dst);
  int* sentry = sbase + kDestStages * kBatch;
  int* scount = sentry + kDestStages * kBatch;
  int* srun = scount + kDestStages;
  int* spos = srun + geo.reach + 1;
  if (kGeneral) {
    // the reach key rows' runs, each reach key tiles; their first positions
    // in the tile's list by a scan in row order (thread 0)
    const int reach = geo.reach;
    if (tid == 0) {
      int pos = 0;
      for (int r = 0; r < reach; ++r) {
        srun[r] = offsets[k0 + r * geo.kx[l]];
        spos[r] = pos;
        pos += offsets[k0 + r * geo.kx[l] + reach] - srun[r];
      }
      spos[reach] = pos;
    }
    __syncthreads();
    m = spos[reach];
  }
  const int begin = j * chunk_q, end = min(m, begin + chunk_q);
  const int nbatch = (end - begin + kBatch - 1) / kBatch;

  // candidate i of batch bi: its entry (key rows in order), if in the chunk
  auto candidate = [&](int bi, int i, int& e) -> bool {
    const int pos = begin + bi * kBatch + i;
    if (pos >= end) return false;
    int idx;
    if (kGeneral) {
      int r = 0;
      while (spos[r + 1] <= pos) ++r;
      idx = srun[r] + pos - spos[r];
    } else {
      idx = pos < run_len[0]                ? run_start[0] + pos
            : pos < run_len[0] + run_len[1] ? run_start[1] + pos - run_len[0]
                                            : run_start[2] + pos - run_len[0] - run_len[1];
    }
    e = (int)order[idx];
    return true;
  };
  // warp 0: keep a batch's candidates whose window reaches the tile, in order
  auto compact = [&](bool have, int e, int base, int slot) {
    const int x0 = (int)(int16_t)(base & 0xffff), y0 = base >> 16;
    const bool reach = have && x0 < col0 + kTile && x0 + span > col0 && y0 < row0 + kTile &&
                       y0 + span > row0;
    const unsigned mask = __ballot_sync(kAll, reach);
    if (reach) {
      const int k = __popc(mask & ((1u << lane) - 1u));
      sentry[slot * kBatch + k] = e;
      sbase[slot * kBatch + k] = base;
    }
    if (lane == 0) scount[slot] = __popc(mask);
  };
  // every warp: the staged rows of a batch's kept entries, an entry a warp
  auto issue = [&](int slot) {
    const int count = scount[slot];
    constexpr int per = 16 / (int)sizeof(T);
    for (int k = warp; k < count; k += kDestThreads / 32) {
      const int e = sentry[slot * kBatch + k];
      const T* src = f1 + ((int64_t)n * p + (e - level_entry0)) * c;
      T* to = sf1 + (slot * kBatch + k) * fs;
      for (int r = lane; r < f1_channels(c) / per; r += 32) {
        // channels past C are zeros (a copy of no source byte)
        cp_async16z(smem_addr(to + r * per), r * per < c ? src + r * per : src, r * per < c ? 16 : 0);
      }
      const float* dsrc = ds + (int64_t)e * ntaps;
      float* dto = sds + (slot * kBatch + k) * dst;
      if (kGeneral) {
        // the 8x8 block of ds on the tile: pixel (row0 + r, col0 + q) is tap
        // (row0 + r - y0, col0 + q - x0) of the window, zero off it
        const int base = sbase[slot * kBatch + k];
        const int x0 = (int)(int16_t)(base & 0xffff), y0 = base >> 16;
        for (int u = lane; u < kTile * kTile; u += 32) {
          const int dy = row0 + (u >> 3) - y0, dx = col0 + (u & 7) - x0;
          const bool in = (unsigned)dy < (unsigned)span && (unsigned)dx < (unsigned)span;
          cp_async4z(smem_addr(dto + u), in ? dsrc + dy * span + dx : dsrc, in ? 4 : 0);
        }
      } else {
        for (int r = lane; r < ntaps / 4; r += 32) cp_async16(smem_addr(dto + 4 * r), dsrc + 4 * r);
      }
    }
  };

  const int gq = lane >> 2, t4 = lane & 3;
  const int mt = warp & 3, half = warp >> 2;
  const int prow = row0 + 2 * mt, pcol = col0 + gq;  // this lane's pixels: (prow, pcol), (prow + 1, pcol)
  const int groups = f1_channels(c) / 32;  // of 4 n-tiles
  const int gr0 = half * groups / 2, ngr = (half + 1) * groups / 2 - gr0;
  constexpr int kMaxGroups = kMaxC / 32 / 2;
  float acc[kMaxGroups][4][4];  // [group][n-tile][D element]
#pragma unroll
  for (int j = 0; j < kMaxGroups; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r][0] = acc[j][r][1] = acc[j][r][2] = acc[j][r][3] = 0.0f;
  }

  // warp 0's lane i holds candidate i of the next batches to keep: the
  // next one's entry and base, the one after's entry (each load a batch
  // ahead of its use)
  bool have1 = false, have2 = false;
  int e1 = 0, e2 = 0, base1 = 0;
  auto advance = [&](int next) {
    have1 = have2;
    e1 = e2;
    base1 = have1 ? bases[e1] : 0;
    have2 = candidate(next, lane, e2);
  };
  if (warp == 0) {
    have1 = candidate(0, lane, e1);
    base1 = have1 ? bases[e1] : 0;
    have2 = candidate(1, lane, e2);
  }
  // kDestStages - 1 batches in flight
#pragma unroll
  for (int i = 0; i < kDestStages - 1; ++i) {
    if (warp == 0 && i < nbatch) {
      compact(have1, e1, base1, i);
      advance(i + 2);
    }
    __syncthreads();
    if (i < nbatch) issue(i);
    cp_async_commit();
  }
  for (int bi = 0; bi < nbatch; ++bi) {
    const int slot = bi % kDestStages;
    const int ahead = bi + kDestStages - 1;  // its slot was computed last step
    if (ahead < nbatch) {
      if (warp == 0) {
        compact(have1, e1, base1, ahead % kDestStages);
        advance(ahead + 2);
      }
      __syncthreads();
      issue(ahead % kDestStages);
    }
    cp_async_commit();
    cp_async_wait<kDestStages - 1>();
    __syncthreads();
    const int count = scount[slot];
    const T* f1s = sf1 + slot * kBatch * fs;
    const float* dss = sds + slot * kBatch * dst;
    const int* bs = sbase + slot * kBatch;
    for (int kk = 0; kk < count; kk += 8) {
      // A: rows g (pixel (prow, pcol)) and g + 8 (pixel (prow + 1, pcol)),
      // columns t and t + 4 (entries kk + t4, kk + t4 + 4)
      float av[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int k = kk + t4 + 4 * u;
        float v0 = 0.0f, v1 = 0.0f;
        if (k < count && kGeneral) {
          v0 = dss[k * dst + (2 * mt) * kTile + gq];
          v1 = dss[k * dst + (2 * mt + 1) * kTile + gq];
        } else if (k < count) {
          const int base = bs[k];
          const int x0 = (int)(int16_t)(base & 0xffff), y0 = base >> 16;
          const int dx = pcol - x0, dy = prow - y0;
          if ((unsigned)dx < (unsigned)span) {
            const float* d = dss + k * dst + dx;
            if ((unsigned)dy < (unsigned)span) v0 = d[dy * span];
            if ((unsigned)(dy + 1) < (unsigned)span) v1 = d[(dy + 1) * span];
          }
        }
        av[2 * u] = v0;
        av[2 * u + 1] = v1;
      }
      uint32_t ahi[4], alo[4];
      // a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4)
      split_tf32(av[0], ahi[0], alo[0]);
      split_tf32(av[1], ahi[1], alo[1]);
      split_tf32(av[2], ahi[2], alo[2]);
      split_tf32(av[3], ahi[3], alo[3]);
      const bool ka = kk + t4 < count, kb = kk + t4 + 4 < count;
      const T* ra = f1s + (kk + t4) * fs + 32 * gr0 + 4 * gq;
      const T* rb = ra + 4 * fs;
#pragma unroll
      for (int jg = 0; jg < kMaxGroups; ++jg) {
        if (jg < ngr) {
          // B of the group's n-tile r: (k = t, n = g) and (k = t + 4, n =
          // g) are entries kk + t4, kk + t4 + 4 at channel 32 j + 4 g + r;
          // zero past the batch (stale rows)
          const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
          const float4 b0 = ka ? load4(ra + 32 * jg) : zero;
          const float4 b1 = kb ? load4(rb + 32 * jg) : zero;
          Feat<T>::product(acc[jg][0], ahi, alo, b0.x, b1.x);
          Feat<T>::product(acc[jg][1], ahi, alo, b0.y, b1.y);
          Feat<T>::product(acc[jg][2], ahi, alo, b0.z, b1.z);
          Feat<T>::product(acc[jg][3], ahi, alo, b0.w, b1.w);
        }
      }
    }
    __syncthreads();  // the slot is a later batch's
  }

  // D of n-tile r: (g, 2t) at pixel (prow, pcol), channel 32 j + 8 t + r;
  // (g, 2t + 1) at channel 32 j + 8 t + 4 + r; (g + 8, ...) at (prow + 1,
  // pcol): 8 consecutive channels a pixel
#pragma unroll
  for (int jg = 0; jg < kMaxGroups; ++jg) {
    const int ch = 32 * (gr0 + jg) + 8 * t4;
    if (jg < ngr && ch < c) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int row = prow + u;
        const float v[8] = {acc[jg][0][2 * u], acc[jg][1][2 * u], acc[jg][2][2 * u],
                            acc[jg][3][2 * u], acc[jg][0][2 * u + 1], acc[jg][1][2 * u + 1],
                            acc[jg][2][2 * u + 1], acc[jg][3][2 * u + 1]};
        if (nchunks == 1) {
          if (row < hl && pcol < wl) store8(out.f2[l] + (((int64_t)n * hl + row) * wl + pcol) * c + ch, v);
        } else {
          store8(partial + ((int64_t)chunk * kTile * kTile + (2 * mt + u) * kTile + gq) * c + ch, v);
        }
      }
    }
  }
}

// Tiles of several chunks: their partials added in chunk order, written in
// the features' dtype. A block a (tile, tile row).
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
windowed_corr_bwd_chunk_sum_kernel(const int* __restrict__ chunk_start, Geometry geo,
                                   const float* __restrict__ partial, LevelGrads<T> out, int c,
                                   int levels) {
  const int tile = blockIdx.x, r = blockIdx.y;
  const int first = chunk_start[tile], nchunks = chunk_start[tile + 1] - first;
  if (nchunks <= 1) return;
  int n, l, ty, tx;
  tile_coords(geo, levels, tile, n, l, ty, tx);
  const int hl = geo.h[l], wl = geo.w[l];
  const int row = ty * kTile + r;
  if (row >= hl) return;
  const int c4 = c >> 2;
  for (int e = threadIdx.x; e < kTile * c4; e += kSumThreads) {
    const int i = e / c4, k = e - i * c4;
    const int col = tx * kTile + i;
    if (col >= wl) continue;
    const float4* src = reinterpret_cast<const float4*>(partial) +
                        ((int64_t)first * kTile * kTile + r * kTile + i) * c4 + k;
    const int64_t step = (int64_t)kTile * kTile * c4;  // one chunk
    float4 v = src[0];
    for (int u = 1; u < nchunks; ++u) {
      const float4 x = src[u * step];
      v.x += x.x;
      v.y += x.y;
      v.z += x.z;
      v.w += x.w;
    }
    store4(out.f2[l] + (((int64_t)n * hl + row) * wl + col) * c + 4 * k, v);
  }
}

// Above 48 KB a block's dynamic shared memory must be allowed; the carveout
// asks for all of the SM's 228 KB as shared memory. Set once a kernel.
template <typename K>
cudaError_t allow_smem(K* kernel, int bytes, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  }
  configured = err == cudaSuccess;
  return err;
}

template <typename T, bool kGeneral>
cudaError_t configure() {
  static bool query = false, dest = false;
  cudaError_t err = allow_smem(windowed_corr_bwd_query_kernel<T, kGeneral>,
                               query_smem_bytes<T>(kMaxC), query);
  if (err == cudaSuccess && !kGeneral) {
    err = allow_smem(windowed_corr_bwd_dest_kernel<T, false>,
                     dest_smem_bytes<T>(kMaxC, kMaxSpan * kMaxSpan), dest);
  }
  return err;
}

// The general destination side's shared memory grows with the reach: its
// limit is raised to what a launch asks, once for each larger ask.
template <typename T>
cudaError_t allow_general_dest_smem(int bytes) {
  static int allowed = 0;
  if (bytes <= allowed) return cudaSuccess;
  bool configured = false;
  const cudaError_t err = allow_smem(windowed_corr_bwd_dest_kernel<T, true>, bytes, configured);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

// The arguments a launch of either side refuses: the fast case takes 1-4
// levels and a radius of 0-4, the general case 1-4 levels (a group) and any
// radius whose span fits a window base's 16 bits.
bool bad_args(int64_t entries, int n, int c, int levels, int radius, const int* hs, const int* ws,
              bool general) {
  if (entries >= ((int64_t)1 << 31) || n < 0 || c < 8 || c > kMaxC || c % 8 || levels < 1 ||
      levels > kMaxLevels || radius < 0 || (general ? 2 * (int64_t)radius + 2 > 32000 : radius > kMaxRadius)) {
    return true;
  }
  for (int l = 0; l < levels; ++l) {
    if (hs[l] < 0 || ws[l] < 0 || hs[l] > 32000 || ws[l] > 32000) return true;
  }
  return false;
}

template <typename T>
void launch_level_sum(const float* d_f1_part, const float* d_coords_part, void* d_f1,
                      float* d_coords, int64_t nq, int c, int levels, cudaStream_t s) {
  const int64_t nf4 = nq * c / 4;
  const int64_t nc = d_coords != nullptr ? 2 * nq : 0;
  const int64_t most = nf4 > nc ? nf4 : nc;
  windowed_corr_bwd_level_sum_kernel<T><<<(int)((most + kSumThreads - 1) / kSumThreads),
                                          kSumThreads, 0, s>>>(
      d_f1_part, d_coords_part, static_cast<T*>(d_f1), d_coords, nf4, nc, levels);
}

template <typename T, bool kGeneral>
void launch_query(const void* f1, const void* const* f2, const float* coords, const void* g,
                  void* d_f1, float* d_coords, float* d_f1_part, float* d_coords_part, float* ds,
                  int* keys, int* bases, const Geometry& geo, int n, int h, int w, int c,
                  int levels, int radius, int split, int level0, int out_levels, cudaStream_t s) {
  Levels<T> lv = {};
  for (int l = 0; l < levels; ++l) lv.f2[l] = static_cast<const T*>(f2[l]);
  const int64_t tiles = (int64_t)n * h * ((w + kTileQ - 1) / kTileQ);
  windowed_corr_bwd_query_kernel<T, kGeneral><<<(int)(split ? tiles * levels : tiles), kThreads,
                                                query_smem_bytes<T>(c), s>>>(
      static_cast<const T*>(f1), lv, geo, coords, static_cast<const T*>(g), static_cast<T*>(d_f1),
      split ? nullptr : d_coords, d_f1_part, split && d_coords ? d_coords_part : nullptr, ds, keys,
      bases, h, w, c, levels, radius, split, level0, out_levels);
  if (split && !kGeneral) {
    launch_level_sum<T>(d_f1_part, d_coords_part, d_f1, d_coords, (int64_t)n * h * w, c, levels, s);
  }
}

template <typename T, bool kGeneral>
cudaError_t launch_dest(const void* f1, const float* ds, const int64_t* order, const int* bases,
                        const int* offsets, int* chunk_start, float* partial,
                        void* const* d_f2, const Geometry& geo, int n, int p, int c, int levels,
                        int radius, int chunk_q, int tiles, int64_t max_chunks, cudaStream_t s) {
  LevelGrads<T> out = {};
  for (int l = 0; l < levels; ++l) out.f2[l] = static_cast<T*>(d_f2[l]);
  const int ntaps = (2 * radius + 2) * (2 * radius + 2);
  const int smem = kGeneral ? dest_general_smem_bytes<T>(c, geo.reach) : dest_smem_bytes<T>(c, ntaps);
  if (kGeneral) {
    const cudaError_t err = allow_general_dest_smem<T>(smem);
    if (err != cudaSuccess) return err;
  }
  windowed_corr_bwd_plan_kernel<kGeneral><<<1, kPlanThreads, 0, s>>>(offsets, geo, levels, tiles,
                                                                     chunk_q, chunk_start);
  windowed_corr_bwd_dest_kernel<T, kGeneral><<<(int)max_chunks, kDestThreads, smem, s>>>(
      static_cast<const T*>(f1), ds, order, bases, offsets, chunk_start, geo, partial, out, p, c,
      levels, radius, chunk_q, tiles);
  windowed_corr_bwd_chunk_sum_kernel<T><<<dim3(tiles, kTile), kSumThreads, 0, s>>>(
      chunk_start, geo, partial, out, c, levels);
  return cudaSuccess;
}

template <bool kGeneral>
int query_side(const void* f1, const void* f2_0, const void* f2_1, const void* f2_2,
               const void* f2_3, const float* coords, const void* g, void* d_f1, float* d_coords,
               float* d_f1_part, float* d_coords_part, float* ds, int* keys, int* bases, int n,
               int h, int w, int c, int levels, int radius, int is_bf16, int split, int level0,
               int out_levels, int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
               void* stream) {
  const int hs[kMaxLevels] = {h0, h1, h2, h3}, ws[kMaxLevels] = {w0, w1, w2, w3};
  if (h < 0 || w < 0 || bad_args((int64_t)n * levels * h * w, n, c, levels, radius, hs, ws, kGeneral) ||
      (kGeneral && (level0 < 0 || level0 + levels > out_levels)) ||
      (split && (d_f1_part == nullptr || (d_coords != nullptr && d_coords_part == nullptr) ||
                 (int64_t)n * h * ((w + kTileQ - 1) / kTileQ) * levels >= ((int64_t)1 << 31)))) {
    return (int)cudaErrorInvalidValue;
  }
  const Geometry geo =
      make_geometry(n, levels, hs, ws, kGeneral ? general_pad(2 * radius + 2) : kKeyPad);
  const void* f2[kMaxLevels] = {f2_0, f2_1, f2_2, f2_3};
  cudaStream_t s = (cudaStream_t)stream;
  if ((int64_t)n * h * w > 0) {
    const cudaError_t err = is_bf16 ? configure<uint16_t, kGeneral>() : configure<float, kGeneral>();
    if (err != cudaSuccess) return (int)err;
    if (is_bf16) {
      launch_query<uint16_t, kGeneral>(f1, f2, coords, g, d_f1, d_coords, d_f1_part, d_coords_part,
                                       ds, keys, bases, geo, n, h, w, c, levels, radius, split,
                                       level0, out_levels, s);
    } else {
      launch_query<float, kGeneral>(f1, f2, coords, g, d_f1, d_coords, d_f1_part, d_coords_part,
                                    ds, keys, bases, geo, n, h, w, c, levels, radius, split,
                                    level0, out_levels, s);
    }
  }
  return (int)cudaGetLastError();
}

template <bool kGeneral>
int dest_side(const void* f1, const float* ds, const int* sorted_keys, const int64_t* order,
              const int* bases, int* offsets, int* chunk_start, float* partial, void* d_f2_0,
              void* d_f2_1, void* d_f2_2, void* d_f2_3, int n, int p, int c, int levels, int radius,
              int is_bf16, int chunk_q, int h0, int h1, int h2, int h3, int w0, int w1, int w2,
              int w3, void* stream) {
  const int hs[kMaxLevels] = {h0, h1, h2, h3}, ws[kMaxLevels] = {w0, w1, w2, w3};
  const int64_t entries = (int64_t)n * levels * p;
  if (p < 0 || chunk_q < 1 || bad_args(entries, n, c, levels, radius, hs, ws, kGeneral)) {
    return (int)cudaErrorInvalidValue;
  }
  const Geometry geo =
      make_geometry(n, levels, hs, ws, kGeneral ? general_pad(2 * radius + 2) : kKeyPad);
  const int64_t tiles = (int64_t)n * geo.tiles_per_image;
  // each entry is a candidate of at most reach x reach tiles
  const int64_t reach = kGeneral ? geo.reach : kReach;
  const int64_t max_chunks = tiles + (reach * reach * entries + chunk_q - 1) / chunk_q;
  if (max_chunks >= ((int64_t)1 << 31) || (int64_t)n * geo.keys_per_image >= ((int64_t)1 << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  void* d_f2[kMaxLevels] = {d_f2_0, d_f2_1, d_f2_2, d_f2_3};
  cudaStream_t s = (cudaStream_t)stream;
  if (tiles > 0) {
    cudaError_t err = is_bf16 ? configure<uint16_t, kGeneral>() : configure<float, kGeneral>();
    if (err != cudaSuccess) return (int)err;
    windowed_corr_bwd_offsets_kernel<<<(int)((entries + kOffsetThreads) / kOffsetThreads),
                                       kOffsetThreads, 0, s>>>(sorted_keys, (int)entries,
                                                               geo.sentinel, offsets);
    if (is_bf16) {
      err = launch_dest<uint16_t, kGeneral>(f1, ds, order, bases, offsets, chunk_start, partial,
                                            d_f2, geo, n, p, c, levels, radius, chunk_q,
                                            (int)tiles, max_chunks, s);
    } else {
      err = launch_dest<float, kGeneral>(f1, ds, order, bases, offsets, chunk_start, partial, d_f2,
                                         geo, n, p, c, levels, radius, chunk_q, (int)tiles,
                                         max_chunks, s);
    }
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The query side (fast case). f1 (N, P, C); f2_l (N, h_l, w_l, C) for l <
// levels (unused pointers may be null); coords (N, 2, H, W) float32 with H*W
// = P; g (N, levels*(2r+1)^2, H, W); d_f1 (N, P, C); d_coords (N, 2, H, W)
// float32, or null to skip it (and the dots); with `split`, a block a (tile,
// level) and d_f1_part (levels, N, P, C) and d_coords_part (levels, N, 2,
// P) float32 scratch, added in level order by a second kernel (else they
// may be null); ds (N, levels, P, (2r+2)^2) float32; keys and bases (N,
// levels, P) int32. f1, the levels, g and d_f1 are float32, or bf16 when
// is_bf16; all are contiguous, 16-byte aligned device pointers. C a
// multiple of 8 in [8, 256], 1 <= levels <= 4, 0 <= radius <= 4, N*levels*P
// < 2**31, level sizes <= 32000. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int windowed_corr_bwd_query(const void* f1, const void* f2_0, const void* f2_1,
                                       const void* f2_2, const void* f2_3, const float* coords,
                                       const void* g, void* d_f1, float* d_coords,
                                       float* d_f1_part, float* d_coords_part, float* ds,
                                       int* keys, int* bases, int n, int h, int w, int c,
                                       int levels, int radius, int is_bf16, int split, int h0,
                                       int h1, int h2, int h3, int w0, int w1, int w2, int w3,
                                       void* stream) {
  return query_side<false>(f1, f2_0, f2_1, f2_2, f2_3, coords, g, d_f1, d_coords, d_f1_part,
                           d_coords_part, ds, keys, bases, n, h, w, c, levels, radius, is_bf16,
                           split, 0, levels, h0, h1, h2, h3, w0, w1, w2, w3, stream);
}

// The query side of the general case, for the group of levels [level0,
// level0 + levels) (1 <= levels <= 4, their maps f2_0 ..) of a lookup of
// out_levels levels, any radius with 2r + 2 <= 32000: g (N,
// out_levels*(2r+1)^2, H, W); a block a (tile, level); d_f1_part
// (out_levels, N, P, C) and d_coords_part (out_levels, N, 2, P) float32
// (null: no d_coords, no dots), this group's levels' parts written;
// ds (N, levels, P, (2r+2)^2) float32, keys and bases (N, levels, P) int32
// of the group. `windowed_corr_bwd_level_sum` adds the parts once every
// group's are in. The rest as the fast case's.
extern "C" int windowed_corr_bwd_query_general(const void* f1, const void* f2_0, const void* f2_1,
                                               const void* f2_2, const void* f2_3,
                                               const float* coords, const void* g,
                                               float* d_f1_part, float* d_coords_part, float* ds,
                                               int* keys, int* bases, int n, int h, int w, int c,
                                               int levels, int radius, int is_bf16, int level0,
                                               int out_levels, int h0, int h1, int h2, int h3,
                                               int w0, int w1, int w2, int w3, void* stream) {
  return query_side<true>(f1, f2_0, f2_1, f2_2, f2_3, coords, g, nullptr, d_coords_part, d_f1_part,
                          d_coords_part, ds, keys, bases, n, h, w, c, levels, radius, is_bf16, 1,
                          level0, out_levels, h0, h1, h2, h3, w0, w1, w2, w3, stream);
}

// d_f1 (N*P, C) in the features' dtype and d_coords (N, 2, P) float32 (null:
// none) as the sums of `levels` float32 parts (levels, N*P, C) and (levels,
// N, 2, P), added in level order. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int windowed_corr_bwd_level_sum(const float* d_f1_part, const float* d_coords_part,
                                           void* d_f1, float* d_coords, int64_t nq, int c,
                                           int levels, int is_bf16, void* stream) {
  if (nq < 0 || c < 8 || c % 8 || levels < 1 || (d_coords != nullptr && d_coords_part == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (nq > 0) {
    if (is_bf16) {
      launch_level_sum<uint16_t>(d_f1_part, d_coords_part, d_f1, d_coords, nq, c, levels,
                                 (cudaStream_t)stream);
    } else {
      launch_level_sum<float>(d_f1_part, d_coords_part, d_f1, d_coords, nq, c, levels,
                              (cudaStream_t)stream);
    }
  }
  return (int)cudaGetLastError();
}

// The destination side (fast case), after the wrapper's stable sort of the
// keys: sorted_keys (N*levels*P) int32 and order (its int64 entry indices);
// f1, ds and bases as the query side's; offsets (keys + 1) and chunk_start
// (tiles + 1) int32 scratch; partial float32 scratch of max_chunks x 64 x C
// (max_chunks = tiles + ceil(9 N levels P / chunk_q), which bounds the
// chunks); d_f2_l (N, h_l, w_l, C) in f1's dtype, every element written.
// Launches the offsets, plan, destination and chunk-sum kernels on `stream`;
// returns cudaGetLastError().
extern "C" int windowed_corr_bwd(const void* f1, const float* ds, const int* sorted_keys,
                                 const int64_t* order, const int* bases, int* offsets,
                                 int* chunk_start, float* partial, void* d_f2_0, void* d_f2_1,
                                 void* d_f2_2, void* d_f2_3, int n, int p, int c, int levels,
                                 int radius, int is_bf16, int chunk_q, int h0, int h1, int h2,
                                 int h3, int w0, int w1, int w2, int w3, void* stream) {
  return dest_side<false>(f1, ds, sorted_keys, order, bases, offsets, chunk_start, partial, d_f2_0,
                          d_f2_1, d_f2_2, d_f2_3, n, p, c, levels, radius, is_bf16, chunk_q, h0,
                          h1, h2, h3, w0, w1, w2, w3, stream);
}

// The destination side of the general case, for one group of levels (the
// query side's): the key geometry of the span (pad 8 ceil((2r + 1) / 8),
// reach pad / 8 + 1), max_chunks = tiles + ceil(reach^2 N levels P /
// chunk_q); the rest as the fast case's.
extern "C" int windowed_corr_bwd_general(const void* f1, const float* ds, const int* sorted_keys,
                                         const int64_t* order, const int* bases, int* offsets,
                                         int* chunk_start, float* partial, void* d_f2_0,
                                         void* d_f2_1, void* d_f2_2, void* d_f2_3, int n, int p,
                                         int c, int levels, int radius, int is_bf16, int chunk_q,
                                         int h0, int h1, int h2, int h3, int w0, int w1, int w2,
                                         int w3, void* stream) {
  return dest_side<true>(f1, ds, sorted_keys, order, bases, offsets, chunk_start, partial, d_f2_0,
                         d_f2_1, d_f2_2, d_f2_3, n, p, c, levels, radius, is_bf16, chunk_q, h0, h1,
                         h2, h3, w0, w1, w2, w3, stream);
}
