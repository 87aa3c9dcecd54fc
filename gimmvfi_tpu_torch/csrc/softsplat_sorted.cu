// Bilinear forward splat, sum core (float32), deterministic, for sm_90a.
//
// Replaces gimmvfi_tpu/ops/splat_pallas.py:136 (splat_corners_sorted, whose
// body is _splat_window_kernel at :58, launched at :242) and keeps what makes
// it deterministic: the sources are sorted by destination, and every output
// element is summed in one fixed order by one thread, with no atomic.
//
// The wrapper (`ops/softsplat.py: SortedSplatKernel`) runs three steps on
// one stream:
//   1. `softsplat_sorted_keys`: each source pixel's key, its base corner on
//      the canvas padded by one row and one column (JAX's key,
//      splat_pallas.py:177-181): image * P + y0 * W + x0 + W + 1, P = H * W
//      + 2 (W + 1); a source none of whose corners is on the frame (x0 or
//      y0 below -1 or past the last column or row) takes the image's last
//      key, P - 1, which no destination reads (JAX clips such keys into
//      [0, P) and sums their zero weights);
//   2. torch.sort(keys, stable=True): the sources by key, each key's run in
//      source order (JAX sorts with lax.sort_key_val outside its kernel too);
//   3. `softsplat_sorted_sum_f32`: one launch of the tile-staged gather.
// Destination pixel d, with key k = image * P + d + W + 1, receives corner
// (0,0) from the sources of key k, (1,0) from k - 1, (0,1) from k - W and
// (1,1) from k - W - 1, each run in sorted (source) order, summed as
// acc = acc + v * w in float32 with the rounding intrinsics, so no
// multiply-add is fused. A key also holds sources whose corner lands
// elsewhere (x0 = -1 shares its key with x0 = W - 1 a row up), but such a
// corner always lies off the frame, so its masked weight is 0.
// `ops/softsplat.py: splat_sum_sorted_plain` is the same order in PyTorch,
// and the output is bit-identical to it.
//
// The gather. A block owns a tile of kRows x kCols destinations of one
// image. They read the keys of kRows + 1 key rows, each a contiguous span of
// kCols + 1 keys, and since the entries are sorted by key, each span is one
// contiguous range of sorted entries. A warp a key row finds the range's
// first entry (a 33-ary search, four dependent loads over a million keys)
// and reads its keys 128 at a time, marking where every key's run starts.
// The block then stages the entries into shared memory: each entry's
// source index, its 4 masked weights recomputed from flow[src] (one 32-byte
// sector, as reading stored weights would be), and its C-value row of vals
// by `cp.async` (4, 8 or 16 bytes a copy, as C's alignment allows; a row is
// 68 bytes at C = 17), padded to a multiple of 4 floats, every row in flight
// at once. Then one thread a (column, 4 channels) walks down the key rows:
// key row rr's runs of key columns tx + 1, then tx, give destination row
// rr - 1 its corners (0,0), (1,0) and destination row rr its (0,1), (1,1),
// so each entry's values and weights are read once for two outputs a
// channel, 16 bytes at a time. The entries are staged in walk order: key
// rows from the last to the first, and inside a key row the runs from the
// highest key to the lowest, each run in sorted order. In that order every
// output's four runs, (0,0), (1,0), (0,1), (1,1), come one after another, so
// a tile whose ranges hold more entries than a block stages at once
// (convergent flow, collisions) walks the rest from global memory in further
// chunks of the same size, each output adding each chunk's part of its runs
// to the partial sum it left in `out`: the same order and the same bits. A
// block sums at most kSliceChannels channels; wider C is cut into channel
// slices (grid.y), which changes no sum. The tile shape, staging memory,
// block size and register cap are `tools/splat_ablate.py --sorted`'s best
// point at the main path's C = 17: 4 x 64 tiles, 408 entries a block, 320
// threads (one a (column, 4 channels)), 4 blocks an SM.
//
// Geometry as csrc/softsplat.cu and splat_pallas.py:150-175, in float32: a
// non-finite position goes to (-10, -10), off the canvas; the base corner
// is clamped to [-2, size] before the integer conversion, which keeps every
// in-bounds decision. The result is bit-identical from call to call.
//
// What bounds it on the H100: vals and flow read once and the output
// written once, 135.7 MB at (1, 736, 1280, 17): 0.0405 ms at 3.35 TB/s. The
// call also sorts 4-byte keys with 8-byte indices. Why the tile beats a
// per-corner gather (a kernel that finds every key's first sorted entry,
// writes it with each entry's index and weights, and a kernel that reads
// them back): that reads every source row from global memory once a corner
// (4 x 64 MB of 68-byte rows scattered over an array larger than L2, each
// load behind two dependent loads of a run bound and an index) and writes
// and rereads 23 MB of scratch. Here a row is read (kRows + 1) / kRows x
// (kCols + 1) / kCols times (1.27 at 4 x 64), all of a tile's rows at once,
// and the only scratch is the sorted keys and indices the sort returns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // threads a block of the keys kernel
constexpr int kRows = 4;               // destination rows a gather tile owns
constexpr int kCols = 64;              // destination columns a gather tile owns
constexpr int kGatherThreads = 320;    // threads a gather block
constexpr int kMinBlocks = 4;          // gather blocks an SM the registers must allow
constexpr int kSmemBytes = 40960;      // a gather block's staging memory (dynamic shared)
constexpr int kSliceChannels = 32;     // the most channels a gather block sums
constexpr int kRanges = kRows + 1;     // key rows a tile reads
constexpr int kSpan = kCols + 2;       // run bounds of a key row: kCols + 1 keys and the end
constexpr int kEntryBytes = 16 + 4;    // an entry's staged weights and source index
static_assert(kGatherThreads % 32 == 0, "whole warps");
static_assert(kSmemBytes >= 4 * (kEntryBytes + 4 * kSliceChannels + 12), "room for 4 entries");

// Source pixel p's base corner (x0, y0), clamped to [-2, size], and its
// 4 corners' bilinear weights in the order (0,0), (1,0), (0,1), (1,1),
// each 0 where that corner lies off the frame; f is flow[p].
__device__ __forceinline__ void corner_weights(int p, float2 f, int h, int w, int& x0, int& y0,
                                               float4& wgt) {
  const int j = p % w;
  const int i = (p / w) % h;
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
  x0 = (int)fminf(fmaxf(x0f, -2.0f), (float)w);
  y0 = (int)fminf(fmaxf(y0f, -2.0f), (float)h);
  const bool xin0 = x0 >= 0 && x0 < w, xin1 = x0 + 1 >= 0 && x0 + 1 < w;
  const bool yin0 = y0 >= 0 && y0 < h, yin1 = y0 + 1 >= 0 && y0 + 1 < h;
  wgt = make_float4(xin0 && yin0 ? __fmul_rn(wx0, wy0) : 0.0f,
                    xin1 && yin0 ? __fmul_rn(wx1, wy0) : 0.0f,
                    xin0 && yin1 ? __fmul_rn(wx0, wy1) : 0.0f,
                    xin1 && yin1 ? __fmul_rn(wx1, wy1) : 0.0f);
}

__global__ void __launch_bounds__(kThreads)
splat_sorted_keys_kernel(const float2* __restrict__ flow, int* __restrict__ keys, int npix,
                         int h, int w) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= npix) return;
  int x0, y0;
  float4 wgt;
  corner_weights(p, flow[p], h, w, x0, y0, wgt);
  const int hw = h * w;
  const int p_pad = hw + 2 * (w + 1);
  // a source with no corner on the frame goes to the canvas's last key,
  // which no destination reads; any other's base corner lies in [0, P - 1)
  const bool some = x0 >= -1 && x0 < w && y0 >= -1 && y0 < h;
  keys[p] = (p / hw) * p_pad + (some ? y0 * w + x0 + w + 1 : p_pad - 1);
}

// one V-float copy from global to shared memory, asynchronous
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  } else if constexpr (V == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

constexpr unsigned kAll = 0xffffffffu;

// acc + v * w in each of 4 channels, each product and sum rounded alone
__device__ __forceinline__ float4 add4(float4 acc, float4 v, float w) {
  return make_float4(__fadd_rn(acc.x, __fmul_rn(v.x, w)), __fadd_rn(acc.y, __fmul_rn(v.y, w)),
                     __fadd_rn(acc.z, __fmul_rn(v.z, w)), __fadd_rn(acc.w, __fmul_rn(v.w, w)));
}

// the first n (1 to 4) of 4 consecutive floats; the rest 0
__device__ __forceinline__ float4 load4(const float* src, int n) {
  return make_float4(src[0], n > 1 ? src[1] : 0.0f, n > 2 ? src[2] : 0.0f, n > 3 ? src[3] : 0.0f);
}

__device__ __forceinline__ void store4(float* dst, float4 a, int n) {
  dst[0] = a.x;
  if (n > 1) dst[1] = a.y;
  if (n > 2) dst[2] = a.z;
  if (n > 3) dst[3] = a.w;
}

// The first position in [0, n) whose key is >= target: a 33-ary search by
// the 32 lanes of a warp, four dependent loads over a million keys; every
// lane returns it.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ keys, int n, int target,
                                                int lane) {
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int p = lo + (int)((int64_t)(hi - lo) * (lane + 1) / 33);
    const unsigned ge = __ballot_sync(kAll, __ldg(keys + p) >= target);
    const int f = __ffs(ge) - 1;  // the first lane whose key is >= target, or -1
    const int below = __shfl_sync(kAll, p, f < 0 ? 31 : max(f - 1, 0));  // key < target
    const int at = __shfl_sync(kAll, p, max(f, 0));                         // key >= target
    if (f != 0) lo = below + 1;
    if (f >= 0) hi = at;
  }
  const unsigned ge =
      __ballot_sync(kAll, lo + lane >= hi || __ldg(keys + lo + lane) >= target);
  return ge ? lo + __ffs(ge) - 1 : hi;
}

// One block a tile (grid.x) and channel slices (grid.y, looping past 65535).
// Key row rr (0 .. nr - 1) is key row ya - 1 + rr, keys klo .. klo + wc with
// klo = kbase + rr W; its entries are the sorted positions [bound[rr][0],
// bound[rr][1]). The walk takes the key rows from rr = nr - 1 down to 0 and
// inside a row the runs from the highest key to the lowest, each run in
// sorted order: row rr's entries take walk positions [vend[rr] - len,
// vend[rr]), and the run of key column j (key klo + j) takes [vst[rr][j + 1],
// vst[rr][j]), vst[rr][j] = E[rr] - (the sorted position of key klo + j's
// first entry), E[rr] = vend[rr] - len + bound[rr][1].
template <int V>
__global__ void __launch_bounds__(kGatherThreads, kMinBlocks)
splat_sorted_gather_kernel(const float* __restrict__ vals, const float2* __restrict__ flow,
                           const int* __restrict__ keys, const int64_t* __restrict__ order,
                           float* __restrict__ out, int npix, int h, int w, int c, int tiles_x,
                           int tiles_y, int slice_c, int nslices, int cap) {
  extern __shared__ float4 s_stage[];  // weights [cap], source indices [cap], values [cap][cs]
  float4* __restrict__ s_w = s_stage;
  int* __restrict__ s_src = reinterpret_cast<int*>(s_w + cap);
  float* __restrict__ s_val = reinterpret_cast<float*>(s_src + cap);
  __shared__ int s_bound[kRanges][2];
  __shared__ int s_e[kRanges];
  __shared__ int s_vend[kRanges];
  __shared__ int s_noff[kRanges + 1];
  __shared__ int s_vst[kRanges][kSpan];

  const int t = threadIdx.x, lane = t & 31;
  const int tile = blockIdx.x;
  const int img = tile / (tiles_x * tiles_y);
  const int ya = (tile / tiles_x) % tiles_y * kRows;
  const int xa = (tile % tiles_x) * kCols;
  const int wc = min(kCols, w - xa);  // the tile's columns and rows (ragged at the edges)
  const int rt = min(kRows, h - ya);
  const int nr = rt + 1;
  const int span = wc + 2;
  // key row rr's first key: key row ya - 1 + rr, column xa - 1
  const int kbase = img * (h * w + 2 * (w + 1)) + ya * w + xa;

  // a warp a key row: its first entry by the warp's search, then 128
  // entries at a time (4 a lane) up to the first past the row's last key,
  // marking the sorted position where each key's run starts (`s_vst` holds
  // sorted positions until the walk offsets are known)
  for (int rr = t >> 5; rr < nr; rr += kGatherThreads / 32) {
    const int klo = kbase + rr * w;
    const int b0 = warp_lower_bound(keys, npix, klo, lane);
    int prev = -1;  // key column of the entry before these 128
    for (int g0 = b0;; g0 += 128) {
      const int gl = g0 + 4 * lane;
      int kc[4];
      bool in[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int key = gl + u < npix ? __ldg(keys + gl + u) : 0x7fffffff;
        in[u] = key <= klo + wc;
        kc[u] = in[u] ? key - klo : wc + 1;  // the first entry past the row ends every run
      }
      int kp = __shfl_up_sync(kAll, kc[3], 1);
      if (lane == 0) kp = prev;
      const unsigned past = __ballot_sync(kAll, !in[3]);
      const int first = past ? __ffs(past) - 1 : 32;  // the lane of the first entry past
      if (lane <= first) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          for (int j = kp + 1; j <= kc[u]; ++j) s_vst[rr][j] = gl + u;
          if (!in[u]) {
            s_bound[rr][0] = b0;
            s_bound[rr][1] = gl + u;
            break;
          }
          kp = kc[u];
        }
      }
      if (past) break;
      prev = __shfl_sync(kAll, kc[3], 31);
    }
  }
  __syncthreads();
  // the walk offsets: key rows from the last, and the natural offsets
  if (t == 0) {
    int v = 0;
    for (int rr = nr - 1; rr >= 0; --rr) {
      s_e[rr] = v + s_bound[rr][1];
      v += s_bound[rr][1] - s_bound[rr][0];
      s_vend[rr] = v;
    }
    s_noff[0] = 0;
    for (int rr = 0; rr < nr; ++rr) s_noff[rr + 1] = s_noff[rr] + s_bound[rr][1] - s_bound[rr][0];
  }
  __syncthreads();
  for (int i = t; i < nr * span; i += kGatherThreads) {
    const int rr = i / span;
    s_vst[rr][i - rr * span] = s_e[rr] - s_vst[rr][i - rr * span];
  }
  __syncthreads();

  const int total = s_vend[0];
  const int64_t row_pitch = (int64_t)w * c;
  for (int slice = blockIdx.y; slice < nslices; slice += gridDim.y) {
    const int c0 = slice * slice_c;
    const int cs = min(slice_c, c - c0);
    const int groups = (cs + 3) / 4, pitch = 4 * groups;  // a staged row: cs values, padded
    int v0 = 0;
    do {
      const int v1 = min(total, v0 + cap);
      const int nslot = v1 - v0;
      if (total <= cap) {
        // one chunk holds the tile: the entries in natural order, each one's
        // key and source index (coalesced), its walk position from its key's
        // run, its source index into that slot
        for (int i = t; i < total; i += kGatherThreads) {
          int rr = 0;
          while (i >= s_noff[rr + 1]) ++rr;
          const int g = s_bound[rr][0] + i - s_noff[rr];
          const int j = __ldg(keys + g) - (kbase + rr * w);
          const long long src = __ldg(reinterpret_cast<const long long*>(order) + g);
          s_src[s_vst[rr][j + 1] + g - (s_e[rr] - s_vst[rr][j])] = (int)src;
        }
      } else {
        // a chunk of a longer walk: each slot finds its entry from its walk
        // position (its key row, then its run by a search of the run bounds)
        for (int e = t; e < nslot; e += kGatherThreads) {
          const int v = v0 + e;
          int rr = nr - 1;
          while (v >= s_vend[rr]) --rr;
          int lo = 0, hi = wc;  // the first key column whose run ends at or before v
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (s_vst[rr][mid + 1] <= v) {
              hi = mid;
            } else {
              lo = mid + 1;
            }
          }
          const int g = s_e[rr] - s_vst[rr][lo] + v - s_vst[rr][lo + 1];
          s_src[e] = (int)__ldg(reinterpret_cast<const long long*>(order) + g);
        }
      }
      __syncthreads();
      // their value rows into slots of `pitch` floats, a thread a (slot, 4
      // channels), neighbouring threads on neighbouring channels, every row
      // in flight at once; meanwhile their weights, a thread a slot
      {
        const int dq = kGatherThreads / groups, dr = kGatherThreads % groups;
        int e = t / groups, g = t % groups;
        for (int i = t; i < nslot * groups; i += kGatherThreads) {
          float* dst = s_val + e * pitch + 4 * g;
          const float* src = vals + (int64_t)s_src[e] * c + c0 + 4 * g;
          if constexpr (V == 4) {
            cp_async<4>(dst, src);
          } else {
            const int n = min(4, cs - 4 * g);
#pragma unroll
            for (int k = 0; k < 4; k += V)
              if (k < n) cp_async<V>(dst + k, src + k);
          }
          e += dq;
          g += dr;
          if (g >= groups) {
            g -= groups;
            ++e;
          }
        }
      }
      for (int e = t; e < nslot; e += kGatherThreads) {
        const int p = s_src[e];
        int x0, y0;
        float4 wgt;
        corner_weights(p, flow[p], h, w, x0, y0, wgt);
        s_w[e] = wgt;
      }
      cp_async_wait_all();
      __syncthreads();
      // one thread a (column, 4 channels): down the key rows, row rr's runs
      // of key columns tx + 1, then tx, give destination row rr - 1 its
      // corners (0,0), (1,0) and destination row rr its (0,1), (1,1); each
      // output's sum takes its four runs' parts in this chunk in the order
      // (0,0), (1,0), (0,1), (1,1), after its sum over earlier chunks
      const float4* __restrict__ s_val4 = reinterpret_cast<const float4*>(s_val);
      for (int i = t; i < wc * groups; i += kGatherThreads) {
        const int tx = i / groups, g = i - tx * groups, n = min(4, cs - 4 * g);
        float* col = out + ((int64_t)(img * h + ya) * w + xa + tx) * c + c0 + 4 * g;
        if (v0 > 0) {  // a later chunk: columns none of whose runs it holds are done
          bool held = false;
          for (int rr = 0; rr <= rt; ++rr) held |= s_vst[rr][tx + 2] < v1 && s_vst[rr][tx] > v0;
          if (!held) continue;
        }
        float4 acc[kRows];  // the tile's destination rows in this column
#pragma unroll
        for (int ty = 0; ty < kRows; ++ty)
          acc[ty] = v0 == 0 || ty >= rt ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                                        : load4(col + ty * row_pitch, n);
#pragma unroll
        for (int rr = kRows; rr >= 0; --rr) {
          if (rr > rt) continue;
          const int* vr = s_vst[rr];
          const int a = max(vr[tx + 2], v0) - v0, m = max(min(vr[tx + 1], v1), v0) - v0,
                    b = min(vr[tx], v1) - v0;
#pragma unroll 2
          for (int e = a; e < m; ++e) {  // key column tx + 1
            const float4 v = s_val4[e * groups + g];
            const float4 wt = s_w[e];
            if (rr < kRows) acc[rr] = add4(acc[rr], v, wt.z);
            if (rr > 0) acc[rr - 1] = add4(acc[rr - 1], v, wt.x);
          }
#pragma unroll 2
          for (int e = m; e < b; ++e) {  // key column tx
            const float4 v = s_val4[e * groups + g];
            const float4 wt = s_w[e];
            if (rr < kRows) acc[rr] = add4(acc[rr], v, wt.w);
            if (rr > 0) acc[rr - 1] = add4(acc[rr - 1], v, wt.y);
          }
        }
#pragma unroll
        for (int ty = 0; ty < kRows; ++ty)
          if (ty < rt) store4(col + ty * row_pitch, acc[ty], n);
      }
      v0 = v1;
      __syncthreads();
    } while (v0 < total);
  }
}

// The key space N * (H * W + 2 (W + 1)) and its one-past-the-end bound
// must fit an int.
bool sizes_ok(int n, int h, int w, int c) {
  const int64_t total = (int64_t)n * ((int64_t)h * w + 2 * ((int64_t)w + 1));
  return n >= 0 && h >= 0 && w >= 0 && total < ((int64_t)1 << 31) - 1 && c >= 1 &&
         c <= (1 << 22);
}

using GatherFn = void (*)(const float*, const float2*, const int*, const int64_t*, float*, int,
                          int, int, int, int, int, int, int, int);

// How C channels are cut into slices, and what a block stages: slices of
// at most kSliceChannels (as even as possible), the copy width V that the
// slice and row alignment allow, the entries a chunk holds (each its
// weights, source index and values padded to a multiple of 4; a multiple of
// 4 entries, so the value rows start 16-byte aligned) and the dynamic
// shared memory.
struct Plan {
  int nslices, slice_c, cap, smem;
  GatherFn fn;
};

Plan plan(int c) {
  Plan p;
  p.nslices = (c + kSliceChannels - 1) / kSliceChannels;
  p.slice_c = (c + p.nslices - 1) / p.nslices;
  const int entry = kEntryBytes + 16 * ((p.slice_c + 3) / 4);  // values padded to 4
  p.cap = kSmemBytes / entry / 4 * 4;
  p.smem = p.cap * entry;
  const bool by4 = c % 4 == 0 && p.slice_c % 4 == 0, by2 = c % 2 == 0 && p.slice_c % 2 == 0;
  p.fn = by4 ? &splat_sorted_gather_kernel<4>
             : by2 ? &splat_sorted_gather_kernel<2> : &splat_sorted_gather_kernel<1>;
  return p;
}

}  // namespace

// flow (N, H, W, 2) float32 -> keys (N*H*W,) int32, contiguous device
// pointers. Launches on `stream`; returns cudaGetLastError().
extern "C" int softsplat_sorted_keys(const float* flow, int* keys, int n, int h, int w,
                                     void* stream) {
  if (!sizes_ok(n, h, w, 1)) return (int)cudaErrorInvalidValue;
  const int npix = n * h * w;
  if (npix > 0) {
    splat_sorted_keys_kernel<<<(npix + kThreads - 1) / kThreads, kThreads, 0,
                               (cudaStream_t)stream>>>(reinterpret_cast<const float2*>(flow),
                                                       keys, npix, h, w);
  }
  return (int)cudaGetLastError();
}

// vals (N, H, W, C) and flow (N, H, W, 2) float32; keys (N*H*W,) int32
// sorted, order (N*H*W,) int64 the sort's source indices; out (N, H, W, C)
// float32, every element written. Contiguous device pointers, 16-byte
// aligned. Launches the gather on `stream`; returns cudaGetLastError().
extern "C" int softsplat_sorted_sum_f32(const float* vals, const float* flow, const int* keys,
                                        const int64_t* order, float* out, int n, int h, int w,
                                        int c, void* stream) {
  if (!sizes_ok(n, h, w, c)) return (int)cudaErrorInvalidValue;
  int npix = n * h * w;
  if (npix > 0) {
    Plan p = plan(c);
    cudaError_t err =
        cudaFuncSetAttribute(p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return (int)err;
    int tiles_x = (w + kCols - 1) / kCols, tiles_y = (h + kRows - 1) / kRows;
    const dim3 grid(n * tiles_x * tiles_y, p.nslices < 65535 ? p.nslices : 65535);
    const float2* flow2 = reinterpret_cast<const float2*>(flow);
    void* args[] = {&vals, &flow2, &keys, &order, &out, &npix, &h, &w, &c, &tiles_x, &tiles_y,
                    &p.slice_c, &p.nslices, &p.cap};
    err = cudaLaunchKernel(reinterpret_cast<const void*>(p.fn), grid, dim3(kGatherThreads), args,
                           p.smem, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// The entries a gather block stages at once at C channels.
extern "C" int softsplat_sorted_capacity(int c) { return c >= 1 ? plan(c).cap : 0; }

// Gather blocks resident on an SM at C channels (the occupancy API), or -1.
extern "C" int softsplat_sorted_blocks_per_sm(int c) {
  if (c < 1) return -1;
  const Plan p = plan(c);
  int blocks = -1;
  if (cudaFuncSetAttribute(p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, p.fn, kGatherThreads, p.smem) !=
          cudaSuccess)
    return -1;
  return blocks;
}
