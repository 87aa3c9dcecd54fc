// Bilinear forward splat, sum core (float32), deterministic, for sm_90a.
//
// Replaces gimmvfi_tpu/ops/splat_pallas.py:splat_corners_sorted and keeps
// what makes it deterministic: the sources are sorted by destination, and
// every output element is summed in one fixed order by one thread. The TPU
// kernel walks sorted chunks and routes them onto a window with a 4-hot
// matmul; here the sort gives each destination its sources directly, so
// the sum is a gather with no atomics and one write an element.
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
//   3. `softsplat_sorted_sum_f32`: the segments kernel (each key's first
//      sorted entry by a binary search, and each entry's source index and
//      4 masked weights, in sorted order), then the gather kernel.
// Destination pixel d, with key k = image * P + d + W + 1, receives corner
// (0,0) from the sources of key k, (1,0) from k - 1, (0,1) from k - W and
// (1,1) from k - W - 1. A key also holds sources whose corner lands
// elsewhere (x0 = -1 shares its key with x0 = W - 1 a row up), but such a
// corner always lies off the frame, so its masked weight is 0.
//
// The gather: a block owns kPixels consecutive destination pixels. One
// thread a pixel reads its six segment bounds into shared memory; then the
// block walks its kPixels x C outputs as one flat range (consecutive lanes,
// consecutive channels: coalesced writes, and a warp reads the C-channel
// rows of a few sources at a time). Each output sums its four segments in
// the order (0,0), (1,0), (0,1), (1,1), each in sorted (source) order, as
// acc = acc + v * w in float32 with the rounding intrinsics, so no
// multiply-add is fused. `ops/softsplat.py: splat_sum_sorted_plain` is the
// same order in PyTorch.
//
// Geometry as csrc/softsplat.cu and splat_pallas.py:150-175, in float32: a
// non-finite position goes to (-10, -10), off the canvas; the base corner
// is clamped to [-2, size] before the integer conversion, which keeps every
// in-bounds decision. The result is bit-identical from call to call.
//
// What bounds it on the H100: the same function as csrc/softsplat.cu, so
// the same 135.7 MB at (1, 736, 1280, 17), 0.0405 ms at 3.35 TB/s. The
// call also sorts 4-byte keys with 8-byte indices and reads each source
// row once a corner.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPixels = 128;   // destination pixels a gather block owns = its threads
constexpr int kThreads = 256;  // threads a block of the keys and segments kernels

// Source pixel p's base corner (x0, y0), clamped to [-2, size], and its
// 4 corners' bilinear weights in the order (0,0), (1,0), (0,1), (1,1),
// each 0 where that corner lies off the frame.
__device__ __forceinline__ void splat_corners(const float2* __restrict__ flow, int p, int h,
                                              int w, int& x0, int& y0, float4& wgt) {
  const int j = p % w;
  const int i = (p / w) % h;
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
  splat_corners(flow, p, h, w, x0, y0, wgt);
  const int hw = h * w;
  const int p_pad = hw + 2 * (w + 1);
  // a source with no corner on the frame goes to the canvas's last key,
  // which no destination reads; any other's base corner lies in [0, P - 1)
  const bool some = x0 >= -1 && x0 < w && y0 >= -1 && y0 < h;
  keys[p] = (p / hw) * p_pad + (some ? y0 * w + x0 + w + 1 : p_pad - 1);
}

// idx in [0, total]: starts[idx], the first sorted entry whose key is >=
// idx; idx in [0, npix): the source index and masked weights of sorted
// entry idx.
__global__ void __launch_bounds__(kThreads)
splat_sorted_segments_kernel(const float2* __restrict__ flow, const int* __restrict__ keys,
                             const int64_t* __restrict__ order, int* __restrict__ starts,
                             int* __restrict__ src, float4* __restrict__ wq, int npix,
                             int total, int h, int w) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx <= total) {
    int lo = 0, hi = npix;
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (keys[mid] < idx) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    starts[idx] = lo;
  }
  if (idx < npix) {
    const int s = (int)order[idx];
    int x0, y0;
    float4 wgt;
    splat_corners(flow, s, h, w, x0, y0, wgt);
    src[idx] = s;
    wq[idx] = wgt;
  }
}

__global__ void __launch_bounds__(kPixels)
splat_sorted_gather_kernel(const float* __restrict__ vals, const int* __restrict__ starts,
                           const int* __restrict__ src, const float4* __restrict__ wq,
                           float* __restrict__ out, int npix, int h, int w, int c) {
  // bounds of the keys k - W - 1, k - W, k - W + 1, k - 1, k, k + 1
  __shared__ int s_seg[6][kPixels];

  const int t = threadIdx.x;
  const int p0 = blockIdx.x * kPixels;
  const int np = min(kPixels, npix - p0);

  if (t < np) {
    const int p = p0 + t;
    const int hw = h * w;
    const int img = p / hw;
    const int k = img * (hw + 2 * (w + 1)) + (p - img * hw) + w + 1;
    s_seg[0][t] = starts[k - w - 1];
    s_seg[1][t] = starts[k - w];
    s_seg[2][t] = starts[k - w + 1];
    s_seg[3][t] = starts[k - 1];
    s_seg[4][t] = starts[k];
    s_seg[5][t] = starts[k + 1];
  }
  __syncthreads();

  float* __restrict__ dst = out + (int64_t)p0 * c;
  const int m = np * c;  // outputs this block owns
  const int dq = kPixels / c, dr = kPixels % c;
  int q = t / c, r = t % c;  // pixel and channel of the lane's output
  for (int e = t; e < m; e += kPixels) {
    const float* __restrict__ col = vals + r;
    float acc = 0.0f;
    for (int j = s_seg[4][q]; j < s_seg[5][q]; ++j)  // (0,0): key k
      acc = __fadd_rn(acc, __fmul_rn(col[(int64_t)src[j] * c], wq[j].x));
    for (int j = s_seg[3][q]; j < s_seg[4][q]; ++j)  // (1,0): key k - 1
      acc = __fadd_rn(acc, __fmul_rn(col[(int64_t)src[j] * c], wq[j].y));
    for (int j = s_seg[1][q]; j < s_seg[2][q]; ++j)  // (0,1): key k - W
      acc = __fadd_rn(acc, __fmul_rn(col[(int64_t)src[j] * c], wq[j].z));
    for (int j = s_seg[0][q]; j < s_seg[1][q]; ++j)  // (1,1): key k - W - 1
      acc = __fadd_rn(acc, __fmul_rn(col[(int64_t)src[j] * c], wq[j].w));
    dst[e] = acc;
    q += dq;
    r += dr;
    if (r >= c) {
      r -= c;
      ++q;
    }
  }
}

// The key space N * (H * W + 2 (W + 1)) and its one-past-the-end bound
// must fit an int; a block's kPixels x C outputs are counted in an int.
bool sizes_ok(int n, int h, int w, int c) {
  const int64_t total = (int64_t)n * ((int64_t)h * w + 2 * ((int64_t)w + 1));
  return n >= 0 && h >= 0 && w >= 0 && total < ((int64_t)1 << 31) - 1 && c >= 1 &&
         c <= (1 << 22);
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
// sorted, order (N*H*W,) int64 the sort's source indices; scratch: starts
// (N*P + 1,) int32, src (N*H*W,) int32, wq (N*H*W, 4) float32; out (N, H,
// W, C) float32, every element written. Contiguous device pointers, 16-byte
// aligned. Launches the segments and the gather kernel on `stream`;
// returns cudaGetLastError().
extern "C" int softsplat_sorted_sum_f32(const float* vals, const float* flow, const int* keys,
                                        const int64_t* order, int* starts, int* src, float* wq,
                                        float* out, int n, int h, int w, int c, void* stream) {
  if (!sizes_ok(n, h, w, c)) return (int)cudaErrorInvalidValue;
  const int npix = n * h * w;
  if (npix > 0) {
    const int total = n * (h * w + 2 * (w + 1));
    cudaStream_t s = (cudaStream_t)stream;
    splat_sorted_segments_kernel<<<total / kThreads + 1, kThreads, 0, s>>>(
        reinterpret_cast<const float2*>(flow), keys, order, starts, src,
        reinterpret_cast<float4*>(wq), npix, total, h, w);
    splat_sorted_gather_kernel<<<(npix + kPixels - 1) / kPixels, kPixels, 0, s>>>(
        vals, starts, src, reinterpret_cast<const float4*>(wq), out, npix, h, w, c);
  }
  return (int)cudaGetLastError();
}
