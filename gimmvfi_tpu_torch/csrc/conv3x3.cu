// 3x3 SAME convolution, stride 1, zero padding, no bias, bf16 in and out
// with float32 accumulation, for sm_90a.
//
// Replaces tools/conv_pallas_proto.py:conv3x3_pallas (the TPU probe that
// computes a 3x3 conv as 9 shifted MXU matmuls over flattened, padded
// rows). It computes what that probe's conv3x3_xla computes, not how the
// Pallas kernel does it: the flattened padded-row layout, the wp+1 lead
// rows and the 2-row tiles with one DMA each exist for VMEM and the MXU.
//
// Here the conv is an implicit GEMM: M = output pixels, N = Cout,
// K = 9 * Cin. One block computes 128 consecutive output pixels of one
// image row times 128 output channels. It walks K as 3 input rows (dy) by
// Cin in chunks of 32; for each step it stages the input row segment with
// a one-pixel halo on each side (zeros outside the image: the SAME border)
// and the matching weights of the 3 taps (dx) in shared memory, then the
// three dx taps read the same staged row shifted by 0, 1 and 2 pixels.
// The products run on the tensor cores through nvcuda::wmma (bf16
// 16x16x16, float32 accumulator). Loads use cp.async into a two-stage
// ring, so step s+1 is in flight while step s computes. The epilogue
// rounds to bf16 (round to nearest even) and masks the ragged last tile.
//
// What bounds it on the H100: at (1,736,1280,256)x(3,3,256,256) the conv
// is 1.11 TFLOP against 0.96 GB of traffic, so the tensor cores bound it
// (1.12 ms at 989 TFLOP/s dense bf16). This simple design reaches only a
// share of that: wmma issues warp-level mma.sync, not Hopper's wgmma, and
// every fragment is read from shared memory (4 warps share each B
// fragment, 2 each A fragment). Measured on an H100 80GB HBM3 at 700 W:
// 5.95-6.07 ms, 18.5-18.9% of the bound, where cuDNN takes 1.48-1.53 ms
// on channels-last input. A wgmma kernel fed by a TMA ring is the later
// redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kBM = 128;                       // output pixels along one row
constexpr int kBN = 128;                       // output channels
constexpr int kBK = 32;                        // input channels per step
constexpr int kThreads = 256;                  // 8 warps: 4 (M) x 2 (N), 32x64 each
constexpr int kALd = 48;                       // 96 B rows: a dx shift stays 32-B aligned
constexpr int kBLd = kBN + 8;                  // 272 B rows
constexpr int kARows = kBM + 2;                // the tile plus its halo
constexpr int kAStage = kARows * kALd;         // bf16 elements
constexpr int kBStage = 3 * kBK * kBLd;        // the 3 dx taps of one dy
constexpr int kStage = kAStage + kBStage;
constexpr int kStages = 2;
constexpr size_t kSmemBytes = (size_t)kStages * kStage * sizeof(__nv_bfloat16);

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const int bytes = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stage step `s` (dy = s / chunks, input channels c0 .. c0 + 31): the input
// row segment x0 - 1 .. x0 + kBM with its halo, and w[dy][0..2][c0..][co0..].
__device__ __forceinline__ void load_step(__nv_bfloat16* stage, const __nv_bfloat16* x,
                                          const __nv_bfloat16* w, int s, int chunks, int img,
                                          int y, int x0, int co0, int h, int wd, int cin,
                                          int cout) {
  const int dy = s / chunks;
  const int c0 = (s % chunks) * kBK;
  const int iy = y + dy - 1;
  const bool row_ok = iy >= 0 && iy < h;
  __nv_bfloat16* a = stage;
  __nv_bfloat16* b = stage + kAStage;
  for (int i = threadIdx.x; i < kARows * (kBK / 8); i += kThreads) {
    const int r = i >> 2;
    const int v = (i & 3) * 8;
    const int ix = x0 - 1 + r;
    const bool ok = row_ok && ix >= 0 && ix < wd && c0 + v < cin;
    const __nv_bfloat16* src =
        ok ? x + (((size_t)img * h + iy) * wd + ix) * cin + c0 + v : x;
    cp_async16(a + r * kALd + v, src, ok);
  }
  for (int i = threadIdx.x; i < 3 * kBK * (kBN / 8); i += kThreads) {
    const int t = i / (kBK * (kBN / 8));
    const int rem = i % (kBK * (kBN / 8));
    const int k = rem / (kBN / 8);
    const int v = (rem % (kBN / 8)) * 8;
    const bool ok = c0 + k < cin && co0 + v < cout;
    const __nv_bfloat16* src =
        ok ? w + ((size_t)(dy * 3 + t) * cin + c0 + k) * cout + co0 + v : w;
    cp_async16(b + (t * kBK + k) * kBLd + v, src, ok);
  }
}

__global__ void __launch_bounds__(kThreads, 2)  // two blocks an SM: 75 KB smem each
conv3x3_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
               __nv_bfloat16* __restrict__ out, int h, int wd, int cin, int cout, int wtiles) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tile = blockIdx.x % wtiles;
  const int row = blockIdx.x / wtiles;  // img * h + y
  const int y = row % h;
  const int img = row / h;
  const int x0 = tile * kBM;
  const int co0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp & 3;   // 32 pixels each
  const int wn = warp >> 2;  // 64 channels each

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int chunks = (cin + kBK - 1) / kBK;
  const int steps = 3 * chunks;
  load_step(smem, x, w, 0, chunks, img, y, x0, co0, h, wd, cin, cout);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      load_step(smem + ((s + 1) & 1) * kStage, x, w, s + 1, chunks, img, y, x0, co0, h, wd,
                cin, cout);
    }
    cp_async_commit();
    cp_async_wait_one();  // step s has landed
    __syncthreads();
    const __nv_bfloat16* a = smem + (s & 1) * kStage;
    const __nv_bfloat16* b = a + kAStage;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // output pixel p reads halo row p + t (input column x0 - 1 + p + t)
          wmma::load_matrix_sync(fa[i], a + (wm * 32 + i * 16 + t) * kALd + kk, kALd);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::load_matrix_sync(fb[j], b + (t * kBK + kk) * kBLd + wn * 64 + j * 16, kBLd);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
    __syncthreads();  // the next step's load overwrites this stage
  }
  cp_async_wait_all();
  __syncthreads();

  // Epilogue: each warp passes its fragments through its own 16x16 float
  // scratch (the stage memory is free now) and writes 8 bf16 per lane.
  float* scratch = reinterpret_cast<float*>(smem_raw) + warp * 256;
  const int r = lane >> 1;
  const int cseg = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int px = x0 + wm * 32 + i * 16 + r;
      const int co = co0 + wn * 64 + j * 16 + cseg;
      if (px < wd && co < cout) {
        const float* v = scratch + r * 16 + cseg;
        __nv_bfloat162 packed[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) packed[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
        *reinterpret_cast<uint4*>(out + ((size_t)row * wd + px) * cout + co) =
            *reinterpret_cast<const uint4*>(packed);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// x (N, H, W, Cin), w (3, 3, Cin, Cout) HWIO, out (N, H, W, Cout): contiguous
// bf16 device pointers, 16-byte aligned; Cin and Cout multiples of 16 (the
// wrapper checks). Launches on `stream`; returns the first CUDA error.
extern "C" int conv3x3_bf16(const void* x, const void* w, void* out, int n, int h, int wd,
                            int cin, int cout, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int wtiles = (wd + kBM - 1) / kBM;
  const dim3 grid((unsigned)((int64_t)n * h * wtiles), (unsigned)((cout + kBN - 1) / kBN));
  conv3x3_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), h, wd, cin, cout, wtiles);
  return (int)cudaGetLastError();
}
