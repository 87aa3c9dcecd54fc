// 3x3 SAME convolution, stride 1, zero padding, no bias, bf16 in and out
// with float32 accumulation, for sm_90a.
//
// Replaces tools/conv_pallas_proto.py:conv3x3_pallas (the TPU probe that
// computes a 3x3 conv as 9 shifted MXU matmuls over flattened, padded
// rows). It computes what that probe's conv3x3_xla computes, not how the
// Pallas kernel does it: the flattened padded-row layout, the wp+1 lead
// rows and the 2-row tiles with one DMA each exist for VMEM and the MXU.
//
// Design: an implicit GEMM (M = output pixels, N = Cout, K = 9 * Cin) in
// the usual shape of a Hopper GEMM, with the convolution in the TMA
// coordinates.
//   - A tile is 128 consecutive output pixels of one image row by 256
//     output channels, so it never crosses a row. Its K loop walks the 9
//     taps (dy, dx) times ceil(Cin / 64) channel chunks.
//   - A comes from x through a 4-D tensor map (C, W, H, N) with a
//     (64, 128, 1, 1) box and the 128-byte swizzle: step (dy, dx, c0) loads
//     the box at (c0, x0 + dx - 1, y + dy - 1, n). TMA fills every element
//     outside the tensor with zeros, which gives the SAME border, the
//     ragged right edge, the rows above and below the image and a Cin that
//     is not a multiple of 64, with no im2col buffer and no halo code.
//   - B is the weights repacked by the wrapper to (3, 3, Cout, Cin), so it
//     is K-major like A: a 3-D tensor map (Cin, Cout, 9), box (64, 256, 1).
//     Both operands then share one wgmma descriptor form (K-major, 128-byte
//     swizzle, 1024-byte row groups), and the repack (1.2 MB at the probe
//     shape) is one copy kernel in the wrapper.
//   - A ring of 4 stages of 16 KB (A) + 32 KB (B) in shared memory, with a
//     full and an empty mbarrier each. One producer thread, in a warpgroup
//     that gives its registers up (setmaxnreg.dec 40), keeps the TMA loads
//     in flight. Two consumer warpgroups (setmaxnreg.inc 232) each run
//     wgmma.mma_async m64n256k16 on 64 pixels x 256 channels with 128 f32
//     accumulators a thread, keep one wgmma group in flight and hand each
//     stage back as soon as its products are done. No __syncthreads in the
//     main loop.
//   - A persistent grid: one block per SM walks the tiles in row-major
//     order, so the three input rows that neighbouring tiles share stay in
//     the 50 MB L2 and device memory sees about one read of x. The ring
//     runs on across tiles, so the next tile's loads overlap this one's
//     epilogue.
//   - The epilogue rounds to bf16 (round to nearest even) and passes each
//     warpgroup's 64 x 64 sub-tiles through a padded shared-memory buffer,
//     then writes 16-byte stores masked at the ragged edges.
//
// What bounds it on the H100: at (1,736,1280,256)x(3,3,256,256) the conv
// is 1.11 TFLOP against 0.96 GB of traffic, so the tensor cores bound it
// (1.12 ms at 989 TFLOP/s dense bf16). Each K step moves 48 KB from L2 to
// shared memory for 4.19 MFLOP, the ratio of a 128x256x64 GEMM tile.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 6,
// tools/conv_ablate.py): 1.42-1.46 ms of device time, 77-79% of that
// bound and level with cuDNN's channels-last conv (1.42-1.44 ms in the
// same runs); the wmma kernel this design replaced took 5.95-6.07 ms.
// With the loads taken out the kernel runs 10-12% faster, with the
// epilogue taken out 5-7%, with both at 92% of the bound. ptxas
// reports 168 registers, no spills and no serialised wgmma. PERF.md
// section 6 has the numbers.

#include <cuda.h>  // CUtensorMap and its enums; libcuda itself is reached with dlopen
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;       // output pixels of one row a tile
constexpr int kBN = 256;       // output channels a tile
constexpr int kBK = 64;        // input channels a step: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kABytes = kBM * kBK * 2;  // 16 KB
constexpr int kBBytes = kBN * kBK * 2;  // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kScLd = kBK + 8;  // epilogue rows of 144 B: conflict-free bf16x2 writes
constexpr int kScBytes = 2 * 64 * kScLd * 2;
constexpr int kBarOffset = kStages * kStageBytes + kScBytes;
constexpr size_t kSmemBytes = 1024 + kBarOffset + 2 * kStages * 8;  // + alignment slack
constexpr uint64_t kHangNs = 2000000000ull;  // a 2 s wait means a broken pipeline

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of `parity` to complete. A wait that lasts 2 s can only
// be a broken pipeline: trap (the launch fails) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = globaltimer();
  while (!mbar_try_wait(bar, parity)) {
    if (globaltimer() - t0 > kHangNs) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile written by TMA with the
// 128-byte swizzle: rows of 64 bf16 (128 B), 8-row groups 1024 B apart
// (stride byte offset), leading byte offset unused (1), layout 1 = B128.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, f32, the warpgroup's fragment) += A (64 x 16) * B (16 x 256)^T;
// d is overwritten instead when scale_d is 0. Both operands K-major.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

struct Tile {
  int row;  // img * h + y
  int y, img, x0, co0;
};

__device__ __forceinline__ Tile decode_tile(int t, int h, int wtiles, int ctiles) {
  Tile tl;
  tl.co0 = (t % ctiles) * kBN;  // channel tiles innermost: they share A in L2
  const int r = t / ctiles;
  tl.x0 = (r % wtiles) * kBM;
  tl.row = r / wtiles;
  tl.y = tl.row % h;
  tl.img = tl.row / h;
  return tl;
}

__global__ void __launch_bounds__(kThreads, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
               __nv_bfloat16* __restrict__ out, int h, int wd, int cout, int wtiles, int ctiles,
               int chunks, int ntiles) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128-byte swizzle wants 1024-byte rows
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t a_smem = base;                              // kStages x 16 KB
  const uint32_t b_smem = base + kStages * kABytes;          // kStages x 32 KB
  __nv_bfloat16* scratch = reinterpret_cast<__nv_bfloat16*>(smem + kStages * kStageBytes);
  const uint32_t full = base + kBarOffset;                   // kStages x 8 B
  const uint32_t empty = full + kStages * 8;                 // kStages x 8 B
  const int steps = 9 * chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's expect_tx, then the TMA bytes
      mbar_init(empty + 8 * s, 2);  // one arrival from each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // Producer warpgroup: one thread issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&map_x)) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&map_w)) : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const Tile tl = decode_tile(t, h, wtiles, ctiles);
        for (int s = 0; s < steps; ++s) {
          const int tap = s / chunks;
          const int c0 = (s - tap * chunks) * kBK;
          const int dy = tap / 3;
          const int dx = tap - dy * 3;
          mbar_wait(empty + 8 * stage, phase ^ 1);  // the first round passes at once
          mbar_expect_tx(full + 8 * stage, kStageBytes);
          tma_load_4d(a_smem + stage * kABytes, &map_x, full + 8 * stage, c0, tl.x0 + dx - 1,
                      tl.y + dy - 1, tl.img);
          tma_load_3d(b_smem + stage * kBBytes, &map_w, full + 8 * stage, c0, tl.co0, tap);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumer warpgroup g: pixels g*64 .. g*64+63 of each tile, all 256 channels.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int g = threadIdx.x >> 7;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    __nv_bfloat16* sc = scratch + g * 64 * kScLd;
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.0f;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const Tile tl = decode_tile(t, h, wtiles, ctiles);
      int prev = 0;
      for (int s = 0; s < steps; ++s) {
        mbar_wait(full + 8 * stage, phase);
        const uint64_t da = smem_desc(a_smem + stage * kABytes + g * (kABytes / 2));
        const uint64_t db = smem_desc(b_smem + stage * kBBytes);
        fence_acc(d);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          // 16 bf16 = 32 B further along K: 2 in the descriptor's 16-byte units
          wgmma_m64n256k16(d, da + 2 * kk, db + 2 * kk, (s | kk) != 0);
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        fence_acc(d);
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");  // step s-1 is done
        fence_acc(d);
        if (s > 0 && tid == 0) mbar_arrive(empty + 8 * prev);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(d);
      if (tid == 0) mbar_arrive(empty + 8 * prev);

      // Epilogue, 64 channels at a time. Fragment element i of this thread
      // sits at row warp*16 + lane/4 + 8*((i/2)%2), column (i/4)*8 + (lane%4)*2 + i%2.
      __nv_bfloat16* out_row = out + (size_t)tl.row * wd * cout;
#pragma unroll
      for (int j = 0; j < kBN / 64; ++j) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int i = j * 32 + q * 4;
          const int r = warp * 16 + (lane >> 2);
          const int c = q * 8 + (lane & 3) * 2;
          *reinterpret_cast<__nv_bfloat162*>(sc + r * kScLd + c) =
              __floats2bfloat162_rn(d[i], d[i + 1]);
          *reinterpret_cast<__nv_bfloat162*>(sc + (r + 8) * kScLd + c) =
              __floats2bfloat162_rn(d[i + 2], d[i + 3]);
        }
        asm volatile("bar.sync %0, 128;" ::"r"(1 + g) : "memory");
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int e = tid + v * 128;
          const int r = e >> 3;
          const int c = (e & 7) * 8;
          const int px = tl.x0 + g * 64 + r;
          const int co = tl.co0 + j * 64 + c;
          if (px < wd && co < cout) {
            *reinterpret_cast<uint4*>(out_row + (size_t)px * cout + co) =
                *reinterpret_cast<const uint4*>(sc + r * kScLd + c);
          }
        }
        asm volatile("bar.sync %0, 128;" ::"r"(1 + g) : "memory");
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime library. The
// CUDA runtime has already loaded libcuda into this process, so take the
// function from there rather than linking this library against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

constexpr int kErrNoEncodeTiled = 10000;  // returned codes >= 10000 are not cudaErrors
constexpr int kErrTooManyTiles = 10001;
constexpr int kErrEncode = 20000;         // + the CUresult of the failed encode

int encode_bf16(EncodeTiled encode, CUtensorMap* map, const void* ptr, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                              const_cast<void*>(ptr), dims, strides, box, ones,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // out of bounds reads 0
  return res == CUDA_SUCCESS ? 0 : kErrEncode + (int)res;
}

}  // namespace

// x (N, H, W, Cin), wt (3, 3, Cout, Cin): the HWIO weights with each tap
// transposed, so K (Cin) is innermost; out (N, H, W, Cout). Contiguous bf16
// device pointers, 16-byte aligned; Cin and Cout multiples of 16 (the
// wrapper checks). Launches on `stream`; returns 0, the first CUDA error,
// or a code >= 10000 (cuTensorMapEncodeTiled not found, too many tiles, or 20000 + the
// CUresult of a failed tensor-map encode).
extern "C" int conv3x3_bf16(const void* x, const void* wt, void* out, int n, int h, int wd,
                            int cin, int cout, void* stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncodeTiled;
  const int wtiles = (wd + kBM - 1) / kBM;
  const int ctiles = (cout + kBN - 1) / kBN;
  const int64_t ntiles = (int64_t)n * h * wtiles * ctiles;
  if (ntiles > INT32_MAX) return kErrTooManyTiles;

  CUtensorMap map_x, map_w;
  const cuuint64_t x_dims[4] = {(cuuint64_t)cin, (cuuint64_t)wd, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t x_strides[3] = {(cuuint64_t)cin * 2, (cuuint64_t)wd * cin * 2,
                                   (cuuint64_t)h * wd * cin * 2};
  const cuuint32_t x_box[4] = {kBK, kBM, 1, 1};
  int err = encode_bf16(encode, &map_x, x, 4, x_dims, x_strides, x_box);
  if (err) return err;
  const cuuint64_t w_dims[3] = {(cuuint64_t)cin, (cuuint64_t)cout, 9};
  const cuuint64_t w_strides[2] = {(cuuint64_t)cin * 2, (cuuint64_t)cout * cin * 2};
  const cuuint32_t w_box[3] = {kBK, kBN, 1};
  err = encode_bf16(encode, &map_w, wt, 3, w_dims, w_strides, w_box);
  if (err) return err;

  int dev = 0, sms = 0;
  cudaError_t cerr = cudaGetDevice(&dev);
  if (cerr == cudaSuccess) cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (cerr == cudaSuccess)
    cerr = cudaFuncSetAttribute(conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kSmemBytes);
  if (cerr != cudaSuccess) return (int)cerr;
  const int grid = (int)(ntiles < sms ? ntiles : sms);
  conv3x3_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      map_x, map_w, static_cast<__nv_bfloat16*>(out), h, wd, cout, wtiles, ctiles,
      (cin + kBK - 1) / kBK, (int)ntiles);
  return (int)cudaGetLastError();
}
