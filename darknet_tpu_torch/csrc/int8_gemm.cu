// int8 GEMM and implicit-GEMM int8 convolution with a fused dequant
// epilogue, for Hopper (sm_90a):
//   out[m, n] = float(sum_k a[m, k] * w[n, k]) * (x_scale * w_scale[n])
//               + bias[n], written as f32 or bf16, then leaky 0.1 if asked;
// w (N, K) int8 row-major (K-contiguous), x_scale one float in device
// memory.  A is either an (M, K) int8 row-major matrix (int8_gemm_launch,
// and a 1x1 stride-1 conv, whose A is the (M, C) view of the NHWC input)
// or the implicit im2col of an NHWC int8 input (int8_conv_launch):
//   a[(b, oy, ox), (ky, kx, c)] = x[b, oy*sy + ky - pt, ox*sx + kx - pl, c]
// and 0 outside the image, K ordered (kh, kw, c) as the stored weights.
//
// Replaces: darknet_tpu/ops/pallas/quant_matmul.py int8_matmul and its
// _kernel (:55-113, pallas_call at :91), whose (256, 256) whole-K tiles run
// the MXU's int8 path with an int32 accumulator and the same f32 epilogue;
// the JAX conv path feeds it (or XLA's int8 conv) an im2col.
//
// What bounds it on this card: yolov4-608's 91 quantized convs at b=8 do
// 429 GMAC (0.43 ms at the 1,979 TOP/s int8 tensor-core peak) and, read in
// place, move 0.46 GB of NHWC int8 input, 0.06 GB of weights and 0.78 GB
// of bf16 output (0.39 ms at 3.35 TB/s): the tensor cores bound it.
//
// Design:
//  * warp specialisation, 384 threads: warpgroups 0 and 1 consume (64 rows
//    each of a 128 x BN block tile, BN = 128 or 256 chosen per shape),
//    warpgroup 2 produces; setmaxnreg moves the producer's registers to
//    the consumers;
//  * persistent: one block per SM walks the tiles (n fastest, so blocks in
//    flight share A rows through L2); the producer runs on into the next
//    tile while the consumers write the last one out;
//  * K steps of 128 bytes through a ring of as many stages as fit beside
//    the staging rows (4 to 6), with full/empty mbarriers; both operands
//    K-major with the 128-byte swizzle, which int8 wgmma needs;
//  * consumers: 4 x wgmma.mma_async m64nBNk32 s32.s8.s8 per K step, one
//    step kept in flight, a stage released when its step retires;
//  * producer: one thread issues every load.  The weights (N, K) come by
//    2-D TMA (cp.async.bulk.tensor; rows and K bytes outside zero-filled).
//    A comes by 2-D TMA when it is a matrix, else by TMA's im2col mode:
//    a K step is one (tap, 128-channel block) of the NHWC input, K
//    ordered (kh, kw, c) as the weights; the box is 128 output pixels,
//    traversed from the first pixel's window corner inside a bounding
//    box that yields darknet's output size, read at the tap's offset,
//    zeros outside the image.  No im2col tensor exists;
//  * epilogue: __int2float_rn, then __fmul_rn(acc, __fmul_rn(xs, ws[n]))
//    and __fadd_rn(., bias[n]), which nvcc cannot contract into an FMA, so
//    that, given the exact int32 sum, the f32 result is bitwise the plain
//    version's (ops/quant_matmul.py); bf16 out is __float2bfloat16_rn of
//    it, bitwise torch's .to(torch.bfloat16); leaky after the cast.  64
//    columns at a time go through each warpgroup's staging rows in shared
//    memory and out as full 16-byte row chunks;
//  * host: TMA descriptors (cuTensorMapEncodeTiled / Im2col, reached
//    through cudaGetDriverEntryPoint) are cached per weight, passed as
//    __grid_constant__; every launch reports cudaGetLastError.
//
// Measured (PERF.md): at large K the main loop runs at 76-81% of the
// int8 peak; yolov4's shapes are small (19x19 maps fill 23-92 tiles of
// 132 SMs, 1x1 convs have 1-16 K steps), so per-tile load latency and the
// epilogue, which the two consumer warpgroups do together, are not
// hidden: a ping-pong schedule or smaller tiles for small shapes is the
// next lever.
//
// The caller (ops/quant_matmul.py) guarantees K % 16 == 0 (C % 128 == 0
// for a conv) and 16-byte aligned operands: it zero-pads K or C (exact)
// and copies a misaligned operand before it launches.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <unordered_map>

namespace {

constexpr int BM = 128;          // block rows (two consumer warpgroups)
constexpr int BK = 128;          // K bytes per step
constexpr int kThreads = 384;
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;   // 2 * 128 * 224 + 128 * 56 = 384 * 168

constexpr int kEpiCols = 64;     // output columns staged at a time

// staging row stride in 32-bit words: kEpiCols outputs plus 8 words (f32)
// or 4 words (bf16), so that a warp's epilogue stores hit distinct banks
template <typename OutT>
__host__ __device__ constexpr int staging_words() {
  return kEpiCols * (int)sizeof(OutT) / 4 + (sizeof(OutT) == 4 ? 8 : 4);
}

template <int BN, typename OutT>
struct Cfg {
  static constexpr int kABytes = BM * BK;
  static constexpr int kBBytes = BN * BK;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSW = staging_words<OutT>();
  static constexpr int kStagingBytes = 2 * 64 * kSW * 4;
  // as many stages as fit in 227 KB beside the staging rows, the
  // barriers and the 1024-byte alignment slack
  static constexpr int kStages =
      (232448 - 1024 - 128 - kStagingBytes) / kStageBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kSmem = 1024 + kRingBytes + kStagingBytes + 16 * kStages;
  static_assert(kStages >= 3 && kSmem <= 232448, "fits in shared memory");
};

// how the producer fills the A tile
enum AMode : int {
  kMatrix = 0,   // 2-D TMA of an (M, K) matrix
  kIm2col = 1,   // TMA im2col of the NHWC input (C % 128 == 0)
};

struct Params {
  const float* w_scale;
  const float* bias;
  const float* x_scale;
  void* out;
  int M, N, K;
  int KW, sy, sx, pt, pl, OH, OW;    // im2col geometry
  int cblocks;                        // C / 128
  int leaky;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// 128 output pixels x 128 channels of the implicit im2col: the window
// corner (w, h) of the first pixel in image n, channels from c, at filter
// tap (kx, ky); pixels outside the image read as zeros
__device__ __forceinline__ void tma_load_im2col(uint32_t dst,
                                                const CUtensorMap* map,
                                                uint32_t bar, int c, int w,
                                                int h, int n, uint16_t kx,
                                                uint16_t ky) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier"
      "::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c),
      "r"(w), "r"(h), "r"(n), "h"(kx), "h"(ky)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator accesses across a wgmma wait
__device__ __forceinline__ void fence_reg(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); the
// leading offset is unused for this layout
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D (64 x 128, s32) += A (64 x 32, s8, K-major) . B (128 x 32, s8, K-major)^T
__device__ __forceinline__ void wgmma_n128(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 256, s32) += A (64 x 32, s8, K-major) . B (256 x 32, s8, K-major)^T
__device__ __forceinline__ void wgmma_n256(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(int* d, uint64_t da, uint64_t db) {
  if constexpr (BN == 256)
    wgmma_n256(d, da, db);
  else
    wgmma_n128(d, da, db);
}

__device__ __forceinline__ float leaky01(float y) {
  return y > 0.f ? y : __fmul_rn(0.1f, y);
}

template <typename OutT>
__device__ __forceinline__ uint32_t pack2(float y0, float y1, int leaky);

// two bf16 in one word: round each f32 once, then leaky on the bf16 value
// (the cast comes first in the reference's order)
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float y0, float y1,
                                                         int leaky) {
  __nv_bfloat16 b0 = __float2bfloat16_rn(y0), b1 = __float2bfloat16_rn(y1);
  if (leaky) {
    b0 = __float2bfloat16_rn(leaky01(__bfloat162float(b0)));
    b1 = __float2bfloat16_rn(leaky01(__bfloat162float(b1)));
  }
  return (uint32_t)__bfloat16_as_ushort(b0) |
         ((uint32_t)__bfloat16_as_ushort(b1) << 16);
}

template <int BN, int kMode, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap tmap_a,
                     const __grid_constant__ CUtensorMap tmap_b,
                     const Params p) {
  using C = Cfg<BN, OutT>;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned ring (the 128-byte swizzle repeats every 8 rows),
  // then the epilogue's staging rows, then the barriers
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* ring = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t ring_s = smem_u32(ring);
  uint32_t* staging = reinterpret_cast<uint32_t*>(ring + C::kRingBytes);
  const uint32_t full0 = ring_s + C::kRingBytes + C::kStagingBytes;
  const uint32_t empty0 = full0 + 8 * S;
  auto a_tile = [&](int s) { return ring_s + s * C::kStageBytes; };
  auto b_tile = [&](int s) { return ring_s + s * C::kStageBytes + C::kABytes; };

  // persistent: block b takes tiles b, b + gridDim.x, ...; n runs fastest,
  // so the blocks in flight share A rows through L2
  const int tiles_n = (p.N + BN - 1) / BN;
  const int tiles = ((p.M + BM - 1) / BM) * tiles_n;
  const int nk = (p.K + BK - 1) / BK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);               // the producer's tx arrive
      mbar_init(empty0 + 8 * s, 8);              // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    int g = 0;                                   // K steps issued so far
    if (threadIdx.x == 256) {
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
        // im2col: the first pixel's image and window corner
        int img = 0, w0 = 0, h0 = 0;
        if constexpr (kMode == kIm2col) {
          const int ohw = p.OH * p.OW;
          img = m0 / ohw;
          const int rem = m0 - img * ohw, oy = rem / p.OW;
          w0 = (rem - oy * p.OW) * p.sx - p.pl;
          h0 = oy * p.sy - p.pt;
        }
        for (int i = 0; i < nk; ++i, ++g) {
          const int s = g % S;
          mbar_wait(empty0 + 8 * s, ((g / S) & 1) ^ 1);
          mbar_arrive_tx(full0 + 8 * s, C::kStageBytes);
          if constexpr (kMode == kIm2col) {
            // K step i is (tap, 128-channel block), K ordered (kh, kw, c)
            const int tap = i / p.cblocks, cb = i - tap * p.cblocks;
            const int ky = tap / p.KW, kx = tap - ky * p.KW;
            tma_load_im2col(a_tile(s), &tmap_a, full0 + 8 * s, cb * BK, w0,
                            h0, img, (uint16_t)kx, (uint16_t)ky);
          } else {
            tma_load_2d(a_tile(s), &tmap_a, full0 + 8 * s, i * BK, m0);
          }
          tma_load_2d(b_tile(s), &tmap_b, full0 + 8 * s, i * BK, n0);
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int lane = threadIdx.x & 31;
    const int rw = ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);  // frag row
    uint32_t* stage = staging + wg * 64 * C::kSW;
    OutT* out = static_cast<OutT*>(p.out);
    constexpr int kPer = 16 / (int)sizeof(OutT);      // outputs a chunk
    constexpr int kChunks = kEpiCols / kPer;          // chunks a staged row
    const bool vec = (p.N % kPer) == 0;
    const float xs = *p.x_scale;
    int g = 0;                                   // K steps consumed so far
    int acc[BN / 2];

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[e] = 0;
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) fence_reg(acc[e]);

      for (int i = 0; i < nk; ++i, ++g) {
        const int s = g % S;
        mbar_wait(full0 + 8 * s, (g / S) & 1);
        const uint64_t da = desc_sw128(a_tile(s) + wg * 64 * BK);
        const uint64_t db = desc_sw128(b_tile(s));
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 32; ++k)   // +32 bytes: +2 in 16-byte units
          wgmma_tile<BN>(acc, da + 2 * k, db + 2 * k);
        wgmma_commit();
        // one step stays in flight; the one before it has retired
        if (i > 0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty0 + 8 * ((g - 1) % S));
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty0 + 8 * ((g - 1) % S));
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) fence_reg(acc[e]);

      // epilogue, kEpiCols columns at a time through this warpgroup's
      // staging rows; the producer meanwhile fills the ring for the next
      // tile
#pragma unroll
      for (int ec = 0; ec < BN / kEpiCols; ++ec) {
        // this chunk's scales and biases first, all loads in flight at
        // once (a load after a staging store would wait for it)
        float sc[kEpiCols / 4], bi[kEpiCols / 4];
#pragma unroll
        for (int q = 0; q < kEpiCols / 4; ++q) {
          const int n = n0 + ec * kEpiCols + (q >> 1) * 8 + 2 * (lane & 3) +
                        (q & 1);
          sc[q] = n < p.N ? __fmul_rn(xs, __ldg(p.w_scale + n)) : 0.f;
          bi[q] = n < p.N ? __ldg(p.bias + n) : 0.f;
        }
#pragma unroll
        for (int jj = 0; jj < kEpiCols / 8; ++jj) {
          const int jn = ec * (kEpiCols / 8) + jj;
          const int col = jj * 8 + 2 * (lane & 3);
          const float s0 = sc[2 * jj], s1 = sc[2 * jj + 1];
          const float b0 = bi[2 * jj], b1 = bi[2 * jj + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // accumulator element 4 jn + 2 h + e: row rw + 8 h, column
            // 8 jn + 2 (lane % 4) + e
            const float y0 = __fadd_rn(
                __fmul_rn(__int2float_rn(acc[4 * jn + 2 * h]), s0), b0);
            const float y1 = __fadd_rn(
                __fmul_rn(__int2float_rn(acc[4 * jn + 2 * h + 1]), s1), b1);
            uint32_t* row = stage + (rw + 8 * h) * C::kSW;
            if constexpr (sizeof(OutT) == 4) {
              const float2 v = p.leaky
                                   ? make_float2(leaky01(y0), leaky01(y1))
                                   : make_float2(y0, y1);
              *reinterpret_cast<float2*>(row + col) = v;
            } else {
              row[col / 2] = pack2<OutT>(y0, y1, p.leaky);
            }
          }
        }
        named_sync(2 + wg, 128);
        // 64 staged rows as 16-byte chunks, consecutive threads on
        // consecutive chunks of a row
        for (int q = threadIdx.x & 127; q < 64 * kChunks; q += 128) {
          const int r = q / kChunks, ch = q - r * kChunks;
          const int m = m0 + wg * 64 + r;
          const int n = n0 + ec * kEpiCols + ch * kPer;
          if (m >= p.M || n >= p.N) continue;
          const uint4 v =
              *reinterpret_cast<const uint4*>(stage + r * C::kSW + ch * 4);
          OutT* dst = out + (size_t)m * p.N + n;
          if (vec) {
            *reinterpret_cast<uint4*>(dst) = v;
          } else {
            const OutT* e = reinterpret_cast<const OutT*>(&v);
            for (int u = 0; u < kPer && n + u < p.N; ++u) dst[u] = e[u];
          }
        }
        named_sync(2 + wg, 128);     // the staging rows are free again
      }
    }
  }
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

typedef CUresult (*EncodeIm2colFn)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const int*, const int*,
                                   cuuint32_t, cuuint32_t, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// a CUDA API function by name, through the runtime (no -lcuda)
void* cuda_entry(const char* name) {
  void* ptr = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  const cudaError_t e = cudaGetDriverEntryPointByVersion(
      name, &ptr, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t e =
      cudaGetDriverEntryPoint(name, &ptr, cudaEnableDefault, &q);
#endif
  return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? ptr : nullptr;
}

// the implicit im2col of an NHWC int8 input, 128 output pixels x 128
// channels a box: the window corners run over [-lo, (O-1)*s - lo] along
// W and H with stride s (upper corner (O-1)*s - lo - (D-1) past the
// image edge D - 1, which keeps the darknet output size), 128-byte swizzle
int make_im2col_map(CUtensorMap* map, const void* x, int B, int H, int W,
                    int C, int sy, int sx, int pt, int pl, int OH, int OW) {
  static EncodeIm2colFn fn =
      reinterpret_cast<EncodeIm2colFn>(cuda_entry("cuTensorMapEncodeIm2col"));
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C, (cuuint64_t)W * C,
                                 (cuuint64_t)H * W * C};
  const int lower[2] = {-pl, -pt};                                  // w, h
  const int upper[2] = {(OW - 1) * sx - pl - (W - 1),
                        (OH - 1) * sy - pt - (H - 1)};
  for (int v : {lower[0], lower[1], upper[0], upper[1]})
    if (v < -128 || v > 127) return (int)cudaErrorInvalidValue;
  const cuuint32_t estr[4] = {1, (cuuint32_t)sx, (cuuint32_t)sy, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x),
                  dims, strides, lower, upper, BK, BM, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// a (rows, K) int8 row-major matrix in boxes of (box_rows, 128 bytes),
// 128-byte swizzle, zeros outside
int make_map(CUtensorMap* map, const void* ptr, int rows, int K, int box_rows) {
  static EncodeTiledFn fn =
      reinterpret_cast<EncodeTiledFn>(cuda_entry("cuTensorMapEncodeTiled"));
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
                  dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// weight descriptors, built once per (weight, shape, box) and reused
struct MapKey {
  const void* ptr;
  int rows, K, box;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && rows == o.rows && K == o.K && box == o.box;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    return std::hash<const void*>()(k.ptr) ^ ((size_t)k.rows << 1) ^
           ((size_t)k.K << 21) ^ ((size_t)k.box << 41);
  }
};

int weight_map(CUtensorMap* map, const void* ptr, int rows, int K, int box) {
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  const MapKey key{ptr, rows, K, box};
  auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return 0;
  }
  const int err = make_map(map, ptr, rows, K, box);
  if (err) return err;
  if (cache.size() > 4096) cache.clear();
  cache.emplace(key, *map);
  return 0;
}

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// BN = 256 or 128: the fewer waves of block tiles, each weighed by its
// width; a tie goes to 256 (half the A traffic through shared memory)
int pick_bn(int M, int N) {
  const int tm = (M + BM - 1) / BM, sms = num_sms();
  if (N <= 128) return 128;
  const long w256 = ((long)tm * ((N + 255) / 256) + sms - 1) / sms;
  const long w128 = ((long)tm * ((N + 127) / 128) + sms - 1) / sms;
  return w256 * 256 <= w128 * 128 ? 256 : 128;
}

template <int BN, int kMode, typename OutT>
int launch_t(const CUtensorMap& ta, const CUtensorMap& tb, const Params& p,
             cudaStream_t st) {
  constexpr int smem = Cfg<BN, OutT>::kSmem;
  auto kern = int8_gemm_kernel<BN, kMode, OutT>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const long tiles = (long)((p.M + BM - 1) / BM) * ((p.N + BN - 1) / BN);
  const int grid = (int)(tiles < num_sms() ? tiles : num_sms());
  kern<<<grid, kThreads, smem, st>>>(ta, tb, p);
  return (int)cudaGetLastError();
}

template <int kMode>
int dispatch(const CUtensorMap& ta, const void* w, const Params& p,
             int out_bf16, cudaStream_t st) {
  const int bn = pick_bn(p.M, p.N);
  CUtensorMap tb;
  const int err = weight_map(&tb, w, p.N, p.K, bn);
  if (err) return err;
  if (bn == 256)
    return out_bf16 ? launch_t<256, kMode, __nv_bfloat16>(ta, tb, p, st)
                    : launch_t<256, kMode, float>(ta, tb, p, st);
  return out_bf16 ? launch_t<128, kMode, __nv_bfloat16>(ta, tb, p, st)
                  : launch_t<128, kMode, float>(ta, tb, p, st);
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// out (M, N) = epilogue(a (M, K) . w (N, K)^T), f32 or bf16 (out_bf16).
// Returns the cudaError_t of the launch.
extern "C" int int8_gemm_launch(const void* a, const void* w,
                                const float* w_scale, const float* bias,
                                const float* x_scale, void* out, int M, int N,
                                int K, int leaky, int out_bf16, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || !aligned16(a) ||
      !aligned16(w) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.w_scale = w_scale;
  p.bias = bias;
  p.x_scale = x_scale;
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.leaky = leaky;
  CUtensorMap ta;
  const int err = make_map(&ta, a, M, K, BM);
  if (err) return err;
  return dispatch<kMatrix>(ta, w, p, out_bf16,
                           static_cast<cudaStream_t>(stream));
}

// out (B*OH*OW, N) = epilogue(implicit im2col of x (B, H, W, C) NHWC int8 .
// w (N, KH*KW*C)^T); padding (pt, pl) on the low edges, zeros beyond the
// image on every edge; C % 128 == 0.  A 1x1 stride-1 conv with no
// padding reads x as an (M, C) matrix through 2-D TMA, every other conv
// through TMA's im2col mode.
extern "C" int int8_conv_launch(const void* x, const void* w,
                                const float* w_scale, const float* bias,
                                const float* x_scale, void* out, int B, int H,
                                int W, int C, int N, int KH, int KW, int sy,
                                int sx, int pt, int pl, int OH, int OW,
                                int leaky, int out_bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || N <= 0 || KH <= 0 || KW <= 0 ||
      sy <= 0 || sx <= 0 || OH <= 0 || OW <= 0 || C % BK != 0 ||
      !aligned16(x) || !aligned16(w) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const long m = (long)B * OH * OW, k = (long)KH * KW * C;
  if (m > 0x7fffffffL || k > 0x7fffffffL || (long)B * H * W > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  if (KH == 1 && KW == 1 && sy == 1 && sx == 1 && pt == 0 && pl == 0 &&
      OH == H && OW == W)
    return int8_gemm_launch(x, w, w_scale, bias, x_scale, out, (int)m, N, C,
                            leaky, out_bf16, stream);
  Params p{};
  p.w_scale = w_scale;
  p.bias = bias;
  p.x_scale = x_scale;
  p.out = out;
  p.M = (int)m;
  p.N = N;
  p.K = (int)k;
  p.KW = KW;
  p.sy = sy;
  p.sx = sx;
  p.pt = pt;
  p.pl = pl;
  p.OH = OH;
  p.OW = OW;
  p.cblocks = C / BK;
  p.leaky = leaky;
  CUtensorMap ta;
  const int err = make_im2col_map(&ta, x, B, H, W, C, sy, sx, pt, pl, OH, OW);
  if (err) return err;
  return dispatch<kIm2col>(ta, w, p, out_bf16,
                           static_cast<cudaStream_t>(stream));
}

extern "C" const char* int8_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
