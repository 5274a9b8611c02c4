// int8 GEMM with a fused dequant epilogue for Hopper (sm_90a):
//   out[m, n] = float(sum_k a[m, k] * b[n, k]) * (x_scale * w_scale[n])
//               + bias[n], then leaky 0.1 if asked;
// a (M, K) int8 row-major, b (N, K) int8 row-major (both K-contiguous),
// out (M, N) float32 row-major, x_scale one float in device memory.
//
// Replaces: darknet_tpu/ops/pallas/quant_matmul.py int8_matmul and its
// _kernel (:55-113, pallas_call at :91).  The TPU kernel takes whole-K
// (256, 256) output tiles through VMEM into the MXU's int8 path with an
// int32 accumulator and the same f32 epilogue.
//
// What bounds it on this card: yolov4-608's quantized convs at b=8 are
// GEMMs with M from 2,888 to 184,832, N from 128 to 1024 and K from 128
// to 9,216 (3x3 convs as an explicit im2col); 430 GMAC a request.  At
// K >= 128 each operand byte feeds at least 128 multiply-adds per tile,
// so the int8 tensor cores (1,979 TOP/s dense) and not device memory
// bound the product; the f32 output (4 bytes per element, written once)
// is the largest traffic.
//
// Design (simple first; wgmma, TMA and fused quantize/activation are
// later work):
//  * block tile 128 x 128, K steps of 64; 8 warps as 2 (M) x 4 (N), each
//    warp 64 x 32 = 4 x 4 tiles of mma.sync.m16n8k32.s8.s8.s32 with the
//    int32 accumulators in registers;
//  * operand tiles double-buffered in shared memory through 16-byte
//    cp.async; rows padded to 80 bytes so that the 32-bit fragment loads
//    of a warp hit 32 distinct banks;
//  * ragged M, N and K are masked: out-of-range rows and K bytes load as
//    0 (adding 0 products leaves the exact sum), out-of-range outputs are
//    not written.  K % 16 != 0 or a misaligned pointer takes a byte-wise
//    load path (never on yolov4, whose K are multiples of 128);
//  * epilogue: __int2float_rn, then __fmul_rn and __fadd_rn, so nvcc
//    cannot contract it into an FMA: given the exact int32 sum the
//    result is bitwise the plain version's (ops/quant_matmul.py);
//  * every launch reports cudaGetLastError to the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int kThreads = 256;
constexpr int WM = 64, WN = 32;            // one warp's output tile
constexpr int MI = WM / 16, NI = WN / 8;   // mma tiles per warp
constexpr int LDS = BK + 16;               // shared row stride, bytes

struct __align__(16) Smem {
  int8_t a[2][BM][LDS];
  int8_t b[2][BN][LDS];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0+128) x bytes [k0, k0+64) of a (rows, K) row-major matrix
// into one shared tile; 0 outside the matrix
template <bool kVec>
__device__ __forceinline__ void load_tile(int8_t (*dst)[LDS],
                                          const int8_t* src, int rows,
                                          int K, int r0, int k0, int tid) {
  constexpr int kChunks = BK / 16;
#pragma unroll
  for (int c = tid; c < BM * kChunks; c += kThreads) {
    const int r = c / kChunks, kc = (c % kChunks) * 16;
    const int gr = r0 + r, gk = k0 + kc;
    int8_t* d = &dst[r][kc];
    if (kVec) {
      // K % 16 == 0: a chunk is wholly inside K or wholly outside
      if (gr < rows && gk < K)
        cp_async16(d, src + (size_t)gr * K + gk);
      else
        *reinterpret_cast<int4*>(d) = make_int4(0, 0, 0, 0);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        d[j] = (gr < rows && gk + j < K) ? src[(size_t)gr * K + gk + j]
                                         : int8_t(0);
    }
  }
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    int8_gemm_kernel(const int8_t* __restrict__ a,
                     const int8_t* __restrict__ b,
                     const float* __restrict__ w_scale,
                     const float* __restrict__ bias,
                     const float* __restrict__ x_scale,
                     float* __restrict__ out, int M, int N, int K,
                     int leaky) {
  __shared__ Smem s;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;     // mma fragment coordinates
  const int wm = (warp >> 2) * WM, wn = (warp & 3) * WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (K + BK - 1) / BK;
  load_tile<kVec>(s.a[0], a, M, K, m0, 0, tid);
  load_tile<kVec>(s.b[0], b, N, K, n0, 0, tid);
  cp_async_commit();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_tile<kVec>(s.a[cur ^ 1], a, M, K, m0, (kt + 1) * BK, tid);
      load_tile<kVec>(s.b[cur ^ 1], b, N, K, n0, (kt + 1) * BK, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      // A (16 x 32, row): rows g and g+8, bytes 4t..4t+3 and 16+4t..
      // B (32 x 8, col): column g, bytes 4t..4t+3 and 16+4t..
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int8_t* p = &s.a[cur][wm + i * 16 + g][kk + t * 4];
        af[i][0] = ld32(p);
        af[i][1] = ld32(p + 8 * LDS);
        af[i][2] = ld32(p + 16);
        af[i][3] = ld32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int8_t* q = &s.b[cur][wn + j * 8 + g][kk + t * 4];
        bf[j][0] = ld32(q);
        bf[j][1] = ld32(q + 16);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

  // C (16 x 8): element e of a tile is row g + 8 * (e / 2), column
  // 2t + e % 2
  const float xs = *x_scale;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm + i * 16 + g + 8 * (e >> 1);
        const int n = n0 + wn + j * 8 + 2 * t + (e & 1);
        if (r < M && n < N) {
          float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][e]),
                                        __fmul_rn(xs, w_scale[n])),
                              bias[n]);
          if (leaky && !(y > 0.f)) y = __fmul_rn(0.1f, y);
          out[(size_t)r * N + n] = y;
        }
      }
}

}  // namespace

// Returns the cudaError_t of the launch.
extern "C" int int8_gemm_launch(const void* a, const void* b,
                                const float* w_scale, const float* bias,
                                const float* x_scale, float* out, int M,
                                int N, int K, int leaky, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const bool vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0
                   && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const int8_t* pa = static_cast<const int8_t*>(a);
  const int8_t* pb = static_cast<const int8_t*>(b);
  if (vec)
    int8_gemm_kernel<true><<<grid, kThreads, 0, st>>>(
        pa, pb, w_scale, bias, x_scale, out, M, N, K, leaky);
  else
    int8_gemm_kernel<false><<<grid, kThreads, 0, st>>>(
        pa, pb, w_scale, bias, x_scale, out, M, N, K, leaky);
  return (int)cudaGetLastError();
}

extern "C" const char* int8_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
