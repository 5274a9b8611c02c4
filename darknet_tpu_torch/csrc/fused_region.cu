// Fused conv region for Hopper (sm_90a): one launch runs a whole stride-1
// region plan (the s2d stem's 3x3 and 2x2 convs, 1x1/3x3 convs, shortcut
// adds, route concats) with every intermediate held in shared memory.
// Beside it, conv_epilogue_kernel: the bias, roundings and activation of
// a bf16 conv outside a region in one pass (its note is at the kernel);
// it lives here to share act() with the region kernels.
//
// Replaces: darknet_tpu/ops/pallas/fused_region.py build_region_call (the
// Pallas TPU kernel, pallas_call at :759), whose conv steps are MXU
// products (jnp.dot, f32 accumulation) over row slabs in pixel-pair lanes.
// Two kernels here, one table header:
//  * region_tc_kernel, bfloat16 (the serving path): every conv step is a
//    GEMM per tile on the tensor cores, mma.sync m16n8k16 bf16 -> f32;
//  * region_kernel, float32 (the parity path): f32 FFMA on the CUDA
//    cores, each thread PX pixels x NC channels.
//
// What bounds it on this card: the yolov4-608 stem prefix maps
// (B,304,304,12) to (B,304,304,64), 87,552 useful multiply-adds per output
// pixel (129.5 GFLOP at b=8: 0.131 ms at the bf16 tensor-core peak), while
// its intermediates (the first alone 24 MB per image) never leave shared
// memory: device-memory traffic is the input tile and halo, the weights
// (L2-resident) and the output tile, 0.034 ms at 3.35 TB/s.  So the
// bound is operations.  What stands between the tensor-core kernel and it,
// largest first on an H100 (PERF.md):
//  * the epilogue: one activation per output element and step (mish: an
//    expf and an IEEE division), about 0.5 G at b=8, on the CUDA cores,
//    and its shared-memory round trip;
//  * latency: one 512-thread block per SM (a 16x16 tile's slots and
//    weight ring take 172 KB), so 16 warps hide the ldmatrix -> mma chains
//    and the block-wide barriers (one per weight chunk and per add step);
//  * the halo: every block recomputes its neighbours' border (s0 runs
//    19x19 pixels, s1 and L4/L5 18x18, for a 16x16 tile), and the m16 and
//    K16 padding add more: 1.28x the useful multiply-adds at 608 px (the
//    wrapper counts them, KernelPlan.macs_per_tile);
//  * shared-memory bandwidth: each k16 a warp issues mi + nb/2 ldmatrix.x4
//    (512 B each) for mi x nb mma.
//
// Design of the tensor-core kernel:
//  * grid = (tiles_y * tiles_x, B); one block computes a T x T output tile;
//    each slot (a step's output) lives in shared memory over its own
//    extent: the tile plus exactly the halo its consumers read (derived
//    backwards from the output by the wrapper); 16x16 tiles at 512 threads
//    beat 12x12 at two 256-thread blocks per SM (less halo; measured);
//  * a slot keeps its channels zero-padded to cp, a multiple of 16, at a
//    pixel pitch of cp + 8 bf16: (cp + 8) / 2 = 4 (mod 8) words, so the
//    eight 16-byte rows of an ldmatrix (eight consecutive pixels) fall in
//    eight different bank quads;
//  * implicit im2col with mma.sync m16n8k16, whose per-row addressing fits
//    extents of 225-361 pixels that are no multiple of 64 (wgmma's M): the
//    A operand of an m16 tile is read straight from the source slot by
//    ldmatrix.x4, each lane giving the address of its own pixel shifted by
//    the tap; the wrapper's k16 rows hold each k16 group's address as
//    base + r * row + q * pitch (a tap is an offset, a route concat a K
//    range per source); a ragged last m16 tile reads its last pixel again
//    and is not stored;
//  * the weights of a step are one (N_pad, K) K-contiguous matrix in
//    device memory, K ordered (tap, source, channel), so that a chunk of
//    KC = 64 K columns is 128-byte rows whatever taps it spans; chunks are
//    staged by cp.async into a two-buffer shared-memory ring of n_pass
//    rows (pitch KC + 8: conflict-free ldmatrix of the B fragments); the
//    next chunk, or the next conv step's first, is copied while this one
//    is multiplied, one barrier each; where a wide step's ring would not
//    fit beside the slots, the wrapper takes narrower passes;
//  * each warp holds mi x nb m16n8 f32 accumulator tiles (at most 16)
//    across the whole K loop; the wrapper splits each step into passes
//    over N and M so that every pass fits the block's warps;
//  * the epilogue, in two phases: from the registers, + f32 bias and one
//    rounding to bf16 into the slot; then each warp over its own rows, the
//    activation in f32 (expf, no fast math), a second rounding and the
//    image mask (out-of-image pixels are the next conv's zero padding).
//    The second phase is specialised per activation and dispatched once:
//    inlined into every accumulator tile, or dispatched per element, the
//    activation cost registers, code and more time than the round trip;
//  * shortcut adds are act(round(a + b)) over bf16 pairs, the activation
//    dispatched per element (yolov4's one add is linear; not timed);
//  * the input slot: the RGB stem gathers a pixel a thread, any other
//    input (non-stem regions, other stems) element by element;
//  * every launch reports cudaGetLastError to the caller.
//
// The FFMA kernel: dense NHWC slots, each thread PX pixels x NC output
// channels over HWIO weights read with __ldg.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int PX = 4;   // output pixels per thread item
constexpr int NC = 8;   // output channels per thread item

// table layout (ints), mirrored by ops/cuda/fused_region.py
constexpr int HDR = 12;       // header ints
constexpr int SLOT_INTS = 6;  // C, oy, ox, eh, ew, smem offset
constexpr int STEP_INTS = 16;
// header: n_steps, n_slots, T, H, W, stem, raw_c, in_slot, out_slot,
//         tiles_x, ring offset (tc), ring buffer elements (tc)
// step:   kind(0 conv, 1 add), act, out, n, n_pad, kh, kw, pt, pl,
//         n_srcs, src0, src1, src2, src3, w_off, b_off

__device__ __forceinline__ void load8(const float* p, float* o) {
  float4 a = __ldg(reinterpret_cast<const float4*>(p));
  float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ float sigmoidf_(float y) {
  return 1.f / (1.f + expf(-y));
}

// codes follow ACT_CODES in ops/cuda/fused_region.py; formulas follow
// darknet_tpu/ops/activations.py
__device__ __forceinline__ float act(float y, int code) {
  switch (code) {
    case 0: return y;                                      // linear
    case 1: return y > 0.f ? y : 0.1f * y;                 // leaky
    case 2: return fmaxf(y, 0.f);                          // relu
    case 3: return fminf(fmaxf(y, 0.f), 6.f);              // relu6
    case 4: return y > 0.f ? y : 0.01f * y;                // relie
    case 5: return (y > 0.f ? y : 0.f) + 0.1f * y;         // ramp
    case 6: {                                              // mish
      // below -20, y * tanh(ex) is y * ex exactly (ex < 2.1e-9)
      const float ex = expf(fminf(fmaxf(y, -20.f), 20.f));
      const float q = (1.f + ex) * (1.f + ex);
      const float m = y * (q - 1.f) / (q + 1.f);
      return y > 20.f ? y : (y < -20.f ? y * ex : m);
    }
    case 7: return y * sigmoidf_(y);                       // swish
    case 8: return sigmoidf_(y);                           // logistic
    case 9: return 2.f * sigmoidf_(y) - 1.f;               // loggy
    case 10: return tanhf(y);                              // tanh
    case 11: return fminf(fmaxf(y, -1.f), 1.f);            // hardtan
    case 12:                                               // gelu
      return 0.5f * y * (1.f + tanhf(0.797885f * y + 0.035677f * y * y * y));
  }
  return y;
}

__global__ void __launch_bounds__(kThreads)
region_kernel(const float* __restrict__ x, float* __restrict__ out,
              const float* __restrict__ wbuf, const float* __restrict__ bbuf,
              const int* __restrict__ tab) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);

  const int n_steps = __ldg(tab + 0);
  const int T = __ldg(tab + 2), H = __ldg(tab + 3), W = __ldg(tab + 4);
  const int stem = __ldg(tab + 5), raw_c = __ldg(tab + 6);
  const int in_slot = __ldg(tab + 7), out_slot = __ldg(tab + 8);
  const int tiles_x = __ldg(tab + 9);
  const int* slots = tab + HDR;
  const int* steps = slots + __ldg(tab + 1) * SLOT_INTS;

  const int b = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * T;
  const int tx0 = (blockIdx.x % tiles_x) * T;
  const int tid = threadIdx.x;

  // ---- input slot: tile + halo, zero outside the image -------------------
  {
    const int* s = slots + in_slot * SLOT_INTS;
    const int C = s[0], oy = s[1], ox = s[2], eh = s[3], ew = s[4];
    float* dst = sm + s[5];
    const int total = eh * ew * C;
    for (int e = tid; e < total; e += kThreads) {
      const int pix = e / C, c = e - pix * C;
      const int gy = ty0 + oy + pix / ew, gx = tx0 + ox + pix % ew;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        if (stem) {
          // space-to-depth: channel (qy*2+qx)*raw_c + c0 of block (gy,gx)
          const int ph = c / raw_c, c0 = c - ph * raw_c;
          const int ry = 2 * gy + (ph >> 1), rx = 2 * gx + (ph & 1);
          v = x[(((size_t)b * 2 * H + ry) * 2 * W + rx) * raw_c + c0];
        } else {
          v = x[(((size_t)b * H + gy) * W + gx) * C + c];
        }
      }
      dst[e] = v;
    }
  }
  __syncthreads();

  for (int si = 0; si < n_steps; ++si) {
    const int* st = steps + si * STEP_INTS;
    const int kind = st[0], code = st[1];
    const int* so = slots + st[2] * SLOT_INTS;
    const int n = so[0], oy_o = so[1], ox_o = so[2], eh_o = so[3],
              ew_o = so[4];
    float* dst = sm + so[5];
    const int npix = eh_o * ew_o;

    if (kind == 1) {
      // shortcut: out = act(a + b)
      const int* sa = slots + st[10] * SLOT_INTS;
      const int* sb = slots + st[11] * SLOT_INTS;
      const float* pa = sm + sa[5];
      const float* pb = sm + sb[5];
      for (int e = tid; e < npix * n; e += kThreads) {
        const int pix = e / n, c = e - pix * n;
        const int r = oy_o + pix / ew_o, q = ox_o + pix % ew_o;
        const int gy = ty0 + r, gx = tx0 + q;
        const float va = pa[((r - sa[1]) * sa[4] + q - sa[2]) * n + c];
        const float vb = pb[((r - sb[1]) * sb[4] + q - sb[2]) * n + c];
        float v = act(va + vb, code);
        if (gy < 0 || gy >= H || gx < 0 || gx >= W) v = 0.f;
        dst[e] = v;
      }
      __syncthreads();
      continue;
    }

    const int n_pad = st[4], kh = st[5], kw = st[6], pt = st[7], pl = st[8];
    const int n_srcs = st[9];
    int c_tot = 0;
    for (int k = 0; k < n_srcs; ++k) c_tot += slots[st[10 + k] * SLOT_INTS];
    const float* wstep = wbuf + st[14];
    const float* bstep = bbuf + st[15];
    const int NG = n_pad / NC;
    const int PG = (npix + PX - 1) / PX;

    for (int item = tid; item < PG * NG; item += kThreads) {
      const int ng = item % NG, pg = item / NG;
      const int n0 = ng * NC;
      int pr[PX], pc[PX];
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        int pix = pg * PX + p;
        if (pix >= npix) pix = 0;        // padding lane: computed, not stored
        pr[p] = oy_o + pix / ew_o;
        pc[p] = ox_o + pix % ew_o;
      }
      float acc[PX][NC];
#pragma unroll
      for (int p = 0; p < PX; ++p)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[p][j] = 0.f;

      for (int ky = 0; ky < kh; ++ky) {
        for (int kx = 0; kx < kw; ++kx) {
          int coff = 0;
          for (int k = 0; k < n_srcs; ++k) {
            const int* ss = slots + st[10 + k] * SLOT_INTS;
            const int C = ss[0];
            const float* base = sm + ss[5];
            const float* ip[PX];
#pragma unroll
            for (int p = 0; p < PX; ++p)
              ip[p] = base + ((pr[p] + ky - pt - ss[1]) * ss[4] +
                              (pc[p] + kx - pl - ss[2])) * C;
            const float* wp =
                wstep + ((size_t)(ky * kw + kx) * c_tot + coff) * n_pad + n0;
            for (int c = 0; c < C; ++c) {
              float wv[NC];
              load8(wp + (size_t)c * n_pad, wv);
#pragma unroll
              for (int p = 0; p < PX; ++p) {
                const float xv = ip[p][c];
#pragma unroll
                for (int j = 0; j < NC; ++j)
                  acc[p][j] = fmaf(xv, wv[j], acc[p][j]);
              }
            }
            coff += C;
          }
        }
      }

#pragma unroll
      for (int p = 0; p < PX; ++p) {
        const int pix = pg * PX + p;
        if (pix >= npix) continue;
        const int gy = ty0 + pr[p], gx = tx0 + pc[p];
        const bool in_img = gy >= 0 && gy < H && gx >= 0 && gx < W;
        float* o = dst + pix * n + n0;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          if (n0 + j >= n) break;
          const float v = act(acc[p][j] + bstep[n0 + j], code);
          o[j] = in_img ? v : 0.f;
        }
      }
    }
    __syncthreads();
  }

  // ---- write the centre tile of the output slot --------------------------
  {
    const int* s = slots + out_slot * SLOT_INTS;
    const int C = s[0], oy = s[1], ox = s[2], ew = s[4];
    const float* src = sm + s[5];
    const int total = T * T * C;
    for (int e = tid; e < total; e += kThreads) {
      const int pix = e / C, c = e - pix * C;
      const int r = pix / T, q = pix % T;
      const int gy = ty0 + r, gx = tx0 + q;
      if (gy < H && gx < W)
        out[(((size_t)b * H + gy) * W + gx) * C + c] =
            src[((r - oy) * ew + (q - ox)) * C + c];
    }
  }
}

// ==========================================================================
// The conv epilogue (bfloat16 convs outside a region)
// ==========================================================================
//
// Replaces no TPU kernel: the JAX package leaves a conv's bias, rounding
// and activation to XLA's fusion.  In eager PyTorch they were separate
// passes (bias add, cast, f32 copy, a dozen ops of mish, cast: about 20
// launches and 160 B an element for a mish conv); here they are one:
//   out[i] = bf16(act(bf16(y[i] + bias[i % C])))
// over the conv's f32 sum y in NHWC, in the order of ops/conv.py: the f32
// bias add (__fadd_rn, never contracted), one rounding to bf16, the
// activation in f32 on that value (act(), the region kernels' own), and a
// second rounding.
//
// Bound: bytes, 6 an element (f32 read, bf16 written; the bias stays in
// L1): the 102 convs yolov4-608 serves outside the region kernel write
// 0.7-23.7 M elements each at b=8, 513 M a request: 3.08 GB, 0.92 ms at
// 3.35 TB/s (the largest map 42 us).  Mish's expf and IEEE division take
// about as much issue time as the loads, which the warps overlap.
// Design: a grid-stride loop over groups of 8 elements, each thread
// loading 2 x 16 B of f32 (streaming: the sum is read once) and storing
// 16 B of bf16 (cached: the next conv reads it); where C % 8 == 0 a
// group's 8 channels are consecutive and their biases two 16-byte loads,
// else each channel index wraps on its own (head convs: 255, 57
// channels); the n % 8 tail is done element by element.  No shared
// memory, no allocation.  A layout of 4-element units whose every warp
// load is one contiguous 512 B span gave bitwise the same output and
// took 7% longer over yolov4-608's served maps (H100 SXM, L2 cleared
// before each launch): the loads' sector spread costs nothing here.
constexpr int kEpiThreads = 256;

template <int CODE>
__device__ __forceinline__ float epilogue1(float y, float b) {
  return act(__bfloat162float(__float2bfloat16_rn(__fadd_rn(y, b))), CODE);
}

template <int CODE, bool VEC_C>
__global__ void __launch_bounds__(kEpiThreads)
conv_epilogue_kernel(const float* __restrict__ y,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, long long n, int C) {
  const long long n8 = n >> 3;
  const long long first = (long long)blockIdx.x * kEpiThreads + threadIdx.x;
  const long long step = (long long)gridDim.x * kEpiThreads;
  // the group's first channel, advanced by the stride's channels
  int c0 = (int)((first << 3) % C);
  const int dc = (int)((step << 3) % C);
  for (long long g = first; g < n8; g += step) {
    const float4* src = reinterpret_cast<const float4*>(y) + 2 * g;
    const float4 lo = __ldcs(src), hi = __ldcs(src + 1);
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    float b[8];
    if constexpr (VEC_C) {
      const float4* bp = reinterpret_cast<const float4*>(bias + c0);
      const float4 b0 = __ldg(bp), b1 = __ldg(bp + 1);
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
    } else {
      int c = c0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        b[j] = __ldg(bias + c);
        c = c + 1 == C ? 0 : c + 1;
      }
    }
    c0 += dc;
    if (c0 >= C) c0 -= C;
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(
          epilogue1<CODE>(v[2 * k], b[2 * k]),
          epilogue1<CODE>(v[2 * k + 1], b[2 * k + 1]));
      w[k] = *reinterpret_cast<const uint32_t*>(&h);
    }
    reinterpret_cast<uint4*>(out)[g] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  const long long t = (n8 << 3) + first;      // the ragged tail, < 8
  if (t < n)
    out[t] = __float2bfloat16_rn(
        epilogue1<CODE>(__ldg(y + t), __ldg(bias + (int)(t % C))));
}

// ==========================================================================
// The tensor-core kernel (bfloat16)
// ==========================================================================

namespace tc {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int kMaxThreads = 512;
constexpr int SLOT_INTS = 8;   // C, oy, ox, eh, ew, smem offset, cp, pitch
constexpr int STEP_INTS = 22;
// step: kind, act, out, n, n_pad (add: cp), kh, kw, pt, pl, n_srcs,
//       src0..src3, w_off, b_off, k_tot, n_pass, m_items per pass, mi, nb,
//       k16 rows (int4 index into the table)
// k16 row: the A address of k16 group g for tile-relative output pixel
//          (r, q) is smem + base + r * row + q * pitch (bytes)
constexpr int KC = 64;          // K columns per weight chunk
constexpr int WPITCH = KC + 8;  // chunk row pitch (bf16)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// no "memory" clobber: the shared-memory reads are ordered by the
// barriers, and the compiler may move them ahead of the mma that precede
__device__ __forceinline__ void ldsm4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

// rows [n0, n0 + n_pass) x columns [k0, k0 + kw) of a step's (N_pad, K)
// weights into one ring buffer, one commit group per thread
__device__ __forceinline__ void issue_chunk(bf16* buf,
                                            const bf16* __restrict__ w,
                                            int n0, int n_pass, int k_tot,
                                            int k0, int kw) {
  const int segs = kw >> 3;
  const int total = n_pass * segs;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int n = e / segs, s = e - n * segs;
    cp_async16(smem_u32(buf + n * WPITCH + s * 8),
               w + (size_t)(n0 + n) * k_tot + k0 + s * 8);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ bool in_image(int gy, int gx, int H, int W) {
  return gy >= 0 && gy < H && gx >= 0 && gx < W;
}

// Phase 2 of a conv step's epilogue, one warp over its rows [m0, m1) of a
// slot: ppr channel pairs a row from `o`, the activation (CODE, constant:
// no per-element dispatch), a second rounding, the image mask.  (gy0, gx0)
// is the image position of the slot's pixel 0.
template <int CODE>
__device__ __forceinline__ void act_rows_c(bf16* o, int pitch, int ppr,
                                           int m0, int m1, int ew, int gy0,
                                           int gx0, int H, int W) {
  const int lane = threadIdx.x & 31, step = 32 / ppr;
  int m = m0 + lane / ppr;
  int r = m / ew, q = m - r * ew;
  bf162* p = reinterpret_cast<bf162*>(o + m * pitch) + lane % ppr;
#pragma unroll 4
  for (; m < m1; m += step, p += step * pitch / 2) {
    const bool keep = in_image(gy0 + r, gx0 + q, H, W);
    const float2 v = __bfloat1622float2(*p);
    *p = __floats2bfloat162_rn(keep ? act(v.x, CODE) : 0.f,
                               keep ? act(v.y, CODE) : 0.f);
    for (q += step; q >= ew; q -= ew) ++r;
  }
}

__device__ __noinline__ void act_rows(int code, bf16* o, int pitch, int ppr,
                                      int m0, int m1, int ew, int gy0,
                                      int gx0, int H, int W) {
#define ACT_ROWS(C) \
  case C: act_rows_c<C>(o, pitch, ppr, m0, m1, ew, gy0, gx0, H, W); break;
  switch (code) {
    ACT_ROWS(0) ACT_ROWS(1) ACT_ROWS(2) ACT_ROWS(3) ACT_ROWS(4) ACT_ROWS(5)
    ACT_ROWS(6) ACT_ROWS(7) ACT_ROWS(8) ACT_ROWS(9) ACT_ROWS(10)
    ACT_ROWS(11) ACT_ROWS(12)
  }
#undef ACT_ROWS
}

// the first chunk of a conv step
__device__ __forceinline__ void issue_first(bf16* buf,
                                            const bf16* __restrict__ wbuf,
                                            const int* __restrict__ st) {
  const int k_tot = __ldg(st + 16);
  issue_chunk(buf, wbuf + __ldg(st + 14), 0, __ldg(st + 17), k_tot, 0,
              min(KC, k_tot));
}

// One conv step: passes over (N, M); in each, warp w owns the m16 tiles
// [mt0, mt0 + MI) and the n8 tiles [nrow0 / 8, + NB) and accumulates over
// every weight chunk of the pass.  `chunk` counts the ring's chunks over
// the whole launch: chunk c sits in buffer c & 1.  The step's first chunk
// is already in flight (issued during the previous conv step, or before
// the input load); its last chunk issues the first of `st_next`, the
// next conv step, if any.
template <int MI, int NB>
__device__ __forceinline__ void conv_step(
    const int* __restrict__ tab, const int* __restrict__ st,
    const int* __restrict__ st_next, const int* __restrict__ slots,
    bf16* sm, bf16* ring, int ring_stride, int& chunk,
    const bf16* __restrict__ wbuf, const float* __restrict__ bbuf, int ty0,
    int tx0, int H, int W) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int code = __ldg(st + 1);
  const int* so = slots + __ldg(st + 2) * SLOT_INTS;
  const int oy_o = __ldg(so + 1), ox_o = __ldg(so + 2);
  const int eh_o = __ldg(so + 3), ew_o = __ldg(so + 4);
  const int pitch_o = __ldg(so + 7);
  bf16* dst = sm + __ldg(so + 5);
  const int n_pad = __ldg(st + 4);
  const bf16* w = wbuf + __ldg(st + 14);
  const float* bias = bbuf + __ldg(st + 15);
  const int k_tot = __ldg(st + 16), n_pass = __ldg(st + 17);
  const int mip = __ldg(st + 18);
  const int4* meta = reinterpret_cast<const int4*>(tab) + __ldg(st + 21);
  const uint32_t a_lane = smem_u32(sm) + ((lane >> 4) << 4);
  const int M = eh_o * ew_o, mt = (M + 15) >> 4;
  const int items_n = n_pass / (8 * NB);
  const int m_items = (mt + MI - 1) / MI;
  const int passes_m = (m_items + mip - 1) / mip;
  const int passes = (n_pad / n_pass) * passes_m;
  const int n_kc = (k_tot + KC - 1) / KC;
  const int total = passes * n_kc;

  const int wn = warp % items_n, wm = warp / items_n;
  const int nrow0 = wn * NB * 8;               // first row in the chunk
  int idx = 0;
  for (int p = 0; p < passes; ++p) {
    const int pn = p / passes_m, pm = p - pn * passes_m;
    const int mitem = pm * mip + wm;
    const bool active = wm < mip && mitem < m_items;   // warp-uniform
    const int mt0 = mitem * MI;
    int r[MI], q[MI];                           // this lane's A rows
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int m = min((mt0 + i) * 16 + (lane & 15), M - 1);
      r[i] = oy_o + m / ew_o;
      q[i] = ox_o + m % ew_o;
    }
    float acc[MI][NB][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    for (int kc = 0; kc < n_kc; ++kc, ++idx, ++chunk) {
      bf16* buf = ring + (chunk & 1) * ring_stride;
      bf16* next = ring + ((chunk + 1) & 1) * ring_stride;
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();          // chunk landed; every warp left chunk - 1
      if (idx + 1 < total) {
        const int p2 = (idx + 1) / n_kc, kc2 = idx + 1 - p2 * n_kc;
        issue_chunk(next, w, (p2 / passes_m) * n_pass, n_pass, k_tot,
                    kc2 * KC, min(KC, k_tot - kc2 * KC));
      } else if (st_next != nullptr) {
        issue_first(next, wbuf, st_next);
      }
      if (!active) continue;
      const uint32_t bbase =
          smem_u32(buf) +
          ((nrow0 + (lane & 7) + ((lane >> 4) << 3)) * WPITCH +
           (((lane >> 3) & 1) << 3)) * 2;
      const int kw_c = min(KC, k_tot - kc * KC);
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        if (kk >= kw_c) break;
        const int4 g = __ldg(meta + ((kc * KC + kk) >> 4));
        uint32_t a[MI][4];
#pragma unroll
        for (int i = 0; i < MI; ++i)
          if (mt0 + i < mt)
            ldsm4(a_lane + g.x + r[i] * g.y + q[i] * g.z, a[i]);
        uint32_t b[NB][2];
#pragma unroll
        for (int j = 0; j < NB / 2; ++j) {
          uint32_t t[4];
          ldsm4(bbase + (j * 16 * WPITCH + kk) * 2, t);
          b[2 * j][0] = t[0];
          b[2 * j][1] = t[1];
          b[2 * j + 1][0] = t[2];
          b[2 * j + 1][1] = t[3];
        }
#pragma unroll
        for (int i = 0; i < MI; ++i)
          if (mt0 + i < mt)
#pragma unroll
            for (int j = 0; j < NB; ++j)
              mma16816(acc[i][j], a[i], b[j][0], b[j][1]);
      }
    }

    if (!active) continue;
    // epilogue, phase 1: + bias, round to bf16, into the slot
    const int ncol0 = pn * n_pass + nrow0;
    const int ncol = ncol0 + (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      if (mt0 + i >= mt) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (mt0 + i) * 16 + (lane >> 2) + 8 * h;
        if (m >= M) continue;
        bf16* o = dst + m * pitch_o + ncol;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const int n = ncol + j * 8;
          *reinterpret_cast<bf162*>(o + j * 8) = __floats2bfloat162_rn(
              acc[i][j][2 * h] + __ldg(bias + n),
              acc[i][j][2 * h + 1] + __ldg(bias + n + 1));
        }
      }
    }
    __syncwarp();
    // phase 2, over the warp's own rows: the activation in f32, round
    // again, out-of-image pixels to 0
    act_rows(code, dst + ncol0, pitch_o, NB * 4, mt0 * 16,
             min(M, (mt0 + MI) * 16), ew_o, ty0 + oy_o, tx0 + ox_o, H, W);
  }
}

// shortcut: out = act(round(a + b)) over channel pairs
__device__ __noinline__ void add_step(const int* __restrict__ st,
                                      const int* __restrict__ slots,
                                      bf16* sm, int ty0, int tx0, int H,
                                      int W) {
  const int code = __ldg(st + 1);
  const int* so = slots + __ldg(st + 2) * SLOT_INTS;
  const int* sa = slots + __ldg(st + 10) * SLOT_INTS;
  const int* sb = slots + __ldg(st + 11) * SLOT_INTS;
  const int oy_o = __ldg(so + 1), ox_o = __ldg(so + 2);
  const int ew_o = __ldg(so + 4), pitch_o = __ldg(so + 7);
  const int half = __ldg(so + 6) >> 1;
  const int npix = __ldg(so + 3) * ew_o;
  const int oya = __ldg(sa + 1), oxa = __ldg(sa + 2), ewa = __ldg(sa + 4);
  const int oyb = __ldg(sb + 1), oxb = __ldg(sb + 2), ewb = __ldg(sb + 4);
  const int pitch_a = __ldg(sa + 7), pitch_b = __ldg(sb + 7);
  const bf16* pa = sm + __ldg(sa + 5);
  const bf16* pb = sm + __ldg(sb + 5);
  bf16* dst = sm + __ldg(so + 5);
  // thread t takes channel pairs t % half + k * blockDim of pixels
  // t / half + j * stride (the slot's pixels walked in order, no
  // division in the loop)
  const int stride = max(1, (int)blockDim.x / half);
  if (threadIdx.x >= stride * half) return;
  for (int c = (threadIdx.x % half) * 2; c < 2 * half; c += 2 * blockDim.x)
  for (int pix = threadIdx.x / half, r = pix / ew_o, q = pix - r * ew_o;
       pix < npix; pix += stride) {
    const int rr = oy_o + r, qq = ox_o + q;
    const float2 va = __bfloat1622float2(*reinterpret_cast<const bf162*>(
        pa + ((rr - oya) * ewa + qq - oxa) * pitch_a + c));
    const float2 vb = __bfloat1622float2(*reinterpret_cast<const bf162*>(
        pb + ((rr - oyb) * ewb + qq - oxb) * pitch_b + c));
    float v0 = act(__bfloat162float(__float2bfloat16(va.x + vb.x)), code);
    float v1 = act(__bfloat162float(__float2bfloat16(va.y + vb.y)), code);
    const bool keep = in_image(ty0 + rr, tx0 + qq, H, W);
    *reinterpret_cast<bf162*>(dst + pix * pitch_o + c) =
        __floats2bfloat162_rn(keep ? v0 : 0.f, keep ? v1 : 0.f);
    for (q += stride; q >= ew_o; q -= ew_o) ++r;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
region_tc_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                 const bf16* __restrict__ wbuf,
                 const float* __restrict__ bbuf,
                 const int* __restrict__ tab) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* sm = reinterpret_cast<bf16*>(smem_tc);

  const int n_steps = __ldg(tab + 0);
  const int T = __ldg(tab + 2), H = __ldg(tab + 3), W = __ldg(tab + 4);
  const int stem = __ldg(tab + 5), raw_c = __ldg(tab + 6);
  const int in_slot = __ldg(tab + 7), out_slot = __ldg(tab + 8);
  const int tiles_x = __ldg(tab + 9);
  bf16* ring = sm + __ldg(tab + 10);
  const int ring_stride = __ldg(tab + 11);
  const int* slots = tab + HDR;
  const int* steps = slots + __ldg(tab + 1) * SLOT_INTS;

  const int b = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * T;
  const int tx0 = (blockIdx.x % tiles_x) * T;
  const int tid = threadIdx.x;

  // the first conv step's first weight chunk loads under the input load
  const int* conv = steps;
  while (conv < steps + n_steps * STEP_INTS && __ldg(conv) != 0)
    conv += STEP_INTS;
  if (conv < steps + n_steps * STEP_INTS) issue_first(ring, wbuf, conv);

  // ---- input slot: tile + halo, channels padded, zero outside the image
  {
    const int* s = slots + in_slot * SLOT_INTS;
    const int C = s[0], oy = s[1], ox = s[2], ew = s[4];
    const int cp = s[6], pitch = s[7];
    bf16* dst = sm + s[5];
    const int npix = s[3] * ew;
    const bf16 zero = __float2bfloat16(0.f);
    if (stem && raw_c == 3 && cp == 16) {
      // RGB space-to-depth, one pixel a thread: channel (qy*2+qx)*3 + c0
      // of block (gy, gx) is raw pixel (2gy+qy, 2gx+qx), channel c0
      for (int pix = tid; pix < npix; pix += blockDim.x) {
        const int gy = ty0 + oy + pix / ew, gx = tx0 + ox + pix % ew;
        __align__(16) bf16 v[16];
#pragma unroll
        for (int c = 0; c < 16; ++c) v[c] = zero;
        if (in_image(gy, gx, H, W)) {
#pragma unroll
          for (int ph = 0; ph < 4; ++ph) {
            const bf16* p = x + (((size_t)b * 2 * H + 2 * gy + (ph >> 1)) *
                                     2 * W + 2 * gx + (ph & 1)) * 3;
#pragma unroll
            for (int c0 = 0; c0 < 3; ++c0) v[ph * 3 + c0] = p[c0];
          }
        }
        uint4* o = reinterpret_cast<uint4*>(dst + pix * pitch);
        o[0] = *reinterpret_cast<const uint4*>(v);
        o[1] = *reinterpret_cast<const uint4*>(v + 8);
      }
    } else {
      for (int e = tid; e < npix * cp; e += blockDim.x) {
        const int pix = e / cp, c = e - pix * cp;
        const int gy = ty0 + oy + pix / ew, gx = tx0 + ox + pix % ew;
        bf16 v = zero;
        if (c < C && in_image(gy, gx, H, W)) {
          if (stem) {
            const int ph = c / raw_c, c0 = c - ph * raw_c;
            const int ry = 2 * gy + (ph >> 1), rx = 2 * gx + (ph & 1);
            v = x[(((size_t)b * 2 * H + ry) * 2 * W + rx) * raw_c + c0];
          } else {
            v = x[(((size_t)b * H + gy) * W + gx) * C + c];
          }
        }
        dst[pix * pitch + c] = v;
      }
    }
  }

  int chunk = 0;
  for (int si = 0; si < n_steps; ++si) {
    const int* st = steps + si * STEP_INTS;
    if (__ldg(st) == 1) {
      __syncthreads();          // the sources are complete
      add_step(st, slots, sm, ty0, tx0, H, W);
      continue;
    }
    const int* st_next = st + STEP_INTS;
    while (st_next < steps + n_steps * STEP_INTS && __ldg(st_next) != 0)
      st_next += STEP_INTS;
    if (st_next == steps + n_steps * STEP_INTS) st_next = nullptr;
#define REGION_CONV(MI, NB)                                               \
  case MI * 16 + NB:                                                      \
    conv_step<MI, NB>(tab, st, st_next, slots, sm, ring, ring_stride,     \
                      chunk, wbuf, bbuf, ty0, tx0, H, W);                 \
    break;
    switch (__ldg(st + 19) * 16 + __ldg(st + 20)) {
      REGION_CONV(1, 2) REGION_CONV(1, 4) REGION_CONV(1, 8)
      REGION_CONV(2, 2) REGION_CONV(2, 4) REGION_CONV(2, 8)
      REGION_CONV(3, 2) REGION_CONV(3, 4)
      REGION_CONV(4, 2) REGION_CONV(4, 4)
    }
#undef REGION_CONV
  }
  __syncthreads();

  // ---- write the centre tile of the output slot --------------------------
  {
    const int* s = slots + out_slot * SLOT_INTS;
    const int C = s[0], oy = s[1], ox = s[2], ew = s[4], pitch = s[7];
    const bf16* src = sm + s[5];
    if ((C & 7) == 0) {
      const int c8 = C >> 3, total = T * T * c8;
      for (int e = tid; e < total; e += blockDim.x) {
        const int pix = e / c8, c = (e - pix * c8) * 8;
        const int r = pix / T, q = pix % T;
        const int gy = ty0 + r, gx = tx0 + q;
        if (gy < H && gx < W)
          *reinterpret_cast<uint4*>(out + (((size_t)b * H + gy) * W + gx) *
                                              C + c) =
              *reinterpret_cast<const uint4*>(
                  src + ((r - oy) * ew + (q - ox)) * pitch + c);
      }
    } else {
      const int total = T * T * C;
      for (int e = tid; e < total; e += blockDim.x) {
        const int pix = e / C, c = e - pix * C;
        const int r = pix / T, q = pix % T;
        const int gy = ty0 + r, gx = tx0 + q;
        if (gy < H && gx < W)
          out[(((size_t)b * H + gy) * W + gx) * C + c] =
              src[((r - oy) * ew + (q - ox)) * pitch + c];
      }
    }
  }
}

}  // namespace tc

int launch_ffma(const void* x, void* y, const void* w, const float* bias,
                const int* tab, int batch, int n_tiles, int smem_bytes,
                cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      region_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_tiles, batch);
  region_kernel<<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<const float*>(w), bias, tab);
  return (int)cudaGetLastError();
}

int launch_tc(const void* x, void* y, const void* w, const float* bias,
              const int* tab, int batch, int n_tiles, int smem_bytes,
              int threads, cudaStream_t stream) {
  if (threads <= 0 || threads > tc::kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      tc::region_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_tiles, batch);
  tc::region_tc_kernel<<<grid, threads, smem_bytes, stream>>>(
      static_cast<const tc::bf16*>(x), static_cast<tc::bf16*>(y),
      static_cast<const tc::bf16*>(w), bias, tab);
  return (int)cudaGetLastError();
}

template <int CODE>
int launch_epilogue(const float* y, const float* bias, __nv_bfloat16* out,
                    long long n, int C, cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  // enough blocks to fill every SM (8 x 256 threads), fewer for a small map
  const long long groups = (n >> 3) > 0 ? (n >> 3) : 1;
  const long long want = (groups + kEpiThreads - 1) / kEpiThreads;
  const int blocks = (int)(want < 8LL * sms ? want : 8LL * sms);
  // the biases of 8 consecutive channels as two 16-byte loads
  const bool vec = C % 8 == 0 && reinterpret_cast<uintptr_t>(bias) % 16 == 0;
  if (vec)
    conv_epilogue_kernel<CODE, true><<<blocks, kEpiThreads, 0, stream>>>(
        y, bias, out, n, C);
  else
    conv_epilogue_kernel<CODE, false><<<blocks, kEpiThreads, 0, stream>>>(
        y, bias, out, n, C);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32 (FFMA kernel, kThreads threads), 1 bfloat16 (tensor-
// core kernel, `threads` threads).  Returns the cudaError_t of the launch.
extern "C" int region_launch(int dtype, const void* x, void* y,
                             const void* w, const float* bias,
                             const int* tab, int batch, int n_tiles,
                             int smem_bytes, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_ffma(x, y, w, bias, tab, batch, n_tiles, smem_bytes, s);
  if (dtype == 1)
    return launch_tc(x, y, w, bias, tab, batch, n_tiles, smem_bytes, threads,
                     s);
  return (int)cudaErrorInvalidValue;
}

// out (n,) bf16 = act(round(y + bias[i % C])), rounded; y and out
// contiguous and 16-byte aligned, act a code of ACT_CODES in
// ops/cuda/fused_region.py.  Returns the cudaError_t of the launch.
extern "C" int conv_epilogue_launch(const void* y, const void* bias,
                                    void* out, long long n, int C, int code,
                                    void* stream) {
  const float* yp = static_cast<const float*>(y);
  const float* bp = static_cast<const float*>(bias);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || C <= 0 || reinterpret_cast<uintptr_t>(y) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  switch (code) {
    case 0: return launch_epilogue<0>(yp, bp, op, n, C, s);
    case 1: return launch_epilogue<1>(yp, bp, op, n, C, s);
    case 2: return launch_epilogue<2>(yp, bp, op, n, C, s);
    case 3: return launch_epilogue<3>(yp, bp, op, n, C, s);
    case 4: return launch_epilogue<4>(yp, bp, op, n, C, s);
    case 5: return launch_epilogue<5>(yp, bp, op, n, C, s);
    case 6: return launch_epilogue<6>(yp, bp, op, n, C, s);
    case 7: return launch_epilogue<7>(yp, bp, op, n, C, s);
    case 8: return launch_epilogue<8>(yp, bp, op, n, C, s);
    case 9: return launch_epilogue<9>(yp, bp, op, n, C, s);
    case 10: return launch_epilogue<10>(yp, bp, op, n, C, s);
    case 11: return launch_epilogue<11>(yp, bp, op, n, C, s);
    case 12: return launch_epilogue<12>(yp, bp, op, n, C, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* region_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
