// W8A16 group-dequant GEMM for Hopper (sm_90a): y[M,N] = x[M,K] @ dequant(q, s).
//
// Replaces the TPU kernel kuiperllama_tpu/ops/pallas/quant_matmul.py `_kernel`
// (the tiled group-dequant matmul), which serves every INT8 projection with
// 2 to 255 rows (prefill under 256 tokens, B > 1 decode), M = 1 with more than
// 64 groups, and every M < 256 projection in exact mode. Two modes, with the
// rounding of `_kernel`:
//   fast:  w = bf16(bf16(q) * bf16(s)), a = bf16(x), y = sum_k a * w in fp32;
//   exact: w = fp32(q) * fp32(s), a = fp32(x), y = sum_k a * w in fp32.
// In fast mode every product a * w is exact in fp32 (8-bit by 8-bit
// mantissas), so the kernels differ from the TPU only in summation order.
//
// What bounds it on this card: bytes up to M of about 150 at the Llama-2-7B
// shapes (q is read once, one byte per M multiply-adds, and the card does
// about 295 bf16 operations per byte it reads), the bf16 tensor-core rate
// above that. The dequantize costs about 3.3 instructions a weight; in
// the mma.sync kernel at M = 8 it and the mma were each 15-24% of a call,
// neither the pace (tools/gemm_costs.py). In the wgmma kernel, measured the
// same way: at M <= 32 the TMA ring's own stream is 83-87% of a call; at
// M = 255 the consumers set the pace (wgmma issue 53%, the dequantize 16%).
//
// Fast mode has two kernels; the wrapper (ops/kernels/quant_matmul.py
// `gemm_route`) picks one by shape before the launch and counts it:
//
// The wgmma route (every fast call with M <= 256, x, q and s 16-byte
// aligned, N % 16 == 0, K % 8 == 0, g % 16 == 0 and g dividing 64 or 64
// dividing g: every INT8 projection of the supported models) reads and
// dequantizes each weight byte once per call: one block covers all M rows
// of its 128 weight columns and its K split (`gemm_tma_kernel`).
//   * The weight is wgmma's A operand, from registers: m64nNk16 with 64
//     weight columns a warpgroup and N = M rounded up to 8; x^T is B, read
//     from shared memory through a descriptor, K-major with the 128-byte
//     swizzle that its TMA box writes. One kernel for each N (8 .. 256):
//     its wgmmas, one per set bit of N/8, are fixed at compile time, since
//     ptxas serializes every wgmma of a kernel that chooses among them at
//     run time. x reaches the kernel as bf16 (the wrapper rounds an fp32 x
//     first, one counted launch).
//   * Warp specialisation over an mbarrier ring: one producer thread issues
//     three TMA boxes a stage (int8 tile 64 k x 128 columns, 8 KB, swizzled;
//     x's 64 k of every row; the stage's scale rows) against the stage's
//     full barrier with expect_tx; the ring is as deep as shared memory
//     allows (up to 16 stages). Two consumer warpgroups own 64 columns each.
//     Per two 16-k steps a thread takes its int8 words with one
//     ldmatrix.x4.trans (the int8 tile read as b16 column pairs: k-rows 2t,
//     2t + 1, 2t + 8, 2t + 9 of columns 2gr, 2gr + 1, conflict-free under
//     the swizzle), dequantizes them straight into A with the mma.sync
//     kernel's bf16x2 arithmetic, and issues the two steps' wgmma.mma_async
//     as one group; two A sets let one group's dequantize overlap the
//     previous group's wgmmas (commit_group, wait_group 1), and a warp
//     arrives on a stage's empty barrier once its last group has completed.
//   * Up to N = 64 two blocks share an SM, above it one; setmaxnreg moves
//     the producer warpgroup's registers to the consumers. Every barrier
//     wait traps after 2^22 failed polls (seconds) rather than hang the card.
//   * Split K from a cost model (`gemm_wgmma_plan`) that weighs waves of
//     blocks against the fp32 partials, 4 * splits * M * N bytes, which it
//     keeps under the weight's K * N; the fixed-order reduce_splits sums
//     them, so results repeat bit for bit. The tensor maps are encoded per
//     call (a layer's view has its own pointer), with the encoder found
//     through the CUDA runtime, and reach the kernel by value, so a CUDA
//     graph records them.
//
// The mma.sync route (ragged or unaligned shapes, other g: PR 6's kernel,
// `gemm_fast_kernel`) streams the weight once per 64-row M tile:
//   * a 4-stage ring in shared memory, filled with cp.async 16 bytes a
//     thread: each stage is a 64 x 128 int8 weight tile (8 KB), its x rows
//     and one scale row per 16 k-rows;
//   * dequant in packed bf16x2 arithmetic: int8 becomes an exact fp32 by a
//     byte permute into 2^23 + (q + 128) and one subtraction, two such
//     values pack into bf16x2 by a byte permute (exact: |q| <= 128 fits
//     bf16's significand), and one fma.rn.bf16x2 with a -0 addend multiplies
//     by (bf16(s), bf16(s)) with a single rounding. That equals
//     round_bf16(q * round_bf16(s)), since the product of two 8-bit
//     significands is exact in fp32;
//   * mma.sync m16n8k16 with the weight as the 16-row A operand and x^T the
//     n8 B operand; the block's M tile is 8, 16, 32 or 64 rows. Each thread
//     reads four 4-byte words of the int8 tile (4 k-rows x 4 columns) and
//     transposes them by byte permutes; the k order inside a 16-row step is
//     permuted the same way for A and B. An XOR swizzle of the tile's
//     32-byte column blocks by k-row keeps those reads free of bank
//     conflicts;
//   * split K from the SM count (gemm_k_per_split: about three blocks per
//     SM), summed by the same reduce_splits. Operands that are not 16-byte
//     aligned, or K % 8 or N % 16 not 0, take scalar loads into the ring.
// Exact mode is on no main path (only tests ask for it) and keeps the first
// version's body: 64 x 64 output tiles, fp32 FMA on the CUDA cores. M, N and
// K edges are masked in every kernel (the TMA boxes fill zeros past them);
// scale rows past K / g are never read.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <utility>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;  // exact: 16 x 16 threads
constexpr int kTM = 4;
constexpr int kTN = 4;
constexpr int kVec = 8;        // elements of each operand a thread stages per tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Eight consecutive elements as fp32, from one 16-byte load (int8: 8 bytes).
__device__ __forceinline__ void load8(const float* p, float (&o)[kVec]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&o)[kVec]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int j = 0; j < kVec; ++j) o[j] = __bfloat162float(h[j]);
}
__device__ __forceinline__ void load8(const int8_t* p, float (&o)[kVec]) {
  const int2 v = __ldg(reinterpret_cast<const int2*>(p));
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int j = 0; j < kVec; ++j) o[j] = (float)b[j];
}

// Exact mode's share of this thread of the tiles at k0, in fp32:
// x[m0 + xm][k0 + xk .. +7] and w[k0 + wk][n0 + wn .. +7]. With vec (K and
// N multiples of 8, operands 16-byte aligned) a run of 8 is wholly inside or
// outside the matrix and is read with one vector load per operand.
template <typename XT, typename ST>
__device__ __forceinline__ void load_tiles(
    const XT* __restrict__ x, const int8_t* __restrict__ q,
    const ST* __restrict__ s, int M, int K, int N, int g, int k0, int k_end,
    int m0, int n0, int xm, int xk, int wk, int wn, bool vec,
    float (&xr)[kVec], float (&wr)[kVec]) {
  const int m = m0 + xm;
  const int kx = k0 + xk;
  if (vec) {
    if (m < M && kx < k_end) load8(x + (size_t)m * K + kx, xr);
    else
#pragma unroll
      for (int j = 0; j < kVec; ++j) xr[j] = 0.f;
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      xr[j] = (m < M && kx + j < k_end) ? to_f(x[(size_t)m * K + kx + j]) : 0.f;
  }

  const int k = k0 + wk;
  const int n = n0 + wn;
  const int8_t* qrow = q + (size_t)k * N + n;
  const ST* srow = s + (size_t)(k / g) * N + n;
  float qv[kVec], sv[kVec];
  if (vec) {
    if (k < k_end && n < N) {
      load8(qrow, qv);
      load8(srow, sv);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) qv[j] = sv[j] = 0.f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const bool in = k < k_end && n + j < N;
      qv[j] = in ? (float)qrow[j] : 0.f;
      sv[j] = in ? to_f(srow[j]) : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) wr[j] = qv[j] * sv[j];
}

// Writes one output element: to y when one split covers K, else to this
// split's fp32 partial.
template <typename XT, bool DIRECT>
__device__ __forceinline__ void put(XT* __restrict__ y, float* __restrict__ partial,
                                    int M, int N, int m, int n, float v) {
  if (DIRECT) store(y + (size_t)m * N + n, v);
  else partial[((size_t)blockIdx.z * M + m) * N + n] = v;
}

// Exact mode. Block (blockIdx.x, blockIdx.y, blockIdx.z) computes the
// 64 x 64 output tile (blockIdx.y, blockIdx.x) over K rows
// [blockIdx.z * k_per_split, +k_per_split) with fp32 FMA.
template <typename XT, typename ST, bool DIRECT>
__global__ void __launch_bounds__(kThreads)
gemm_exact_kernel(const XT* __restrict__ x, const int8_t* __restrict__ q,
                  const ST* __restrict__ s, XT* __restrict__ y,
                  float* __restrict__ partial, int M, int K, int N, int g,
                  int k_per_split, bool vec) {
  __shared__ float xs[kBK][kBM + 4];  // x tile, transposed: xs[k][m]
  __shared__ float ws[kBK][kBN + 4];  // dequantized weight tile: ws[k][n]

  const int tid = threadIdx.x;
  const int tr = tid / (kBN / kTN);
  const int tc = tid % (kBN / kTN);
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  // staging roles: x tile 64 rows x 4 runs of 8; w tile 32 rows x 8 runs of 8
  const int xm = tid / (kBK / kVec), xk = (tid % (kBK / kVec)) * kVec;
  const int wk = tid / (kBN / kVec), wn = (tid % (kBN / kVec)) * kVec;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  float xr[kVec], wr[kVec];
  load_tiles<XT, ST>(x, q, s, M, K, N, g, k_begin, k_end, m0, n0, xm, xk, wk,
                     wn, vec, xr, wr);
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      xs[xk + j][xm] = xr[j];
      ws[wk][wn + j] = wr[j];
    }
    __syncthreads();
    if (k0 + kBK < k_end)  // next tile's loads run while this one multiplies
      load_tiles<XT, ST>(x, q, s, M, K, N, g, k0 + kBK, k_end, m0, n0, xm, xk,
                         wk, wn, vec, xr, wr);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[kk][tr * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = ws[kk][tc * kTN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + tr * kTM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tc * kTN + j;
      if (n < N) put<XT, DIRECT>(y, partial, M, N, m, n, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Fast mode

constexpr int kFastBN = 128;      // weight columns per block: 4 warps x 32
constexpr int kFastBK = 64;       // K rows per ring stage
constexpr int kStages = 4;
constexpr int kFastThreads = 128;
constexpr int kSubK = 16;         // K rows per mma step
constexpr int kSubs = kFastBK / kSubK;
// Variants of the fast kernel that only tools/gemm_costs.py launches (their
// values are wrong): the weight's packed int8 words go to the mma as if
// they were bf16 (no dequantize), or the A fragments are made and no mma
// (nor x's B fragment read) follows.
constexpr int kProbeNone = 0, kProbeNoDequant = 1, kProbeNoMma = 2;

// One ring stage: the int8 weight tile [kFastBK][kFastBN] (32-byte column
// blocks XOR-swizzled by (k / 4) % 4), the x tile [NT * 8][kXLd] in x's
// dtype (16 bytes of padding per row), and kSubs scale rows [kSubs][kFastBN]
// in the scales' dtype. Every part is a multiple of 16 bytes.
template <typename XT, typename ST, int NT>
struct Stage {
  static constexpr int kXLd = kFastBK + 16 / (int)sizeof(XT);
  static constexpr int kW = kFastBK * kFastBN;
  static constexpr int kX = NT * 8 * kXLd * (int)sizeof(XT);
  static constexpr int kS = kSubs * kFastBN * (int)sizeof(ST);
  static constexpr int kBytes = kW + kX + kS;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = in ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ int swz(int r, int c) { return c ^ (((r >> 2) & 3) << 5); }

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// Fills one stage with the K rows [k0, k0 + kFastBK) of the block's tiles.
template <typename XT, typename ST, int NT>
__device__ __forceinline__ void load_stage(
    unsigned char* st, const XT* __restrict__ x, const int8_t* __restrict__ q,
    const ST* __restrict__ s, int M, int K, int N, int g, int m0, int n0,
    int k0, int k_end, bool vec, bool g16) {
  using L = Stage<XT, ST, NT>;
  int8_t* ws = reinterpret_cast<int8_t*>(st);
  XT* xs = reinterpret_cast<XT*>(st + L::kW);
  ST* ss = reinterpret_cast<ST*>(st + L::kW + L::kX);
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int WC = kFastBN / 16;
    for (int i = tid; i < kFastBK * WC; i += kFastThreads) {
      const int r = i / WC, c = (i % WC) * 16;
      const int k = k0 + r, n = n0 + c;
      const bool in = k < k_end && n < N;
      cp_async16(ws + r * kFastBN + swz(r, c), in ? q + (size_t)k * N + n : q, in);
    }
    constexpr int XE = 16 / sizeof(XT), XC = kFastBK / XE;
    for (int i = tid; i < NT * 8 * XC; i += kFastThreads) {
      const int r = i / XC, c = (i % XC) * XE;
      const int m = m0 + r, k = k0 + c;
      const bool in = m < M && k < k_end;
      cp_async16(xs + r * L::kXLd + c, in ? x + (size_t)m * K + k : x, in);
    }
    if (g16) {
      constexpr int SE = 16 / sizeof(ST), SC = kFastBN / SE;
      for (int i = tid; i < kSubs * SC; i += kFastThreads) {
        const int r = i / SC, c = (i % SC) * SE;
        const int k = k0 + r * kSubK, n = n0 + c;
        const bool in = k < k_end && n < N;
        cp_async16(ss + r * kFastBN + c, in ? s + (size_t)(k / g) * N + n : s, in);
      }
    }
  } else {
    for (int i = tid; i < kFastBK * kFastBN; i += kFastThreads) {
      const int r = i / kFastBN, c = i % kFastBN;
      const int k = k0 + r, n = n0 + c;
      ws[r * kFastBN + swz(r, c)] = (k < k_end && n < N) ? q[(size_t)k * N + n] : 0;
    }
    for (int i = tid; i < NT * 8 * kFastBK; i += kFastThreads) {
      const int r = i / kFastBK, c = i % kFastBK;
      const int m = m0 + r, k = k0 + c;
      xs[r * L::kXLd + c] = (m < M && k < k_end) ? x[(size_t)m * K + k] : zero<XT>();
    }
    if (g16) {
      for (int i = tid; i < kSubs * kFastBN; i += kFastThreads) {
        const int r = i / kFastBN, c = i % kFastBN;
        const int k = k0 + r * kSubK, n = n0 + c;
        ss[r * kFastBN + c] = (k < k_end && n < N) ? s[(size_t)(k / g) * N + n] : zero<ST>();
      }
    }
  }
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}
// (a.lo * b.lo, a.hi * b.hi), each rounded once to bf16
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}
// byte i of the sign-flipped word u (q + 128) as the exact fp32 q
__device__ __forceinline__ float q_at(uint32_t u, int i) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) - 8388736.f;
}
// two exact integer-valued floats as bf16x2 (their upper halves)
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
__device__ __forceinline__ float scale_at(const float* __restrict__ s, size_t i) {
  return __ldg(s + i);
}
__device__ __forceinline__ float scale_at(const __nv_bfloat16* __restrict__ s, size_t i) {
  return __bfloat162float(s[i]);
}

// The scales of columns c .. c + 3 from one row of the stage's scale tile,
// each as a bf16 pair (s, s); fp32 scales round to bf16 here.
__device__ __forceinline__ void scale4(const __nv_bfloat16* p, uint32_t (&o)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  o[0] = __byte_perm(v.x, 0, 0x1010);
  o[1] = __byte_perm(v.x, 0, 0x3232);
  o[2] = __byte_perm(v.y, 0, 0x1010);
  o[3] = __byte_perm(v.y, 0, 0x3232);
}
__device__ __forceinline__ void scale4(const float* p, uint32_t (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = pack_rn(v.x, v.x);
  o[1] = pack_rn(v.y, v.y);
  o[2] = pack_rn(v.z, v.z);
  o[3] = pack_rn(v.w, v.w);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// B fragment of x^T: row m, k-rows k .. k + 3 as bf16 pairs (k, k+1), (k+2, k+3)
__device__ __forceinline__ void x_frag(const __nv_bfloat16* p, uint32_t& b0, uint32_t& b1) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  b0 = v.x;
  b1 = v.y;
}
__device__ __forceinline__ void x_frag(const float* p, uint32_t& b0, uint32_t& b1) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  b0 = pack_rn(v.x, v.y);
  b1 = pack_rn(v.z, v.w);
}

// Multiplies one stage into acc. Lane (gr = lane / 4, t = lane % 4) of warp
// w owns block columns c = 32 w + 4 gr .. +3; in each 16-row step it reads
// k-rows 4t .. 4t+3 of them, so its mma k-slots (2t, 2t+1 | 2t+8, 2t+9)
// stand for k-rows (4t, 4t+1 | 4t+2, 4t+3), in A and in B alike. Column
// c + 0 / c + 1 are rows gr / gr + 8 of m16 tile 0, c + 2 / c + 3 those of
// tile 1; n8 tile nt holds x rows 8 nt .. 8 nt + 7.
template <typename XT, typename ST, int NT, int PROBE>
__device__ __forceinline__ void compute_stage(
    const unsigned char* st, float (&acc)[2][NT][4], const ST* __restrict__ s,
    int N, int g, int n0, int k0, int k_end, bool g16) {
  using L = Stage<XT, ST, NT>;
  const int8_t* ws = reinterpret_cast<const int8_t*>(st);
  const XT* xs = reinterpret_cast<const XT*>(st + L::kW);
  const ST* ss = reinterpret_cast<const ST*>(st + L::kW + L::kX);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, t = lane & 3;
  const int col = warp * 32 + 4 * gr;
  // a stage starts at a multiple of kFastBK rows, so with g % kFastBK == 0
  // its four mma steps share one group
  const bool one_group = g % kFastBK == 0;
  uint32_t s4[4];
#pragma unroll
  for (int sub = 0; sub < kSubs; ++sub) {
    const int kb = k0 + sub * kSubK;
    if (kb >= k_end) break;
    uint32_t u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = sub * kSubK + 4 * t + j;
      u[j] = *reinterpret_cast<const uint32_t*>(ws + r * kFastBN + swz(r, col)) ^ 0x80808080u;
    }
    // scales as bf16x2: (rows 4t, 4t+1) and (4t+2, 4t+3) of each column
    uint32_t sc[2][4];
    if (g16) {
      if (sub == 0 || !one_group) scale4(ss + sub * kFastBN + col, s4);
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[0][i] = sc[1][i] = s4[i];
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + col + i;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = kb + 4 * t + j;
          v[j] = (k < k_end && n < N) ? scale_at(s, (size_t)(k / g) * N + n) : 0.f;
        }
        sc[0][i] = pack_rn(v[0], v[1]);
        sc[1][i] = pack_rn(v[2], v[3]);
      }
    }
    uint32_t lo[4], hi[4];
    if constexpr (PROBE == kProbeNoDequant) {  // the packed words, as if bf16
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo[i] = u[i & 1];
        hi[i] = u[2 + (i & 1)];
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo[i] = mul_bf16x2(pack_exact(q_at(u[0], i), q_at(u[1], i)), sc[0][i]);
        hi[i] = mul_bf16x2(pack_exact(q_at(u[2], i), q_at(u[3], i)), sc[1][i]);
      }
    }
    if constexpr (PROBE == kProbeNoMma) {  // the fragments are made, not used
      asm volatile("" :: "r"(lo[0]), "r"(lo[1]), "r"(lo[2]), "r"(lo[3]),
                   "r"(hi[0]), "r"(hi[1]), "r"(hi[2]), "r"(hi[3]));
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b0, b1;
        x_frag(xs + (nt * 8 + gr) * L::kXLd + sub * kSubK + 4 * t, b0, b1);
        mma_bf16(acc[0][nt], lo[0], lo[1], hi[0], hi[1], b0, b1);
        mma_bf16(acc[1][nt], lo[2], lo[3], hi[2], hi[3], b0, b1);
      }
    }
  }
}

// Writes four outputs, row m, columns n .. n + 3 (N % 16 == 0 with vec: the
// four are in or out together).
template <typename XT>
__device__ __forceinline__ void put4(XT* __restrict__ y, int N, int m, int n,
                                     const float (&v)[4], bool vec) {
  XT* p = y + (size_t)m * N + n;
  if (vec) {
    if (n >= N) return;
    if constexpr (sizeof(XT) == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      *reinterpret_cast<uint2*>(p) = make_uint2(pack_rn(v[0], v[1]), pack_rn(v[2], v[3]));
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (n + i < N) store(p + i, v[i]);
  }
}

// Block (blockIdx.x, blockIdx.y, blockIdx.z): weight columns
// [128 blockIdx.x, +128), x rows [8 NT blockIdx.y, +8 NT), K rows
// [blockIdx.z * k_per_split, +k_per_split) (a multiple of kFastBK).
template <typename XT, typename ST, int NT, int PROBE>
__global__ void __launch_bounds__(kFastThreads)
gemm_fast_kernel(const XT* __restrict__ x, const int8_t* __restrict__ q,
                 const ST* __restrict__ s, XT* __restrict__ y,
                 float* __restrict__ partial, int M, int K, int N, int g,
                 int k_per_split, bool vec) {
  using L = Stage<XT, ST, NT>;
  extern __shared__ __align__(128) unsigned char ring[];
  const int n0 = blockIdx.x * kFastBN, m0 = blockIdx.y * NT * 8;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int nk = (k_end - k_begin + kFastBK - 1) / kFastBK;
  const bool g16 = g % kSubK == 0;

  float acc[2][NT][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][nt][e] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nk)
      load_stage<XT, ST, NT>(ring + i * L::kBytes, x, q, s, M, K, N, g, m0, n0,
                             k_begin + i * kFastBK, k_end, vec, g16);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<kStages - 2>();  // stage it has landed
    __syncthreads();               // and every warp is done with stage it - 1
    const int next = it + kStages - 1;
    if (next < nk)
      load_stage<XT, ST, NT>(ring + (next % kStages) * L::kBytes, x, q, s, M, K,
                             N, g, m0, n0, k_begin + next * kFastBK, k_end, vec, g16);
    cp_async_commit();
    compute_stage<XT, ST, NT, PROBE>(ring + (it % kStages) * L::kBytes, acc, s, N, g,
                              n0, k_begin + it * kFastBK, k_end, g16);
  }

  // this thread's outputs: x rows 8 nt + 2t + e, columns n .. n + 3, to y
  // when one split covers K, else to this split's fp32 partial
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = n0 + warp * 32 + 4 * (lane >> 2), t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + nt * 8 + 2 * t + e;
      const float v[4] = {acc[0][nt][e], acc[0][nt][2 + e], acc[1][nt][e],
                          acc[1][nt][2 + e]};
      if (m >= M) continue;
      if (gridDim.z == 1) put4(y, N, m, n, v, vec);
      else put4(partial + (size_t)blockIdx.z * M * N, N, m, n, v, vec);
    }
}

// Sums the K splits' partials [splits, M*N] in split order (deterministic).
// The loads of 8 splits are issued before their sums, so a thread waits for
// memory once per 8 splits, not once per split.
template <typename XT>
__global__ void reduce_splits(const float* __restrict__ partial, XT* __restrict__ y,
                              size_t MN, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float acc = 0.f;
  int sp = 0;
  for (; sp + 8 <= splits; sp += 8) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __ldcg(partial + (size_t)(sp + j) * MN + i);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += v[j];
  }
  for (; sp < splits; ++sp) acc += __ldcg(partial + (size_t)sp * MN + i);
  store(y + i, acc);
}

template <typename XT>
cudaError_t sum_splits(const float* partial, XT* y, int M, int N, int splits,
                       cudaStream_t stream) {
  const size_t MN = (size_t)M * N;
  reduce_splits<XT><<<(unsigned)((MN + 255) / 256), 256, 0, stream>>>(partial, y, MN, splits);
  return cudaGetLastError();
}

template <typename XT, typename ST, int NT, int PROBE = kProbeNone>
cudaError_t launch_fast(const XT* x, const int8_t* q, const ST* s, XT* y, float* partial,
                        int M, int K, int N, int g, int k_per_split, int splits,
                        bool vec, cudaStream_t stream) {
  constexpr int smem = kStages * Stage<XT, ST, NT>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_fast_kernel<XT, ST, NT, PROBE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + kFastBN - 1) / kFastBN, (M + NT * 8 - 1) / (NT * 8), splits);
  gemm_fast_kernel<XT, ST, NT, PROBE><<<grid, kFastThreads, smem, stream>>>(
      x, q, s, y, partial, M, K, N, g, k_per_split, vec);
  return cudaGetLastError();
}

template <typename XT, typename ST>
cudaError_t launch(const void* x, const void* q, const void* s, void* y,
                   void* partial, int M, int K, int N, int g, int exact,
                   int k_per_split, int vec_ok, cudaStream_t stream) {
  const XT* xp = static_cast<const XT*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const ST* sp = static_cast<const ST*>(s);
  XT* yp = static_cast<XT*>(y);
  float* pp = static_cast<float*>(partial);
  const int splits = (K + k_per_split - 1) / k_per_split;
  const bool direct = splits == 1;
  cudaError_t err;
  if (!exact) {
    if (k_per_split % kFastBK) return cudaErrorInvalidValue;
    const bool vec = vec_ok && K % 8 == 0 && N % 16 == 0;
    if (M <= 8)
      err = launch_fast<XT, ST, 1>(xp, qp, sp, yp, pp, M, K, N, g, k_per_split, splits, vec, stream);
    else if (M <= 16)
      err = launch_fast<XT, ST, 2>(xp, qp, sp, yp, pp, M, K, N, g, k_per_split, splits, vec, stream);
    else if (M <= 32)
      err = launch_fast<XT, ST, 4>(xp, qp, sp, yp, pp, M, K, N, g, k_per_split, splits, vec, stream);
    else
      err = launch_fast<XT, ST, 8>(xp, qp, sp, yp, pp, M, K, N, g, k_per_split, splits, vec, stream);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
    const bool vec = vec_ok && K % kVec == 0 && N % kVec == 0;
    if (direct)
      gemm_exact_kernel<XT, ST, true><<<grid, kThreads, 0, stream>>>(xp, qp, sp, yp, pp, M, K, N, g, k_per_split, vec);
    else
      gemm_exact_kernel<XT, ST, false><<<grid, kThreads, 0, stream>>>(xp, qp, sp, yp, pp, M, K, N, g, k_per_split, vec);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || direct) return err;
  return sum_splits(pp, yp, M, N, splits, stream);
}

// ---------------------------------------------------------------------------
// Fast mode on Hopper's path: TMA, an mbarrier ring and wgmma (M <= 256)

constexpr int kTmaBN = 128;          // weight columns per block: two consumer warpgroups x 64
constexpr int kTmaBK = 64;           // K rows per ring stage
constexpr int kTmaThreads = 384;     // warpgroup 0 produces, warpgroups 1 and 2 consume
constexpr int kTmaMaxStages = 16;
constexpr int kTmaQBytes = kTmaBK * kTmaBN;  // the int8 tile: 64 k-rows x 128 bytes
constexpr int kTmaSmemMax = 232448;  // the most dynamic shared memory a block may opt in to
constexpr int kTmaSmemAlign = 1024;  // a 128-byte-swizzled tile starts on a 1024-byte line
constexpr int kTmaStaticBytes = 2 * kTmaMaxStages * 8;  // the full and empty barriers
// a stuck ring traps after this many polls (one waits a few us on the H100)
constexpr uint32_t kSpinLimit = 1u << 22;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// Waits until the barrier's phase of this parity has completed; traps
// rather than hang once kSpinLimit polls have failed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins == kSpinLimit) __trap();
  }
}
// One box of a 2-D tensor map into shared memory; the copy's bytes count
// against the barrier's expected transaction bytes.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// Four 8 x 8 b16 matrices, transposed: lane (gr, t) gets, of matrix i,
// rows 2t and 2t + 1 of column gr in register i (row 2t in the low half).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// The shared-memory descriptor of a K-major bf16 operand whose rows are
// 128 bytes (64 k) with the 128-byte swizzle that the TMA box wrote: 8-row
// groups 1024 bytes apart (SBO), swizzle mode 1 in bits 62-63. Moving 16
// k (32 bytes) along a row adds 2 to the start address field.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// wgmma m64nNk16, bf16 in, fp32 accumulate, A (64 weight columns x 16 k)
// from registers, B (16 k x N x rows) from shared memory through its
// descriptor; the accumulator piece is d[O .. O + N/2). Generated: one per
// piece width N in {8, 16, 32, 64, 128, 256}.

template <int O, int R>
__device__ __forceinline__ void wgmma_n8(float (&d)[R], const uint32_t (&a)[4], uint64_t b) {
  static_assert(O + 4 <= R, "piece outside the accumulator");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int O, int R>
__device__ __forceinline__ void wgmma_n16(float (&d)[R], const uint32_t (&a)[4], uint64_t b) {
  static_assert(O + 8 <= R, "piece outside the accumulator");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]), "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int O, int R>
__device__ __forceinline__ void wgmma_n32(float (&d)[R], const uint32_t (&a)[4], uint64_t b) {
  static_assert(O + 16 <= R, "piece outside the accumulator");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]), "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),
        "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]), "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int O, int R>
__device__ __forceinline__ void wgmma_n64(float (&d)[R], const uint32_t (&a)[4], uint64_t b) {
  static_assert(O + 32 <= R, "piece outside the accumulator");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]), "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),
        "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]), "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15]),
        "+f"(d[O + 16]), "+f"(d[O + 17]), "+f"(d[O + 18]), "+f"(d[O + 19]), "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]),
        "+f"(d[O + 24]), "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]), "+f"(d[O + 28]), "+f"(d[O + 29]), "+f"(d[O + 30]), "+f"(d[O + 31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int O, int R>
__device__ __forceinline__ void wgmma_n128(float (&d)[R], const uint32_t (&a)[4], uint64_t b) {
  static_assert(O + 64 <= R, "piece outside the accumulator");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]), "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),
        "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]), "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15]),
        "+f"(d[O + 16]), "+f"(d[O + 17]), "+f"(d[O + 18]), "+f"(d[O + 19]), "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]),
        "+f"(d[O + 24]), "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]), "+f"(d[O + 28]), "+f"(d[O + 29]), "+f"(d[O + 30]), "+f"(d[O + 31]),
        "+f"(d[O + 32]), "+f"(d[O + 33]), "+f"(d[O + 34]), "+f"(d[O + 35]), "+f"(d[O + 36]), "+f"(d[O + 37]), "+f"(d[O + 38]), "+f"(d[O + 39]),
        "+f"(d[O + 40]), "+f"(d[O + 41]), "+f"(d[O + 42]), "+f"(d[O + 43]), "+f"(d[O + 44]), "+f"(d[O + 45]), "+f"(d[O + 46]), "+f"(d[O + 47]),
        "+f"(d[O + 48]), "+f"(d[O + 49]), "+f"(d[O + 50]), "+f"(d[O + 51]), "+f"(d[O + 52]), "+f"(d[O + 53]), "+f"(d[O + 54]), "+f"(d[O + 55]),
        "+f"(d[O + 56]), "+f"(d[O + 57]), "+f"(d[O + 58]), "+f"(d[O + 59]), "+f"(d[O + 60]), "+f"(d[O + 61]), "+f"(d[O + 62]), "+f"(d[O + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int O, int R>
__device__ __forceinline__ void wgmma_n256(float (&d)[R], const uint32_t (&a)[4], uint64_t b) {
  static_assert(O + 128 <= R, "piece outside the accumulator");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]), "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),
        "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]), "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15]),
        "+f"(d[O + 16]), "+f"(d[O + 17]), "+f"(d[O + 18]), "+f"(d[O + 19]), "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]),
        "+f"(d[O + 24]), "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]), "+f"(d[O + 28]), "+f"(d[O + 29]), "+f"(d[O + 30]), "+f"(d[O + 31]),
        "+f"(d[O + 32]), "+f"(d[O + 33]), "+f"(d[O + 34]), "+f"(d[O + 35]), "+f"(d[O + 36]), "+f"(d[O + 37]), "+f"(d[O + 38]), "+f"(d[O + 39]),
        "+f"(d[O + 40]), "+f"(d[O + 41]), "+f"(d[O + 42]), "+f"(d[O + 43]), "+f"(d[O + 44]), "+f"(d[O + 45]), "+f"(d[O + 46]), "+f"(d[O + 47]),
        "+f"(d[O + 48]), "+f"(d[O + 49]), "+f"(d[O + 50]), "+f"(d[O + 51]), "+f"(d[O + 52]), "+f"(d[O + 53]), "+f"(d[O + 54]), "+f"(d[O + 55]),
        "+f"(d[O + 56]), "+f"(d[O + 57]), "+f"(d[O + 58]), "+f"(d[O + 59]), "+f"(d[O + 60]), "+f"(d[O + 61]), "+f"(d[O + 62]), "+f"(d[O + 63]),
        "+f"(d[O + 64]), "+f"(d[O + 65]), "+f"(d[O + 66]), "+f"(d[O + 67]), "+f"(d[O + 68]), "+f"(d[O + 69]), "+f"(d[O + 70]), "+f"(d[O + 71]),
        "+f"(d[O + 72]), "+f"(d[O + 73]), "+f"(d[O + 74]), "+f"(d[O + 75]), "+f"(d[O + 76]), "+f"(d[O + 77]), "+f"(d[O + 78]), "+f"(d[O + 79]),
        "+f"(d[O + 80]), "+f"(d[O + 81]), "+f"(d[O + 82]), "+f"(d[O + 83]), "+f"(d[O + 84]), "+f"(d[O + 85]), "+f"(d[O + 86]), "+f"(d[O + 87]),
        "+f"(d[O + 88]), "+f"(d[O + 89]), "+f"(d[O + 90]), "+f"(d[O + 91]), "+f"(d[O + 92]), "+f"(d[O + 93]), "+f"(d[O + 94]), "+f"(d[O + 95]),
        "+f"(d[O + 96]), "+f"(d[O + 97]), "+f"(d[O + 98]), "+f"(d[O + 99]), "+f"(d[O + 100]), "+f"(d[O + 101]), "+f"(d[O + 102]), "+f"(d[O + 103]),
        "+f"(d[O + 104]), "+f"(d[O + 105]), "+f"(d[O + 106]), "+f"(d[O + 107]), "+f"(d[O + 108]), "+f"(d[O + 109]), "+f"(d[O + 110]), "+f"(d[O + 111]),
        "+f"(d[O + 112]), "+f"(d[O + 113]), "+f"(d[O + 114]), "+f"(d[O + 115]), "+f"(d[O + 116]), "+f"(d[O + 117]), "+f"(d[O + 118]), "+f"(d[O + 119]),
        "+f"(d[O + 120]), "+f"(d[O + 121]), "+f"(d[O + 122]), "+f"(d[O + 123]), "+f"(d[O + 124]), "+f"(d[O + 125]), "+f"(d[O + 126]), "+f"(d[O + 127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The 16-k step's product for NW x rows (a multiple of 8, at most 256): one
// wgmma per set bit of NW / 8, the widest first, at x row and accumulator
// offsets that follow one another (O registers, O * 2 rows before it), so
// that the accumulator holds m64nNWk16's own layout. Every wgmma is
// unconditional: a runtime choice among them makes ptxas serialize them.
template <int NW, int P = 256, int O = 0>
__device__ __forceinline__ void wgmma_rows(float (&d)[NW / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (P >= 8) {
    if constexpr ((NW & P) != 0) {
      if constexpr (P == 256) wgmma_n256<O>(d, a, b);
      else if constexpr (P == 128) wgmma_n128<O>(d, a, b);
      else if constexpr (P == 64) wgmma_n64<O>(d, a, b);
      else if constexpr (P == 32) wgmma_n32<O>(d, a, b);
      else if constexpr (P == 16) wgmma_n16<O>(d, a, b);
      else wgmma_n8<O>(d, a, b);
      wgmma_rows<NW, P / 2, O + P / 2>(d, a, b + P * 128 / 16);  // the next piece's x rows
    } else {
      wgmma_rows<NW, P / 2, O>(d, a, b);
    }
  }
}

// The A fragment of one 16-k step from two ldmatrix words: lo holds k-rows
// (2t, 2t + 1), hi (2t + 8, 2t + 9), each as bytes (col, col + 1) of the
// first row, then of the second. A rows gr and gr + 8 are block columns col
// and col + 1; the dequant is the mma.sync kernel's (q_at, pack_exact,
// mul_bf16x2), so w = bf16(bf16(q) * bf16(s)) bit for bit.
__device__ __forceinline__ void dequant_frag(uint32_t lo, uint32_t hi, uint32_t sa, uint32_t sb,
                                             uint32_t (&a)[4]) {
  lo ^= 0x80808080u;
  hi ^= 0x80808080u;
  a[0] = mul_bf16x2(pack_exact(q_at(lo, 0), q_at(lo, 2)), sa);
  a[1] = mul_bf16x2(pack_exact(q_at(lo, 1), q_at(lo, 3)), sb);
  a[2] = mul_bf16x2(pack_exact(q_at(hi, 0), q_at(hi, 2)), sa);
  a[3] = mul_bf16x2(pack_exact(q_at(hi, 1), q_at(hi, 3)), sb);
}
// The scales of columns col and col + 1 from a staged scale row, each as a
// bf16 pair (s, s); fp32 scales round to bf16 here.
__device__ __forceinline__ void scale_pair(const unsigned char* row, int col, int s_bf16,
                                           uint32_t& sa, uint32_t& sb) {
  if (s_bf16) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(row + 2 * col);
    sa = __byte_perm(v, 0, 0x1010);
    sb = __byte_perm(v, 0, 0x3232);
  } else {
    const float2 v = *reinterpret_cast<const float2*>(row + 4 * col);
    sa = pack_rn(v.x, v.x);
    sb = pack_rn(v.y, v.y);
  }
}

// Where a consumer thread writes: columns n, n + 1 of x rows 2t (+ 8j, + 1).
struct TmaOut {
  void* y;
  float* partial;
  int M, N, n, t;
  bool direct, y_bf16;
  __device__ __forceinline__ void put2(int m, float v0, float v1) const {
    if (m >= M || n >= N) return;
    const size_t i = (size_t)m * N + n;
    if (!direct)
      *reinterpret_cast<float2*>(partial + (size_t)blockIdx.y * M * N + i) = make_float2(v0, v1);
    else if (y_bf16)
      *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(y) + i) = pack_rn(v0, v1);
    else
      *reinterpret_cast<float2*>(static_cast<float*>(y) + i) = make_float2(v0, v1);
  }
};
// setmaxnreg: the producer warpgroup drops to kProducerRegs, the consumers
// rise to kConsumerRegs (with MINB blocks an SM, 65536 / MINB registers a block).
template <int MINB> constexpr int kProducerRegs = MINB == 1 ? 40 : 24;
template <int MINB> constexpr int kConsumerRegs = MINB == 1 ? 232 : 104;

// What a consumer thread needs of the ring: its base, stage geometry, the
// thread's first column (A row gr; col + 1 is A row gr + 8) and its
// ldmatrix row address within a 32-row half.
struct TmaStage {
  uint32_t ring;
  const unsigned char* ring_p;
  int stage_bytes, stages, x_off, s_off, g, s_bf16, col;
  uint32_t lane_row;
};

// Half H of a ring stage (k-rows 32 H .. 32 H + 31, two 16-k steps) for a
// consumer warp: its int8 words (one ldmatrix.x4.trans) and scales,
// dequantized into the A set a, and the two steps' wgmmas issued as one group.
template <int NW, int H>
__device__ __forceinline__ void consume_half(float (&acc)[NW / 2], uint32_t (&a)[2][4],
                                             uint32_t base, const unsigned char* srow,
                                             const TmaStage& s) {
  uint32_t u[4], sa = 0, sb = 0;
  ldsm_x4_trans(base + H * 32 * 128 + s.lane_row, u);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int sub = 2 * H + h;
    if (h == 0 || s.g < kTmaBK)
      scale_pair(srow + (s.g < kTmaBK ? sub * 16 / s.g : 0) * kTmaBN * (s.s_bf16 ? 2 : 4), s.col,
                 s.s_bf16, sa, sb);
    dequant_frag(u[2 * h], u[2 * h + 1], sa, sb, a[h]);
  }
  const uint64_t bx = desc_sw128(base + s.x_off);
  wg_fence();
#pragma unroll
  for (int h = 0; h < 2; ++h) wgmma_rows<NW>(acc, a[h], bx + 2 * (2 * H + h));
  wg_commit();
}

// The consumer warpgroups' part of gemm_tma_kernel: per ring stage two
// groups, each overlapping the group before (two A sets); a warp arrives on
// a stage's empty barrier once its last group has completed.
template <int NW, int MINB>
__device__ __forceinline__ void consume(const uint64_t* full, uint64_t* empty, uint32_t ring,
                                        const unsigned char* ring_p, void* __restrict__ y,
                                        float* __restrict__ partial, int M, int N, int g, int nk,
                                        int stages, int stage_bytes, int x_off, int s_off,
                                        int s_bf16, int y_bf16, int n0) {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs<MINB>));
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int chunk = 4 * (threadIdx.x / 128 - 1) + warp;  // the warp's 16 columns
  // ldmatrix: lane L gives row L of a 32-row half, at its chunk's swizzled place
  const TmaStage s{ring, ring_p, stage_bytes, stages, x_off, s_off, g, s_bf16,
                   16 * chunk + 2 * (lane >> 2), lane * 128 + ((chunk ^ (lane & 7)) << 4)};
  float acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
  uint32_t a0[2][4], a1[2][4];
  for (int it = 0; it < nk; ++it) {
    const int st = it % stages;
    mbar_wait(smem_u32(&full[st]), (it / stages) & 1);
    const uint32_t base = ring + st * stage_bytes;
    const unsigned char* srow = ring_p + st * stage_bytes + s_off;
    consume_half<NW, 0>(acc, a0, base, srow, s);
    wg_wait<1>();  // the previous stage's last group is done: a1 and its smem are free
    if (it > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(it - 1) % stages]));
    consume_half<NW, 1>(acc, a1, base, srow, s);
    wg_wait<1>();  // this stage's first group is done: a0 is free
  }
  wg_wait<0>();
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) asm volatile("" : "+f"(acc[i]) :: "memory");

  // register 4 j + e: x row 8 j + 2t + e of column col, 4 j + 2 + e of col + 1
  const TmaOut o{y, partial, M, N, n0 + s.col, lane & 3, gridDim.y == 1, y_bf16 != 0};
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) o.put2(8 * j + 2 * o.t + e, acc[4 * j + e], acc[4 * j + 2 + e]);
}

// Block (blockIdx.x, blockIdx.y): weight columns [128 blockIdx.x, +128) of
// every x row, K rows [blockIdx.y * k_per_split, +k_per_split), for M of
// NW - 7 .. NW rows. Warpgroup 0 is the producer: one thread keeps the ring
// full with three TMA boxes a stage (int8 tile 64 x 128 with the 128-byte
// swizzle, x's 64 k of NW rows with the same swizzle, the stage's s_rows
// scale rows) behind the stage's full barrier. Warpgroups 1 and 2 own 64
// columns each (consume). MINB blocks share an SM; setmaxnreg moves the
// producer warpgroup's registers to the consumers.
template <int NW, int MINB>
__global__ void __launch_bounds__(kTmaThreads, MINB)
gemm_tma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap ts, void* __restrict__ y,
                float* __restrict__ partial, int M, int K, int N, int g, int k_per_split,
                int stages, int stage_bytes, int s_rows, int s_bf16, int y_bf16) {
  __shared__ __align__(8) uint64_t full[kTmaMaxStages], empty[kTmaMaxStages];
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + kTmaSmemAlign - 1) & ~uint32_t(kTmaSmemAlign - 1);
  const int n0 = blockIdx.x * kTmaBN;
  const int k_begin = blockIdx.y * k_per_split;
  const int nk = (min(K, k_begin + k_per_split) - k_begin + kTmaBK - 1) / kTmaBK;
  const int x_off = kTmaQBytes, s_off = kTmaQBytes + NW * 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(smem_u32(&full[i]), 1);   // the producer's expect_tx arrival
      mbar_init(smem_u32(&empty[i]), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs<MINB>));
    if (threadIdx.x == 0) {
      const uint32_t tx_bytes = kTmaQBytes + NW * 128 + s_rows * kTmaBN * (s_bf16 ? 2 : 4);
      for (int it = 0; it < nk; ++it) {
        const int st = it % stages;
        mbar_wait(smem_u32(&empty[st]), ((it / stages) & 1) ^ 1);
        const uint32_t bar = smem_u32(&full[st]), base = ring + st * stage_bytes;
        const int k0 = k_begin + it * kTmaBK;
        mbar_expect_tx(bar, tx_bytes);
        tma_load_2d(base, &tq, bar, n0, k0);
        tma_load_2d(base + x_off, &tx, bar, k0, 0);
        tma_load_2d(base + s_off, &ts, bar, n0, k0 / g);
      }
    }
  } else {  // consumer warpgroups: the two roles never meet again
    consume<NW, MINB>(full, empty, ring, smem_raw + (ring - raw), y, partial, M, N, g, nk,
                      stages, stage_bytes, x_off, s_off, s_bf16, y_bf16, n0);
  }
}

// The TMA route's geometry for one call, host side: wgmma's N (M rounded
// up to 8), two blocks an SM up to N = 64, the ring as deep as their shared
// memory allows (at most kTmaMaxStages, at most the split's stages).
struct TmaPlan {
  int nw, s_rows, stage_bytes, stages, minb, smem;
};

TmaPlan tma_plan(int M, int K, int g, int s_bf16, int k_per_split) {
  TmaPlan p;
  p.nw = (M + 7) / 8 * 8;
  p.s_rows = g >= kTmaBK ? 1 : kTmaBK / g;
  const int bytes = kTmaQBytes + p.nw * 128 + p.s_rows * kTmaBN * (s_bf16 ? 2 : 4);
  p.stage_bytes = (bytes + kTmaSmemAlign - 1) / kTmaSmemAlign * kTmaSmemAlign;
  p.minb = p.nw <= 64 ? 2 : 1;
  // two blocks an SM split its 228 KB, each less the 1 KB the system keeps
  const int budget = (p.minb == 1 ? kTmaSmemMax : 112 * 1024) - kTmaStaticBytes - kTmaSmemAlign;
  const int nk = (std::min(K, k_per_split) + kTmaBK - 1) / kTmaBK;
  p.stages = std::max(1, std::min({kTmaMaxStages, budget / p.stage_bytes, nk}));
  p.smem = kTmaSmemAlign + p.stages * p.stage_bytes;
  return p;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the CUDA runtime's entry-point
// query, so the library needs no -lcuda.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A row-major [outer, inner] tensor (row stride row_bytes) read in boxes of
// [box_outer, box_inner]; reads past its edges fill zeros.
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, uint64_t inner,
               uint64_t outer, uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer,
               CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The kernel starts with the registers its launch bounds allow; an
// increase the producer's decrease does not cover would block, so a build
// that starts with fewer is refused before it launches.
template <int NW, int MINB>
cudaError_t setmaxnreg_fits() {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, gemm_tma_kernel<NW, MINB>);
  if (err != cudaSuccess) return err;
  const int freed = 128 * (a.numRegs - kProducerRegs<MINB>);
  const int taken = 256 * (kConsumerRegs<MINB> - a.numRegs);
  return freed >= taken && a.numRegs * kTmaThreads * MINB <= 65536
             ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <int NW>
constexpr int kTmaMinBlocks = NW <= 64 ? 2 : 1;

// The maps, the output and the call's shape, as every kernel takes them.
struct TmaCall {
  const CUtensorMap *tq, *tx, *ts;
  void* y;
  float* partial;
  int M, K, N, g, k_per_split, splits, s_bf16, y_bf16;
  TmaPlan p;
  cudaStream_t stream;
};

template <int NW>
cudaError_t launch_tma(const TmaCall& c) {
  constexpr int MINB = kTmaMinBlocks<NW>;
  // the most shared memory, and all of the SM's for it, so MINB blocks fit
  static const cudaError_t attr = [] {
    const cudaError_t fits = setmaxnreg_fits<NW, MINB>();
    if (fits != cudaSuccess) return fits;
    const cudaError_t e = cudaFuncSetAttribute(gemm_tma_kernel<NW, MINB>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kTmaSmemMax - kTmaStaticBytes);
    return e != cudaSuccess ? e
                            : cudaFuncSetAttribute(gemm_tma_kernel<NW, MINB>,
                                                   cudaFuncAttributePreferredSharedMemoryCarveout,
                                                   cudaSharedmemCarveoutMaxShared);
  }();
  if (attr != cudaSuccess) return attr;
  const dim3 grid((c.N + kTmaBN - 1) / kTmaBN, c.splits);
  gemm_tma_kernel<NW, MINB><<<grid, kTmaThreads, c.p.smem, c.stream>>>(
      *c.tq, *c.tx, *c.ts, c.y, c.partial, c.M, c.K, c.N, c.g, c.k_per_split, c.p.stages,
      c.p.stage_bytes, c.p.s_rows, c.s_bf16, c.y_bf16);
  return cudaGetLastError();
}

template <int NW>
cudaError_t tma_attributes(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, gemm_tma_kernel<NW, kTmaMinBlocks<NW>>);
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return err;
}

// The kernel for nw rows (8, 16, .., 256), one instantiation each.
template <int... I>
cudaError_t launch_tma_rows(const TmaCall& c, std::integer_sequence<int, I...>) {
  cudaError_t err = cudaErrorInvalidValue;
  ((c.p.nw == 8 * (I + 1) ? (err = launch_tma<8 * (I + 1)>(c), true) : false) || ...);
  return err;
}
template <int... I>
cudaError_t tma_attributes_rows(int nw, int* regs, int* local_bytes,
                                std::integer_sequence<int, I...>) {
  cudaError_t err = cudaErrorInvalidValue;
  ((nw == 8 * (I + 1) ? (err = tma_attributes<8 * (I + 1)>(regs, local_bytes), true) : false) ||
   ...);
  return err;
}
using TmaRows = std::make_integer_sequence<int, 32>;

}  // namespace

// x [M, K] (fp32 or bf16) row-major, q [K, N] int8 row-major, s [>= K/g, N]
// (fp32 or bf16, row stride N), y [M, N] in x's dtype. exact selects the
// fp32 dequant. k_per_split (a multiple of 64 in fast mode, of 32 in exact)
// splits K across blocks; partial is fp32 scratch
// [ceil(K / k_per_split), M, N], unused when one split covers K. vec: x, q
// and s are 16-byte aligned (the kernels add their K and N conditions).
// Returns the launch's cudaError_t.
extern "C" int quant_gemm(const void* x, int x_bf16, const void* q, const void* s,
                          int s_bf16, void* y, void* partial, int M, int K, int N,
                          int group_size, int exact, int k_per_split, int vec,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = group_size, kps = k_per_split;
  cudaError_t err;
  if (x_bf16) {
    err = s_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, q, s, y, partial, M, K, N, g, exact, kps, vec, st)
                 : launch<__nv_bfloat16, float>(x, q, s, y, partial, M, K, N, g, exact, kps, vec, st);
  } else {
    err = s_bf16 ? launch<float, __nv_bfloat16>(x, q, s, y, partial, M, K, N, g, exact, kps, vec, st)
                 : launch<float, float>(x, q, s, y, partial, M, K, N, g, exact, kps, vec, st);
  }
  return static_cast<int>(err);
}

// The TMA route: x [M, K] bf16, q [K, N] int8, s [>= K/g, N] (fp32 or bf16),
// all 16-byte aligned, with M <= 256, N % 16 == 0, K % 8 == 0, g % 16 == 0
// and g dividing 64 or 64 dividing g (ops/kernels/quant_matmul.py
// `takes_wgmma`). y [M, N] is bf16 (y_bf16) or fp32; partial is fp32 scratch
// [ceil(K / k_per_split), M, N] (k_per_split a multiple of 64), unused when
// one split covers K. The tensor maps are encoded here, per call, from the
// pointers given, and reach the kernel by value. Returns the launch's
// cudaError_t (cudaErrorInvalidValue for a shape the route does not take or
// a map cuTensorMapEncodeTiled refuses).
extern "C" int quant_gemm_tma(const void* x, const void* q, const void* s, int s_bf16, void* y,
                              int y_bf16, void* partial, int M, int K, int N, int group_size,
                              int k_per_split, void* stream) {
  const int g = group_size;
  const bool g_ok = g % 16 == 0 && (kTmaBK % g == 0 || g % kTmaBK == 0);
  if (M < 1 || M > 256 || N % 16 || K % 8 || !g_ok || K % g || k_per_split % kTmaBK)
    return cudaErrorInvalidValue;
  const TmaPlan p = tma_plan(M, K, g, s_bf16, k_per_split);
  CUtensorMap tq, tx, ts;
  const bool ok =
      encode_2d(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, K, N, kTmaBN, kTmaBK,
                CU_TENSOR_MAP_SWIZZLE_128B) &&
      encode_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, (uint64_t)K * 2, kTmaBK, p.nw,
                CU_TENSOR_MAP_SWIZZLE_128B) &&
      encode_2d(&ts, s_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                s, N, K / g, (uint64_t)N * (s_bf16 ? 2 : 4), kTmaBN, p.s_rows,
                CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return cudaErrorInvalidValue;
  const int splits = (K + k_per_split - 1) / k_per_split;
  float* pp = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const TmaCall c{&tq, &tx, &ts, y, pp, M, K, N, g, k_per_split, splits, s_bf16, y_bf16, p, st};
  const cudaError_t err = launch_tma_rows(c, TmaRows{});
  if (err != cudaSuccess || splits == 1) return err;
  return y_bf16 ? sum_splits(pp, static_cast<__nv_bfloat16*>(y), M, N, splits, st)
                : sum_splits(pp, static_cast<float*>(y), M, N, splits, st);
}

// The TMA route's geometry for a call (see tma_plan): out = {rows (wgmma's
// N), stages, stage bytes, blocks per SM, dynamic shared bytes}.
extern "C" int quant_gemm_tma_plan(int M, int K, int group_size, int s_bf16, int k_per_split,
                                   int* out) {
  const TmaPlan p = tma_plan(M, K, group_size, s_bf16, k_per_split);
  const int v[5] = {p.nw, p.stages, p.stage_bytes, p.minb, p.smem};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}

// Registers a thread and local (spilled) bytes of the TMA kernel for
// `rows` x rows (wgmma's N, a multiple of 8 up to 256), as the compiler
// left them.
extern "C" int quant_gemm_tma_attributes(int rows, int* regs, int* local_bytes) {
  return tma_attributes_rows(rows, regs, local_bytes, TmaRows{});
}
// The fast kernel's tool-only variants (kProbeNoDequant = 1, kProbeNoMma =
// 2) on bf16 x and bf16 scales, 16-byte aligned, K % 8 == 0 and N % 16 == 0,
// with quant_gemm's split and block rows; the values are wrong.
extern "C" int quant_gemm_probe(const void* x, const void* q, const void* s, void* y,
                                void* partial, int M, int K, int N, int group_size,
                                int k_per_split, int probe, void* stream) {
  using B = __nv_bfloat16;
  if ((probe != kProbeNoDequant && probe != kProbeNoMma) || k_per_split % kFastBK ||
      K % 8 || N % 16)
    return cudaErrorInvalidValue;
  const B* xp = static_cast<const B*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const B* sp = static_cast<const B*>(s);
  B* yp = static_cast<B*>(y);
  float* pp = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = group_size, kps = k_per_split, splits = (K + kps - 1) / kps;
  cudaError_t err;
#define PROBE_LAUNCH(NT)                                                                   \
  (probe == kProbeNoDequant                                                                \
       ? launch_fast<B, B, NT, kProbeNoDequant>(xp, qp, sp, yp, pp, M, K, N, g, kps,       \
                                                 splits, true, st)                          \
       : launch_fast<B, B, NT, kProbeNoMma>(xp, qp, sp, yp, pp, M, K, N, g, kps, splits,   \
                                             true, st))
  if (M <= 8) err = PROBE_LAUNCH(1);
  else if (M <= 16) err = PROBE_LAUNCH(2);
  else if (M <= 32) err = PROBE_LAUNCH(4);
  else err = PROBE_LAUNCH(8);
#undef PROBE_LAUNCH
  if (err != cudaSuccess || splits == 1) return err;
  return sum_splits(pp, yp, M, N, splits, st);
}
