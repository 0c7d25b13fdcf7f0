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
// mantissas), so the kernel differs from the TPU only in summation order.
//
// What bounds it on this card: bytes, up to M of about 150 at the Llama-2-7B
// shapes (q is read once, one byte per M multiply-adds, and the card does
// about 295 bf16 operations per byte it reads), then the bf16 tensor-core
// rate. Fast mode (every main path) is built for that byte stream:
//   * a 4-stage ring in shared memory, filled with cp.async 16 bytes a
//     thread: each stage is a 64 x 128 int8 weight tile (8 KB), its x rows
//     and one scale row per 16 k-rows, so a block keeps 24 KB of weight in
//     flight and the grid several blocks per SM;
//   * scales staged once per 16 k-rows and column, not loaded per element;
//   * dequant in packed bf16x2 arithmetic: int8 becomes an exact fp32 by a
//     byte permute into 2^23 + (q + 128) and one subtraction, two such
//     values pack into bf16x2 by a byte permute (exact: |q| <= 128 fits
//     bf16's significand), and one fma.rn.bf16x2 with a -0 addend multiplies
//     by (bf16(s), bf16(s)) with a single rounding. That equals
//     round_bf16(q * round_bf16(s)), since the product of two 8-bit
//     significands is exact in fp32. exp_int8's `plain8` mode, which
//     rounds per element in fp32 as the first version of this kernel did,
//     streams at half the rate of its bf16 mode;
//   * tensor cores through mma.sync m16n8k16 (bf16 in, fp32 accumulate) with
//     the roles swapped: the weight is the 16-row A operand (its columns
//     fill the wide side) and x^T the n8 B operand, so M = 8 (the engine)
//     is one n8 tile with no padding and the block's M tile (8, 16, 32 or
//     64 rows) is the smallest that covers M. Each thread reads four 4-byte
//     words of the int8 tile (4 k-rows x 4 columns), transposes them by
//     byte permutes and so holds its A fragments of two m16 tiles; the k
//     order inside a 16-row step is permuted the same way for A and B, which
//     leaves the sum unchanged. An XOR swizzle of the tile's 32-byte column
//     blocks by k-row keeps those reads free of bank conflicts;
//   * split K from the SM count: the plan (ops/kernels/quant_matmul.py
//     gemm_k_per_split) gives the grid about three blocks per SM, and the
//     splits write fp32 partials that a second pass sums in a fixed order
//     (no atomics, so results repeat bit for bit).
// Exact mode is on no main path (only tests ask for it) and keeps the first
// version's body: 64 x 64 output tiles, fp32 FMA on the CUDA cores. M, N and
// K edges are masked in both modes; scale rows past K / g are never read.
// Operands that are not 16-byte aligned, or K % 8 or N % 16 not 0, take
// scalar loads into the same ring.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
template <typename XT, typename ST, int NT>
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
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lo[i] = mul_bf16x2(pack_exact(q_at(u[0], i), q_at(u[1], i)), sc[0][i]);
      hi[i] = mul_bf16x2(pack_exact(q_at(u[2], i), q_at(u[3], i)), sc[1][i]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t b0, b1;
      x_frag(xs + (nt * 8 + gr) * L::kXLd + sub * kSubK + 4 * t, b0, b1);
      mma_bf16(acc[0][nt], lo[0], lo[1], hi[0], hi[1], b0, b1);
      mma_bf16(acc[1][nt], lo[2], lo[3], hi[2], hi[3], b0, b1);
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
template <typename XT, typename ST, int NT>
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
    compute_stage<XT, ST, NT>(ring + (it % kStages) * L::kBytes, acc, s, N, g,
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

template <typename XT, typename ST, int NT>
cudaError_t launch_fast(const XT* x, const int8_t* q, const ST* s, XT* y, float* partial,
                        int M, int K, int N, int g, int k_per_split, int splits,
                        bool vec, cudaStream_t stream) {
  constexpr int smem = kStages * Stage<XT, ST, NT>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_fast_kernel<XT, ST, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + kFastBN - 1) / kFastBN, (M + NT * 8 - 1) / (NT * 8), splits);
  gemm_fast_kernel<XT, ST, NT><<<grid, kFastThreads, smem, stream>>>(
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
  const size_t MN = (size_t)M * N;
  reduce_splits<XT><<<(unsigned)((MN + 255) / 256), 256, 0, stream>>>(pp, yp, MN, splits);
  return cudaGetLastError();
}

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
