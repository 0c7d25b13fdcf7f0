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
// What bounds it on this card: at the main path's M = 32 prefill, bytes
// (q is read once, one byte per 32 multiply-adds); towards M = 255 in fast
// mode, operations (989 TFLOP/s of bf16 tensor-core rate). This version is
// simple and reaches neither. Both modes use 64 x 64 output tiles and a K
// loop in steps of 32 rows that dequantizes the weight tile into shared
// memory in the mode's rounding (each row k takes the scale of its group
// k / g). Fast mode multiplies the bf16 tiles on the tensor cores (WMMA
// 16 x 16 x 16, fp32 accumulation; 8 warps, each a 16 x 32 slab); exact
// mode has no fp32 tensor-core product, so it runs fp32 FMA on the CUDA
// cores, 4 x 4 outputs per thread. Against the latency of the K loop both
// start the next tile's global loads into registers before the current
// tile is multiplied, and split K across blockIdx.z when the output tiles
// alone would leave SMs idle; the splits write fp32 partials that a second
// pass sums in a fixed order (no atomics, so results repeat bit for bit).
// TMA, a shared-memory ring and `wgmma` are the next steps. M, N and K
// edges are masked; scale rows past K / g are never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;  // exact: 16 x 16 threads; fast: 8 warps
constexpr int kTM = 4;
constexpr int kTN = 4;
constexpr int kVec = 8;        // elements of each operand a thread stages per tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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

// This thread's share of the tiles at k0, in the mode's rounding:
// x[m0 + xm][k0 + xk .. +7] and w[k0 + wk][n0 + wn .. +7]. With vec (K and
// N multiples of 8, operands 16-byte aligned) a run of 8 is wholly inside or
// outside the matrix and is read with one vector load per operand.
template <typename XT, typename ST, bool FAST>
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
  if (FAST)
#pragma unroll
    for (int j = 0; j < kVec; ++j) xr[j] = round_bf16(xr[j]);

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
  for (int j = 0; j < kVec; ++j)
    wr[j] = FAST ? round_bf16(qv[j] * round_bf16(sv[j])) : qv[j] * sv[j];
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
  load_tiles<XT, ST, false>(x, q, s, M, K, N, g, k_begin, k_end, m0, n0, xm,
                            xk, wk, wn, vec, xr, wr);
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      xs[xk + j][xm] = xr[j];
      ws[wk][wn + j] = wr[j];
    }
    __syncthreads();
    if (k0 + kBK < k_end)  // next tile's loads run while this one multiplies
      load_tiles<XT, ST, false>(x, q, s, M, K, N, g, k0 + kBK, k_end, m0, n0,
                                xm, xk, wk, wn, vec, xr, wr);
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

// Fast mode: the same tiles, staged as bf16 (exact: load_tiles has already
// rounded them) and multiplied by WMMA. Warp w computes output rows
// 16 * (w % 4) .. +15 and columns 32 * (w / 4) .. +31 of the tile.
template <typename XT, typename ST, bool DIRECT>
__global__ void __launch_bounds__(kThreads)
gemm_fast_kernel(const XT* __restrict__ x, const int8_t* __restrict__ q,
                 const ST* __restrict__ s, XT* __restrict__ y,
                 float* __restrict__ partial, int M, int K, int N, int g,
                 int k_per_split, bool vec) {
  using namespace nvcuda;
  constexpr int kLdA = kBK + 8, kLdB = kBN + 8, kLdC = kBN + 4;
  __shared__ __align__(32) __nv_bfloat16 as[kBM][kLdA];  // x tile [m][k]
  __shared__ __align__(32) __nv_bfloat16 bs[kBK][kLdB];  // w tile [k][n]
  __shared__ __align__(32) float cs[kBM][kLdC];          // output tile

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp % 4) * 16, wc = (warp / 4) * 32;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int xm = tid / (kBK / kVec), xk = (tid % (kBK / kVec)) * kVec;
  const int wk = tid / (kBN / kVec), wn = (tid % (kBN / kVec)) * kVec;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;

  float xr[kVec], wr[kVec];
  load_tiles<XT, ST, true>(x, q, s, M, K, N, g, k_begin, k_end, m0, n0, xm,
                           xk, wk, wn, vec, xr, wr);
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      as[xm][xk + j] = __float2bfloat16_rn(xr[j]);
      bs[wk][wn + j] = __float2bfloat16_rn(wr[j]);
    }
    __syncthreads();
    if (k0 + kBK < k_end)  // next tile's loads run while this one multiplies
      load_tiles<XT, ST, true>(x, q, s, M, K, N, g, k0 + kBK, k_end, m0, n0,
                               xm, xk, wk, wn, vec, xr, wr);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::load_matrix_sync(fa, &as[wm][kk], kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(fb, &bs[kk][wc + 16 * j], kLdB);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }
  wmma::store_matrix_sync(&cs[wm][wc], acc[0], kLdC, wmma::mem_row_major);
  wmma::store_matrix_sync(&cs[wm][wc + 16], acc[1], kLdC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N) put<XT, DIRECT>(y, partial, M, N, m, n, cs[r][c]);
  }
}

// Sums the K splits' partials [splits, M*N] in split order (deterministic).
template <typename XT>
__global__ void reduce_splits(const float* __restrict__ partial, XT* __restrict__ y,
                              size_t MN, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float acc = 0.f;
  for (int sp = 0; sp < splits; ++sp) acc += partial[(size_t)sp * MN + i];
  store(y + i, acc);
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
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  const bool direct = splits == 1;
  const bool vec = vec_ok && K % kVec == 0 && N % kVec == 0;
  if (exact && direct)
    gemm_exact_kernel<XT, ST, true><<<grid, kThreads, 0, stream>>>(xp, qp, sp, yp, pp, M, K, N, g, k_per_split, vec);
  else if (exact)
    gemm_exact_kernel<XT, ST, false><<<grid, kThreads, 0, stream>>>(xp, qp, sp, yp, pp, M, K, N, g, k_per_split, vec);
  else if (direct)
    gemm_fast_kernel<XT, ST, true><<<grid, kThreads, 0, stream>>>(xp, qp, sp, yp, pp, M, K, N, g, k_per_split, vec);
  else
    gemm_fast_kernel<XT, ST, false><<<grid, kThreads, 0, stream>>>(xp, qp, sp, yp, pp, M, K, N, g, k_per_split, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || direct) return err;
  const size_t MN = (size_t)M * N;
  reduce_splits<XT><<<(unsigned)((MN + 255) / 256), 256, 0, stream>>>(pp, yp, MN, splits);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] (fp32 or bf16) row-major, q [K, N] int8 row-major, s [>= K/g, N]
// (fp32 or bf16, row stride N), y [M, N] in x's dtype. exact selects the
// fp32 dequant. k_per_split (a multiple of 32) splits K across blocks;
// partial is fp32 scratch [ceil(K / k_per_split), M, N], unused when one
// split covers K. vec: x, q and s are 16-byte aligned (the kernel adds the
// K % 8 and N % 8 conditions). Returns the launch's cudaError_t.
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
