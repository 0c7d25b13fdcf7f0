// W8A16 group-dequant GEMV for Hopper (sm_90a): y[1,N] = x[1,K] @ dequant(q, s).
//
// Replaces the TPU kernel kuiperllama_tpu/ops/pallas/quant_matmul.py
// `_kernel_diag` (with `_blockdiag`), and its XLA twin `_diag_gemv_xla`,
// which serve every M = 1 decode projection and the lm_head in fast mode when
// K / g <= 64. The numerics are those of `_kernel_diag`:
//   P[i, n] = sum_{k in group i} bf16(x[k]) * q[k, n]     (fp32, exact products)
//   y[n]    = sum_i s[i, n] * P[i, n]                      (fp32)
// then y is rounded once to x's dtype.
//
// What bounds it on this card: bytes. Each weight byte is used for one
// multiply-add, so the kernel has to stream q [K, N] int8 (plus s, x and y)
// from HBM once at 3.35 TB/s; at Llama-2-7B w13 (K 4096, N 22016) that is
// 90.2 MB, about 27 us. The design aims at that stream:
//   * q is read in the JAX layout, row-major [K, N]. A thread owns a run of
//     16 adjacent columns and reads it as one 16-byte load per row; the 16
//     column threads of a half-warp cover 256 contiguous bytes of one row.
//   * bf16(x) for the block's K range is staged once in shared memory as
//     fp32 (every bf16 value is exact in fp32, and so is bf16 * int8).
//   * At N = 4096 a column split alone gives 16 blocks for 132 SMs, so K is
//     also split, by whole groups, across blockIdx.y. Inside a block the 16
//     k-lanes of a group are reduced through shared memory into the group's
//     fp32 partial, which is then scaled by s[i, n] in fp32 and added to the
//     column's accumulator, as `_kernel_diag` does.
//   * The K splits write fp32 partials that a second small pass sums in a
//     fixed order, so greedy tokens are reproducible from run to run (no
//     floating-point atomics).
// Scale rows past K / g are never read. A ragged N takes the scalar-load path.
// This first version is simple on purpose: no TMA, no cp.async pipeline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kColsPerThread = 16;
constexpr int kColThreads = 16;
constexpr int kKLanes = 16;
constexpr int kThreads = kColThreads * kKLanes;          // 256
constexpr int kBlockCols = kColThreads * kColsPerThread;  // 256

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Block (blockIdx.x, blockIdx.y) covers columns [blockIdx.x * 256, +256) and
// groups [blockIdx.y * gps, min(ng, (blockIdx.y + 1) * gps)).
template <typename XT, typename ST, bool VEC, bool DIRECT>
__global__ void __launch_bounds__(kThreads)
gemv_kernel(const XT* __restrict__ x, const int8_t* __restrict__ q,
            const ST* __restrict__ s, XT* __restrict__ y,
            float* __restrict__ partial, int N, int g, int gps, int ng) {
  extern __shared__ float smem[];
  float* xs = smem;                // [gps * g]   bf16(x) as fp32
  float* red = smem + gps * g;     // [kKLanes][kBlockCols] k-lane partials

  const int tid = threadIdx.x;
  const int ct = tid % kColThreads;
  const int kl = tid / kColThreads;
  const int g0 = blockIdx.y * gps;
  const int g1 = min(ng, g0 + gps);
  const int k0 = g0 * g;
  const int klen = (g1 - g0) * g;
  for (int i = tid; i < klen; i += kThreads) xs[i] = round_bf16(to_f(x[k0 + i]));
  __syncthreads();

  const int col0 = blockIdx.x * kBlockCols + ct * kColsPerThread;
  const int my_col = blockIdx.x * kBlockCols + tid;  // column for the scale phase
  float acc = 0.f;
  for (int grp = g0; grp < g1; ++grp) {
    float part[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) part[j] = 0.f;
    const int kb = grp * g;
#pragma unroll 4
    for (int k = kl; k < g; k += kKLanes) {
      const float xv = xs[kb - k0 + k];
      const int8_t* row = q + (size_t)(kb + k) * N + col0;
      if (VEC) {
        if (col0 < N) {  // N % 16 == 0: a run is wholly in or out
          const int4 v = __ldg(reinterpret_cast<const int4*>(row));
          const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) part[j] += xv * (float)b[j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j)
          if (col0 + j < N) part[j] += xv * (float)row[j];
      }
    }
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j)
      red[kl * kBlockCols + ct * kColsPerThread + j] = part[j];
    __syncthreads();
    if (my_col < N) {
      float p = 0.f;
#pragma unroll
      for (int l = 0; l < kKLanes; ++l) p += red[l * kBlockCols + tid];
      acc += p * to_f(s[(size_t)grp * N + my_col]);
    }
    __syncthreads();
  }
  if (my_col < N) {
    if (DIRECT) store(y + my_col, acc);
    else partial[(size_t)blockIdx.y * N + my_col] = acc;
  }
}

// Sums the K splits' partials in split order (deterministic).
template <typename XT>
__global__ void reduce_splits(const float* __restrict__ partial, XT* __restrict__ y,
                              int N, int splits) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float acc = 0.f;
  for (int sp = 0; sp < splits; ++sp) acc += partial[(size_t)sp * N + n];
  store(y + n, acc);
}

template <typename XT, typename ST, bool VEC>
cudaError_t launch(const void* x, const void* q, const void* s, void* y,
                   void* partial, int K, int N, int g, int gps,
                   cudaStream_t stream) {
  const int ng = K / g;
  const int splits = (ng + gps - 1) / gps;
  const dim3 grid((N + kBlockCols - 1) / kBlockCols, splits);
  const size_t smem = (size_t)(gps * g + kKLanes * kBlockCols) * sizeof(float);
  const XT* xp = static_cast<const XT*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const ST* sp = static_cast<const ST*>(s);
  XT* yp = static_cast<XT*>(y);
  float* pp = static_cast<float*>(partial);
  if (splits == 1) {
    gemv_kernel<XT, ST, VEC, true><<<grid, kThreads, smem, stream>>>(
        xp, qp, sp, yp, pp, N, g, gps, ng);
  } else {
    gemv_kernel<XT, ST, VEC, false><<<grid, kThreads, smem, stream>>>(
        xp, qp, sp, yp, pp, N, g, gps, ng);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    reduce_splits<XT><<<(N + 255) / 256, 256, 0, stream>>>(pp, yp, N, splits);
  }
  return cudaGetLastError();
}

template <typename XT, typename ST>
cudaError_t launch_vec(int vec, const void* x, const void* q, const void* s,
                       void* y, void* partial, int K, int N, int g, int gps,
                       cudaStream_t stream) {
  return vec ? launch<XT, ST, true>(x, q, s, y, partial, K, N, g, gps, stream)
             : launch<XT, ST, false>(x, q, s, y, partial, K, N, g, gps, stream);
}

}  // namespace

// x [1, K] (fp32 or bf16), q [K, N] int8 row-major, s [>= K/g, N] (fp32 or
// bf16, row stride N), y [1, N] in x's dtype, partial [ceil(K/g / gps), N]
// fp32 scratch (unused when one split covers K). vec: N % 16 == 0 and q is
// 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int quant_gemv(const void* x, int x_bf16, const void* q, const void* s,
                          int s_bf16, void* y, void* partial, int K, int N,
                          int group_size, int groups_per_split, int vec,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = group_size, gps = groups_per_split;
  cudaError_t err;
  if (x_bf16) {
    err = s_bf16 ? launch_vec<__nv_bfloat16, __nv_bfloat16>(vec, x, q, s, y, partial, K, N, g, gps, st)
                 : launch_vec<__nv_bfloat16, float>(vec, x, q, s, y, partial, K, N, g, gps, st);
  } else {
    err = s_bf16 ? launch_vec<float, __nv_bfloat16>(vec, x, q, s, y, partial, K, N, g, gps, st)
                 : launch_vec<float, float>(vec, x, q, s, y, partial, K, N, g, gps, st);
  }
  return static_cast<int>(err);
}
