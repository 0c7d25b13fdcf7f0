// Kernel-measurement probes for Hopper (sm_90a): an int8 weight stream and a
// group-segmented matmul with output-side scales.
//
// Replaces the TPU kernels of tools/exp_kernel.py:
//   exp_stream   <- `_stream_kernel` (entry `stream`): q int8 [K, N] read in
//                   (tk, tn) tiles -> [1, 1] fp32. The TPU kernel zeroes its
//                   accumulator at k == 0 of every column tile and writes it
//                   only at the last (j, k), so its value is the sum of the
//                   LAST column tile over all K rows, summed per tile and
//                   added tile after tile in k order; every tile is read.
//   exp_outscale <- `_outscale_kernel` (entry `outscale`): x [M, K], q int8
//                   [K, N], s [K / 64, N] -> bf16 [M, N] =
//                   bf16(sum_ktiles sum_groups (bf16 x_g . bf16 q_g, fp32) * s_g).
//
// What bounds them on this card: bytes, in both. The stream reads K * N
// bytes and does one add per byte. At the tool's M = 8 rows the outscale
// matmul does 16 FLOP per weight byte; the CUDA cores' 67 TFLOP/s over
// 3.35 TB/s give about 20, so a kernel of FMAs would sit near both limits.
//
// What the designs do about it:
//   * stream: one block per (tn-column, tk-row) tile, as the TPU grid has one
//     step per tile; 1024 threads, each with four 16-byte loads in flight,
//     summed exactly in int32 by __dp4a against 0x01010101. Every block
//     writes its tile's sum to a scratch array, so no load can be dropped as
//     dead; a second one-thread pass adds the last column tile's sums in k
//     order as fp32, the TPU kernel's order. The tile grid is the tool's
//     question (its tiles are 0.25-4 MB, so a shape gives few blocks).
//   * outscale: the product runs on the tensor cores (bf16 WMMA 16 x 16 x 16,
//     fp32 accumulation, M padded to 16 rows by the wrapper), which removes
//     the compute limit. A block takes one k-tile (tk rows: the TPU block's K
//     range, so the sum over k-tiles keeps its order) and a 64-column slab of
//     a column tile; columns are independent, so cutting a tn-wide tile into
//     slabs changes no number and gives the card more blocks. Each of 8
//     warps takes whole 64-row groups: it stages 16 int8 rows at a time as
//     bf16 (exact) with the next 16 rows' loads in flight, multiplies, then
//     scales the group's fp32 product by s[group, n] and adds it to its
//     registers. The warps' sums are added in warp order, the k-tiles' fp32
//     partials in k order by a second pass that rounds once to bf16. No float
//     atomics: results repeat bit for bit.
// Simple on purpose: no TMA, no wgmma, no cp.async ring.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kStreamThreads = 1024;
constexpr int kUnroll = 4;

constexpr int kG = 64;        // rows per scale group (the tool's G)
constexpr int kSlab = 64;     // columns per outscale block
constexpr int kWarps = 8;
constexpr int kOsThreads = kWarps * 32;
constexpr int kLdB = kSlab + 8;   // bf16 stage stride (a multiple of 8)
constexpr int kLdP = kSlab + 4;   // fp32 stage stride (a multiple of 4)
constexpr int kMPad = 16;         // WMMA rows

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int sum16(const int4 v, int acc) {
  acc = __dp4a(v.x, 0x01010101, acc);
  acc = __dp4a(v.y, 0x01010101, acc);
  acc = __dp4a(v.z, 0x01010101, acc);
  return __dp4a(v.w, 0x01010101, acc);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block (j, k) sums tile rows [k * tk, +tk) x columns [j * tn, +tn) into
// partial[k * gridDim.x + j]. VEC: tn % 16 == 0, N % 16 == 0, q 16-byte aligned.
template <bool VEC>
__global__ void __launch_bounds__(kStreamThreads)
stream_kernel(const int8_t* __restrict__ q, int* __restrict__ partial, int N,
              int tk, int tn) {
  const int8_t* base = q + (size_t)blockIdx.y * tk * N + (size_t)blockIdx.x * tn;
  int acc = 0;
  if (VEC) {
    const unsigned vpr = tn / 16;  // 16-byte vectors per tile row
    const unsigned nv = (unsigned)tk * vpr;
    unsigned i = threadIdx.x;
    for (; i + (kUnroll - 1) * kStreamThreads < nv; i += kUnroll * kStreamThreads) {
      int4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned e = i + u * kStreamThreads;
        v[u] = __ldg(reinterpret_cast<const int4*>(base + (size_t)(e / vpr) * N) + e % vpr);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc = sum16(v[u], acc);
    }
    for (; i < nv; i += kStreamThreads)
      acc = sum16(__ldg(reinterpret_cast<const int4*>(base + (size_t)(i / vpr) * N) + i % vpr), acc);
  } else {
    const unsigned ne = (unsigned)tk * tn;
    for (unsigned e = threadIdx.x; e < ne; e += kStreamThreads)
      acc += base[(size_t)(e / tn) * N + e % tn];
  }
  __shared__ int warps[kStreamThreads / 32];
  acc = warp_sum(acc);
  if (threadIdx.x % 32 == 0) warps[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int v = warp_sum(warps[threadIdx.x]);
    if (threadIdx.x == 0) partial[blockIdx.y * gridDim.x + blockIdx.x] = v;
  }
}

// out[0] = the last column tile's sums, added as fp32 in k order.
__global__ void stream_finish(const int* __restrict__ partial, float* __restrict__ out,
                              int n_n, int n_k) {
  float acc = 0.f;
  for (int k = 0; k < n_k; ++k) acc += (float)partial[k * n_n + n_n - 1];
  out[0] = acc;
}

// Block (x, kt): columns [x * 64, +64) over k-tile kt (rows [kt * tk, +tk)),
// into partial[kt][m][n] for m < M. xp is bf16 [16, K] with rows >= M zero.
template <typename ST>
__global__ void __launch_bounds__(kOsThreads)
outscale_kernel(const __nv_bfloat16* __restrict__ xp, const int8_t* __restrict__ q,
                const ST* __restrict__ s, float* __restrict__ partial, int M,
                int K, int N, int tk) {
  using namespace nvcuda;
  // Per warp: the bf16 stage of 16 weight rows [16][kLdB], aliased by the
  // fp32 stage of a group's product [16][kLdP]; after the group loop, the
  // warps' sums for the fixed-order reduction.
  __shared__ __align__(32) float stage[kWarps][kMPad * kLdP];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kSlab;
  const int kbeg = blockIdx.y * tk;
  const int ng = tk / kG;
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(stage[warp]);
  float* ps = stage[warp];
  // a lane's share of the 16 x 64 product: element e = lane + 32 t is row
  // t / 2, column lane + 32 (t % 2)
  float acc[2 * kMPad];
#pragma unroll
  for (int t = 0; t < 2 * kMPad; ++t) acc[t] = 0.f;
  // a lane's share of 16 weight rows: row lane / 2, columns c0 .. c0 + 31
  const int r = lane / 2, c0 = (lane % 2) * 32;

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc[kSlab / 16];

  for (int grp = warp; grp < ng; grp += kWarps) {
    const int k0 = kbeg + grp * kG;
#pragma unroll
    for (int f = 0; f < kSlab / 16; ++f) wmma::fill_fragment(fc[f], 0.f);
    const int4* src = reinterpret_cast<const int4*>(q + (size_t)(k0 + r) * N + n0 + c0);
    int4 nxt0 = __ldg(src), nxt1 = __ldg(src + 1);
#pragma unroll
    for (int st = 0; st < kG / 16; ++st) {
      const int4 cur0 = nxt0, cur1 = nxt1;
      if (st + 1 < kG / 16) {  // the next 16 rows' loads fly while these multiply
        src = reinterpret_cast<const int4*>(q + (size_t)(k0 + 16 * (st + 1) + r) * N + n0 + c0);
        nxt0 = __ldg(src);
        nxt1 = __ldg(src + 1);
      }
      __syncwarp();  // the stage's previous readers are done
      const int8_t* b0 = reinterpret_cast<const int8_t*>(&cur0);
      const int8_t* b1 = reinterpret_cast<const int8_t*>(&cur1);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        bs[r * kLdB + c0 + j] = __float2bfloat16_rn((float)b0[j]);
        bs[r * kLdB + c0 + 16 + j] = __float2bfloat16_rn((float)b1[j]);
      }
      __syncwarp();
      wmma::load_matrix_sync(fa, xp + k0 + 16 * st, K);
#pragma unroll
      for (int f = 0; f < kSlab / 16; ++f) {
        wmma::load_matrix_sync(fb, bs + 16 * f, kLdB);
        wmma::mma_sync(fc[f], fa, fb, fc[f]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int f = 0; f < kSlab / 16; ++f)
      wmma::store_matrix_sync(ps + 16 * f, fc[f], kLdP, wmma::mem_row_major);
    __syncwarp();
    const ST* srow = s + (size_t)(k0 / kG) * N + n0;
    const float s_lo = to_f(srow[lane]), s_hi = to_f(srow[lane + 32]);
#pragma unroll
    for (int t = 0; t < 2 * kMPad; ++t)
      if (t / 2 < M) acc[t] += ps[(t / 2) * kLdP + lane + 32 * (t % 2)] * ((t % 2) ? s_hi : s_lo);
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < 2 * kMPad; ++t)
    if (t / 2 < M) stage[warp][(t / 2) * kLdP + lane + 32 * (t % 2)] = acc[t];
  __syncthreads();
  for (int i = threadIdx.x; i < M * kSlab; i += kOsThreads) {
    const int m = i / kSlab, n = i % kSlab;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += stage[w][m * kLdP + n];
    partial[((size_t)blockIdx.y * M + m) * N + n0 + n] = v;
  }
}

// y[m, n] = bf16(sum_kt partial[kt][m][n]), in k-tile order.
__global__ void outscale_finish(const float* __restrict__ partial,
                                __nv_bfloat16* __restrict__ y, int MN, int n_k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float acc = 0.f;
  for (int k = 0; k < n_k; ++k) acc += partial[(size_t)k * MN + i];
  y[i] = __float2bfloat16_rn(acc);
}

}  // namespace

// q [K, N] int8 row-major; partial int32 scratch [K / tk, N / tn]; out [1]
// fp32. K % tk == 0 and N % tn == 0 (the wrapper checks). vec: tn % 16 == 0,
// N % 16 == 0 and q 16-byte aligned. Returns the launches' cudaError_t.
extern "C" int exp_stream(const void* q, void* partial, void* out, int K, int N,
                          int tk, int tn, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_n = N / tn, n_k = K / tk;
  const dim3 grid(n_n, n_k);
  const int8_t* qp = static_cast<const int8_t*>(q);
  int* pp = static_cast<int*>(partial);
  if (vec) stream_kernel<true><<<grid, kStreamThreads, 0, st>>>(qp, pp, N, tk, tn);
  else stream_kernel<false><<<grid, kStreamThreads, 0, st>>>(qp, pp, N, tk, tn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_finish<<<1, 1, 0, st>>>(pp, static_cast<float*>(out), n_n, n_k);
  return static_cast<int>(cudaGetLastError());
}

// xp bf16 [16, K] (rows >= M zero, 32-byte aligned), q [K, N] int8 and s
// [K / 64, N] (fp32 or bf16) row-major, partial fp32 scratch [K / tk, M, N],
// y bf16 [M, N]. M <= 16, K % tk == 0, tk % 64 == 0, N % 64 == 0, q 16-byte
// aligned (the wrapper checks). Returns the launches' cudaError_t.
extern "C" int exp_outscale(const void* xp, const void* q, const void* s, int s_bf16,
                            void* partial, void* y, int M, int K, int N, int tk,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_k = K / tk;
  const dim3 grid(N / kSlab, n_k);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(xp);
  const int8_t* qp = static_cast<const int8_t*>(q);
  float* pp = static_cast<float*>(partial);
  if (s_bf16)
    outscale_kernel<__nv_bfloat16><<<grid, kOsThreads, 0, st>>>(
        x, qp, static_cast<const __nv_bfloat16*>(s), pp, M, K, N, tk);
  else
    outscale_kernel<float><<<grid, kOsThreads, 0, st>>>(
        x, qp, static_cast<const float*>(s), pp, M, K, N, tk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int MN = M * N;
  outscale_finish<<<(MN + 255) / 256, 256, 0, st>>>(pp, static_cast<__nv_bfloat16*>(y), MN, n_k);
  return static_cast<int>(cudaGetLastError());
}
