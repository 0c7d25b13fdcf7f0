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
// 90.2 MB, about 27 us. What the design does about it:
//   * A warp owns whole groups. Its 32 lanes are CT column threads (16
//     adjacent columns each, one 16-byte load per row: 16 CT contiguous
//     bytes of a row) x 32 / CT sub-lanes; CT is 8, or 4 where 8 would leave
//     too few warps to fill the card (Llama-2-7B's wo;
//     ops/kernels/quant_matmul.py `gemv_col_threads`). Sub-lane sl sums rows
//     sl, sl + S, ... of the group in row order in fp32 registers; the group's
//     partial P[i, n] is then formed by a reduce-scatter over the sub-lanes
//     inside the warp (shuffle steps pairing sl with sl ^ S/2, ..., sl ^ 1),
//     which leaves each lane 16 / S columns, and each lane scales those once
//     by s[i, n] into its fp32 accumulators. No __syncthreads() inside the K
//     loop: the warps of a block are reduced once, in warp order, at the end.
//   * Bytes in flight: rows are taken in batches of 8 per sub-lane,
//     double-buffered in registers, so a lane has 8 to 16 16-byte loads in
//     flight (4-8 KB a warp); the first batch is requested before x is
//     staged, and a group's scales come with its first batch.
//   * int8 to fp32 with a byte permute and an add (the sign-flipped byte in
//     the mantissa of 2^23, exact), not a conversion instruction per byte:
//     conversions issue at a fraction of the rate of permutes and adds.
//   * A block is min(8, gps) warps over CT x 16 columns; K is split by whole
//     groups (gps groups per split, blockIdx.y) until the grid reaches the
//     planned blocks per SM.
//   * The K splits' fp32 partials are summed in split order, so greedy
//     tokens repeat from run to run (no floating-point atomics), by the last
//     block of a column tile to finish, behind an integer counter: one
//     launch a call (a second summing pass measured slower at wo and w2,
//     PERF.md).
// Scale rows past K / g are never read. A ragged N (or an unaligned q) loads
// the same rows byte by byte with a column guard. No wgmma: the tensor cores
// do not speed up a matrix-vector product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBatch = 8;       // rows per sub-lane per batch
constexpr int kMaxWarps = 8;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 16 int8 of row `row` from column col0: one 16-byte load, or byte loads
// with a column guard on the ragged path; zeros past N.
template <bool VEC>
__device__ __forceinline__ int4 load_row(const int8_t* __restrict__ q, size_t row, int N,
                                         int col0) {
  if (VEC) {
    if (col0 < N) return __ldg(reinterpret_cast<const int4*>(q + row * N + col0));
    return make_int4(0, 0, 0, 0);
  }
  int w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = col0 + j;
    const int b = c < N ? static_cast<int>(static_cast<uint8_t>(q[row * N + c])) : 0;
    w[j / 4] |= b << (8 * (j % 4));
  }
  return make_int4(w[0], w[1], w[2], w[3]);
}

// sum_sp partial[sp, col] in split order, eight loads in flight at a time.
__device__ __forceinline__ float sum_splits(const float* __restrict__ partial, int N, int col,
                                            int splits) {
  float t = 0.f;
  for (int sp = 0; sp < splits; sp += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = sp + u < splits ? __ldcg(partial + (size_t)(sp + u) * N + col) : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (sp + u < splits) t += v[u];
  }
  return t;
}

// The warp's layout: CT column threads of 16 adjacent columns (CT x 16
// contiguous bytes of a row) x S = 32 / CT sub-lanes; sub-lane sl takes
// rows sl, sl + S, ... of a group, kBatch of them per batch.
template <int CT>
struct Layout {
  static constexpr int S = 32 / CT;
  static constexpr int kBlockCols = CT * 16;
  static constexpr int kBatchRows = kBatch * S;
  static constexpr int kColsPerLane = 16 / S;  // after the reduce-scatter
};

// A warp's walk over its groups: group first + stride * (t / nb), batch
// t % nb, whose rows start at sl + kBatchRows * (t % nb).
struct Walk {
  int first, stride, nb, g, k0, sl, batch_rows;
  __device__ int group(int t) const { return first + stride * (t / nb); }
  __device__ int row0(int t) const { return sl + batch_rows * (t % nb); }
};

// One batch (rows r0 + S i of the group, i < kBatch; rows past the group
// are zero and never summed) and, with the group's first batch, the lane's
// scales.
template <int CT, bool VEC, typename ST>
__device__ __forceinline__ void fetch(const int8_t* __restrict__ q, const ST* __restrict__ s,
                                      int N, int col0, int my_c, const Walk& wk, int t,
                                      int4* buf, float* sc) {
  constexpr int S = Layout<CT>::S;
  const int grp = wk.group(t), r0 = wk.row0(t);
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    const int r = r0 + S * i;
    buf[i] = r < wk.g ? load_row<VEC>(q, static_cast<size_t>(grp * wk.g + r), N, col0)
                      : make_int4(0, 0, 0, 0);
  }
  if (t % wk.nb == 0) {
#pragma unroll
    for (int j = 0; j < Layout<CT>::kColsPerLane; ++j)
      sc[j] = my_c + j < N ? to_f(s[(size_t)grp * N + my_c + j]) : 0.f;
  }
}

// part[j] += x[row] * q[row, col0 + j] over the batch's rows, in row order.
// int8 to fp32 exactly without a conversion instruction: the sign-flipped
// byte (q + 128) becomes the low mantissa byte of 2^23, and 2^23 + 128 is
// subtracted (one byte permute and one add a value).
template <int CT>
__device__ __forceinline__ void sum_batch(const int4* buf, const float* xs, int r0, int g,
                                          float* part) {
  constexpr int S = Layout<CT>::S;
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    const int r = r0 + S * i;
    const float xv = r < g ? xs[r] : 0.f;
    const unsigned w[4] = {static_cast<unsigned>(buf[i].x) ^ 0x80808080u,
                           static_cast<unsigned>(buf[i].y) ^ 0x80808080u,
                           static_cast<unsigned>(buf[i].z) ^ 0x80808080u,
                           static_cast<unsigned>(buf[i].w) ^ 0x80808080u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float f =
          __int_as_float(static_cast<int>(__byte_perm(w[j / 4], 0x4B000000u, 0x7540 + j % 4)));
      part[j] = fmaf(xv, f - 8388736.f, part[j]);
    }
  }
}

// The group's P over the warp's S sub-lanes, reduce-scatter: at each step the
// sub-lanes sl and sl ^ h (h = S/2, S/4, ..., 1) add the half of their
// columns that the lane keeps, so sub-lane sl ends with the 16 / S columns
// from (16 / S) sl of its column thread in p[0 ..]; part is left zero.
template <int CT>
__device__ __forceinline__ void reduce_group(float* part, int sl, float* p) {
  constexpr int S = Layout<CT>::S;
#pragma unroll
  for (int j = 0; j < 16; ++j) p[j] = part[j];
#pragma unroll
  for (int h = S / 2, n = 8; h >= 1; h /= 2, n /= 2) {
    const bool hi = sl & h;
#pragma unroll
    for (int m = 0; m < n; ++m) {
      const float keep = hi ? p[n + m] : p[m];
      const float send = hi ? p[m] : p[n + m];
      p[m] = keep + __shfl_xor_sync(0xffffffffu, send, h * CT);
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) part[j] = 0.f;
}

// Sums batch t into part; the group's first batch brings its scales (cur),
// its last reduces P over the sub-lanes and adds s * P to acc.
template <int CT>
__device__ __forceinline__ void use(const Walk& wk, int t, const int4* buf, const float* sc,
                                    const float* xs, float* part, float* cur, float* acc) {
  constexpr int NC = Layout<CT>::kColsPerLane;
  const int b = t % wk.nb;
  if (b == 0) {
#pragma unroll
    for (int j = 0; j < NC; ++j) cur[j] = sc[j];
  }
  sum_batch<CT>(buf, xs + wk.group(t) * wk.g - wk.k0, wk.row0(t), wk.g, part);
  if (b == wk.nb - 1) {
    float p[16];
    reduce_group<CT>(part, wk.sl, p);
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[j] = fmaf(p[j], cur[j], acc[j]);
  }
}

// Block (blockIdx.x, blockIdx.y) covers columns [blockIdx.x * CT * 16, +CT * 16)
// and groups [blockIdx.y * gps, min(ng, (blockIdx.y + 1) * gps)); warp w
// takes groups g0 + w, g0 + w + nwarps, ...
template <typename XT, typename ST, int CT, bool VEC, bool SPLIT>
__global__ void __launch_bounds__(kMaxWarps * 32)
gemv_kernel(const XT* __restrict__ x, const int8_t* __restrict__ q,
            const ST* __restrict__ s, XT* __restrict__ y, float* __restrict__ partial,
            unsigned int* __restrict__ counters, int N, int g, int gps, int ng) {
  using L = Layout<CT>;
  constexpr int BC = L::kBlockCols, NC = L::kColsPerLane;
  extern __shared__ float smem[];
  const int nwarps = blockDim.x / 32;
  float* red = smem;                      // [nwarps][BC] warp totals
  float* xs = smem + kMaxWarps * BC;      // [gps * g] bf16(x) as fp32

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int ct = lane % CT, sl = lane / CT;
  const int g0 = blockIdx.y * gps;
  const int g1 = min(ng, g0 + gps);
  const int k0 = g0 * g;
  const int col0 = blockIdx.x * BC + ct * 16;
  const int my_c = col0 + NC * sl;  // this lane's accumulated columns
  const int nb = (g + L::kBatchRows - 1) / L::kBatchRows;
  const int my_groups = w < g1 - g0 ? (g1 - g0 - w + nwarps - 1) / nwarps : 0;
  const int total = my_groups * nb;
  const Walk wk{g0 + w, nwarps, nb, g, k0, sl, L::kBatchRows};

  float part[16], acc[NC], cur[NC];
#pragma unroll
  for (int j = 0; j < 16; ++j) part[j] = 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[j] = cur[j] = 0.f;
  int4 bufA[kBatch], bufB[kBatch];
  float scA[NC], scB[NC];

  // the first batch's loads go out before x is staged: the weights do not
  // depend on it
  if (total > 0) fetch<CT, VEC>(q, s, N, col0, my_c, wk, 0, bufA, scA);
  const int klen = (g1 - g0) * g;
  for (int i = tid; i < klen; i += blockDim.x) xs[i] = round_bf16(to_f(x[k0 + i]));
  __syncthreads();

  // two register buffers: the next batch in flight while this one is summed
  for (int t = 0; t < total; t += 2) {
    if (t + 1 < total) fetch<CT, VEC>(q, s, N, col0, my_c, wk, t + 1, bufB, scB);
    use<CT>(wk, t, bufA, scA, xs, part, cur, acc);
    if (t + 2 < total) fetch<CT, VEC>(q, s, N, col0, my_c, wk, t + 2, bufA, scA);
    if (t + 1 < total) use<CT>(wk, t + 1, bufB, scB, xs, part, cur, acc);
  }

  // the warps' totals, summed in warp order
#pragma unroll
  for (int j = 0; j < NC; ++j) red[w * BC + ct * 16 + NC * sl + j] = acc[j];
  __syncthreads();
  // a block of fewer warps than BC / 32 covers its columns in turns
  for (int c = tid; c < BC; c += blockDim.x) {
    const int col = blockIdx.x * BC + c;
    if (col >= N) break;
    float v = 0.f;
    for (int i = 0; i < nwarps; ++i) v += red[i * BC + c];
    if (SPLIT) partial[(size_t)blockIdx.y * N + col] = v;
    else store(y + col, v);
  }
  if (!SPLIT) return;
  // the last block of this column tile to finish sums the splits in order
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int c = tid; c < BC; c += blockDim.x) {
    const int col = blockIdx.x * BC + c;
    if (col >= N) break;
    store(y + col, sum_splits(partial, N, col, gridDim.y));
  }
  if (tid == 0) counters[blockIdx.x] = 0u;
}

template <typename XT, typename ST, int CT, bool VEC>
cudaError_t launch(const void* x, const void* q, const void* s, void* y, void* partial,
                   void* counters, int K, int N, int g, int gps, cudaStream_t stream) {
  constexpr int BC = Layout<CT>::kBlockCols;
  const int ng = K / g;
  const int splits = (ng + gps - 1) / gps;
  const int warps = gps < kMaxWarps ? gps : kMaxWarps;
  const dim3 grid((N + BC - 1) / BC, splits);
  const size_t smem = (size_t)(kMaxWarps * BC + gps * g) * sizeof(float);
  const XT* xp = static_cast<const XT*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const ST* sp = static_cast<const ST*>(s);
  XT* yp = static_cast<XT*>(y);
  float* pp = static_cast<float*>(partial);
  unsigned int* cp = static_cast<unsigned int*>(counters);
  if (splits == 1)
    gemv_kernel<XT, ST, CT, VEC, false><<<grid, warps * 32, smem, stream>>>(
        xp, qp, sp, yp, pp, cp, N, g, gps, ng);
  else
    gemv_kernel<XT, ST, CT, VEC, true><<<grid, warps * 32, smem, stream>>>(
        xp, qp, sp, yp, pp, cp, N, g, gps, ng);
  return cudaGetLastError();
}

// The ragged path (byte loads) takes the 8-column-thread layout only.
template <typename XT, typename ST>
cudaError_t launch_layout(int ct, int vec, const void* x, const void* q, const void* s,
                          void* y, void* partial, void* counters, int K, int N, int g,
                          int gps, cudaStream_t stream) {
  if (!vec) {
    if (ct != 8) return cudaErrorInvalidValue;
    return launch<XT, ST, 8, false>(x, q, s, y, partial, counters, K, N, g, gps, stream);
  }
  switch (ct) {
    case 4:
      return launch<XT, ST, 4, true>(x, q, s, y, partial, counters, K, N, g, gps, stream);
    case 8:
      return launch<XT, ST, 8, true>(x, q, s, y, partial, counters, K, N, g, gps, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [1, K] (fp32 or bf16), q [K, N] int8 row-major, s [>= K/g, N] (fp32 or
// bf16, row stride N), y [1, N] in x's dtype, partial [ceil(K/g / gps), N]
// fp32 scratch and counters [ceil(N / (16 ct))] uint32 (zero before the
// launch, left zero after it), both unused when one split covers K.
// col_threads: 4 or 8 column threads a warp (8 without vec). vec: N % 16 ==
// 0 and q is 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int quant_gemv(const void* x, int x_bf16, const void* q, const void* s,
                          int s_bf16, void* y, void* partial, void* counters, int K,
                          int N, int group_size, int groups_per_split, int col_threads,
                          int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = group_size, gps = groups_per_split, ct = col_threads;
  if (g <= 0 || gps <= 0 || K % g) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (x_bf16) {
    err = s_bf16 ? launch_layout<__nv_bfloat16, __nv_bfloat16>(ct, vec, x, q, s, y, partial, counters, K, N, g, gps, st)
                 : launch_layout<__nv_bfloat16, float>(ct, vec, x, q, s, y, partial, counters, K, N, g, gps, st);
  } else {
    err = s_bf16 ? launch_layout<float, __nv_bfloat16>(ct, vec, x, q, s, y, partial, counters, K, N, g, gps, st)
                 : launch_layout<float, float>(ct, vec, x, q, s, y, partial, counters, K, N, g, gps, st);
  }
  return static_cast<int>(err);
}
