// GEMV formulations over a stacked int8 weight, for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/exp_int8.py `_kernel` (built in `run`): for
// w int8 [L, K, N], s fp32 [L, K / g, N] and x bf16 [1, K] it returns
// y [1, N] fp32 = sum over layers l = 0 .. L - 1, in order, of y_l, where the
// weight's columns arrive as nsplit column splits of TN = N / nsplit and y_l
// depends on the mode:
//   nodot   (0)  sum_{r < 8} (w[l, r, c] + w[l, K - 8 + r, c]) for the columns
//                c of every split, added into the first TN outputs (the rest
//                stay 0); the whole tile is still read.
//   bf16    (1)  sum_grp s[l, grp, n] * sum_{k in grp} bf16(x)[k] * w[l, k, n],
//                fp32 (`bf16` and `split4`, which differ only in nsplit).
//   int8    (2)  per group: amax = max |x|, d = amax / 127 (1 when amax = 0),
//                xq = rint(x / d) (half to even, a true division), then
//                sum_grp (fp32(sum_{k in grp} xq[k] * w[l, k, n]) * d) * s
//                (`int8` and `int8_split4`).
//   plain8  (3)  bf16(x) against bf16(bf16(w) * bf16(s)) with fp32 sums per
//                1024-row sub-chunk, added in order (nsplit 1 only).
//
// What bounds it on this card: bytes. Every mode reads the L x K x N weight
// once (536.9 MB at the tool's L 64, K 4096, N 2048, plus 33.6 MB of fp32
// scales), at most a few operations per byte.
//
// What the design does about it: one block per (layer, 256 output columns),
// 256 threads as 16 column threads x 16 k-lanes; a column thread reads 16
// adjacent columns as one 16-byte load per row, so each k-lane's 16 threads
// cover 256 bytes of a row. With nsplit > 1 the block's columns come from
// nsplit separate column ranges, one per split, so each block runs nsplit
// independent load streams: the card's analogue of the TPU's nsplit
// concurrent block copies. A k-lane owns whole groups, so a group's sum is
// formed in one thread in row order and needs no exchange: bf16(x) (or its
// int8 quantization, made by each block for its whole K) sits in shared
// memory, int8 products are exact int32 sums (__dp4a on 4 x 4 byte
// transposes), and each group's sum is scaled into per-column fp32
// registers. The 16 k-lanes are reduced once, in lane order, through shared
// memory (plain8: once per 1024-row sub-chunk, as its sums are formed). Each
// block writes y_l for its columns to a [L, N] scratch and a second pass adds
// the layers in order; nodot also writes a per-block byte checksum, so no
// load of the tile can be dropped as dead. No float atomics: results repeat
// bit for bit. No TMA or cp.async yet; built without --use_fast_math, so the
// int8 mode's division is IEEE and rintf rounds half to even.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kColThreads = 16;
constexpr int kKLanes = 16;
constexpr int kThreads = kColThreads * kKLanes;   // 256
constexpr int kBlockCols = kColThreads * 16;      // 256
constexpr int kSub = 1024;                        // plain8's sub-chunk rows

enum Mode { kNoDot = 0, kBf16 = 1, kInt8 = 2, kPlain8 = 3 };

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int sum16(const int4 v, int acc) {
  acc = __dp4a(v.x, 0x01010101, acc);
  acc = __dp4a(v.y, 0x01010101, acc);
  acc = __dp4a(v.z, 0x01010101, acc);
  return __dp4a(v.w, 0x01010101, acc);
}

// Pi[4 i + t] += dot(bytes t of rows r0..r3 of word i, xq4).
__device__ __forceinline__ void dp4_rows(const int4 r0, const int4 r1, const int4 r2,
                                         const int4 r3, int xq4, int (&pi)[16]) {
  const int a[4] = {r0.x, r0.y, r0.z, r0.w};
  const int b[4] = {r1.x, r1.y, r1.z, r1.w};
  const int c[4] = {r2.x, r2.y, r2.z, r2.w};
  const int d[4] = {r3.x, r3.y, r3.z, r3.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lo01 = (int)__byte_perm(a[i], b[i], 0x5140);  // a0 b0 a1 b1
    const int hi01 = (int)__byte_perm(c[i], d[i], 0x5140);  // c0 d0 c1 d1
    const int lo23 = (int)__byte_perm(a[i], b[i], 0x7362);  // a2 b2 a3 b3
    const int hi23 = (int)__byte_perm(c[i], d[i], 0x7362);  // c2 d2 c3 d3
    pi[4 * i + 0] = __dp4a((int)__byte_perm(lo01, hi01, 0x5410), xq4, pi[4 * i + 0]);
    pi[4 * i + 1] = __dp4a((int)__byte_perm(lo01, hi01, 0x7632), xq4, pi[4 * i + 1]);
    pi[4 * i + 2] = __dp4a((int)__byte_perm(lo23, hi23, 0x5410), xq4, pi[4 * i + 2]);
    pi[4 * i + 3] = __dp4a((int)__byte_perm(lo23, hi23, 0x7632), xq4, pi[4 * i + 3]);
  }
}

__device__ __forceinline__ int4 load_row(const int8_t* __restrict__ wl, int k, int N, int col0) {
  return __ldg(reinterpret_cast<const int4*>(wl + (size_t)k * N + col0));
}

// Block (b, l). Column thread ct reads split j = ct / (16 / nsplit), columns
// col_of(ct) .. +15; its output slot is ct * 16 + jj.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
int8_gemv_kernel(const int8_t* __restrict__ w, const float* __restrict__ s,
                 const __nv_bfloat16* __restrict__ x, float* __restrict__ partial,
                 int* __restrict__ checksum, int K, int N, int g, int nsplit) {
  extern __shared__ float smem[];
  float* red = smem;                     // [kKLanes][kBlockCols]
  float* xs = smem + kKLanes * kBlockCols;  // bf16(x) as fp32 [K]; int8: d [ng], then xq [K]
  const int tid = threadIdx.x;
  const int ct = tid % kColThreads, kl = tid / kColThreads;
  const int l = blockIdx.y, b = blockIdx.x;
  const int ng = K / g;
  const int TN = N / nsplit;
  const int per_split = kColThreads / nsplit;  // column threads per split
  const int cw = kBlockCols / nsplit;          // block columns per split
  const int j = ct / per_split;
  const int col0 = j * TN + b * cw + (ct % per_split) * 16;
  const int8_t* wl = w + (size_t)l * K * N;
  const float* sl = s + (size_t)l * ng * N;

  float acc[16];
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) acc[jj] = 0.f;

  if (MODE == kNoDot) {
    int sum = 0;
#pragma unroll 8
    for (int k = kl; k < K; k += kKLanes) {
      const int4 v = load_row(wl, k, N, col0);
      sum = sum16(v, sum);
      const int8_t* by = reinterpret_cast<const int8_t*>(&v);
      if (k < 8)
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) acc[jj] += (float)by[jj];
      if (k >= K - 8)
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) acc[jj] += (float)by[jj];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    __shared__ int warps[kThreads / 32];
    if (tid % 32 == 0) warps[tid / 32] = sum;
    __syncthreads();
    if (tid == 0) {
      int t = 0;
      for (int i = 0; i < kThreads / 32; ++i) t += warps[i];
      checksum[l * gridDim.x + b] = t;
    }
  } else if (MODE == kBf16 || MODE == kPlain8) {
    for (int k = tid; k < K; k += kThreads) xs[k] = __bfloat162float(x[k]);
    __syncthreads();
    if (MODE == kBf16) {
      for (int grp = kl; grp < ng; grp += kKLanes) {
        float p[16];
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) p[jj] = 0.f;
#pragma unroll 8
        for (int k = grp * g; k < (grp + 1) * g; ++k) {
          const int4 v = load_row(wl, k, N, col0);
          const int8_t* by = reinterpret_cast<const int8_t*>(&v);
          const float xv = xs[k];
#pragma unroll
          for (int jj = 0; jj < 16; ++jj) p[jj] += xv * (float)by[jj];
        }
        const float4* sp = reinterpret_cast<const float4*>(sl + (size_t)grp * N + col0);
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          const float4 sv = __ldg(sp + q4);
          acc[4 * q4 + 0] += p[4 * q4 + 0] * sv.x;
          acc[4 * q4 + 1] += p[4 * q4 + 1] * sv.y;
          acc[4 * q4 + 2] += p[4 * q4 + 2] * sv.z;
          acc[4 * q4 + 3] += p[4 * q4 + 3] * sv.w;
        }
      }
    } else {
      // plain8: per 1024-row sub-chunk, k-lane kl takes rows kl, kl + 16, ...
      // of each group; the lanes are reduced per sub-chunk, in lane order.
      float total = 0.f;  // this thread's output slot (tid) after each reduction
      const int gps = kSub / g;
      for (int sc = 0; sc < K / kSub; ++sc) {
        float p[16];
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) p[jj] = 0.f;
        for (int grp = sc * gps; grp < (sc + 1) * gps; ++grp) {
          float sb[16];
#pragma unroll
          for (int jj = 0; jj < 16; ++jj) sb[jj] = round_bf16(__ldg(sl + (size_t)grp * N + col0 + jj));
#pragma unroll 4
          for (int k = grp * g + kl; k < (grp + 1) * g; k += kKLanes) {
            const int4 v = load_row(wl, k, N, col0);
            const int8_t* by = reinterpret_cast<const int8_t*>(&v);
            const float xv = xs[k];
#pragma unroll
            for (int jj = 0; jj < 16; ++jj) p[jj] += xv * round_bf16((float)by[jj] * sb[jj]);
          }
        }
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) red[kl * kBlockCols + ct * 16 + jj] = p[jj];
        __syncthreads();
        float sub = 0.f;
        for (int i = 0; i < kKLanes; ++i) sub += red[i * kBlockCols + tid];
        total += sub;
        __syncthreads();
      }
      // slot tid is column col_of(tid / 16) + tid % 16; nsplit is 1
      partial[(size_t)l * N + b * kBlockCols + tid] = total;
      return;
    }
  } else {  // kInt8
    float* dq = xs;                                     // [ng]
    int8_t* xq = reinterpret_cast<int8_t*>(xs + ng);    // [K]
    for (int grp = tid; grp < ng; grp += kThreads) {
      float amax = 0.f;
      for (int k = grp * g; k < (grp + 1) * g; ++k)
        amax = fmaxf(amax, fabsf(__bfloat162float(x[k])));
      const float d = amax > 0.f ? amax / 127.0f : 1.0f;
      dq[grp] = d;
      for (int k = grp * g; k < (grp + 1) * g; ++k)
        xq[k] = (int8_t)(int)rintf(__bfloat162float(x[k]) / d);
    }
    __syncthreads();
    for (int grp = kl; grp < ng; grp += kKLanes) {
      int pi[16];
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) pi[jj] = 0;
#pragma unroll 2
      for (int k = grp * g; k < (grp + 1) * g; k += 4) {
        const int4 r0 = load_row(wl, k, N, col0), r1 = load_row(wl, k + 1, N, col0);
        const int4 r2 = load_row(wl, k + 2, N, col0), r3 = load_row(wl, k + 3, N, col0);
        dp4_rows(r0, r1, r2, r3, *reinterpret_cast<const int*>(xq + k), pi);
      }
      const float d = dq[grp];
      const float4* sp = reinterpret_cast<const float4*>(sl + (size_t)grp * N + col0);
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        const float4 sv = __ldg(sp + q4);
        acc[4 * q4 + 0] += ((float)pi[4 * q4 + 0] * d) * sv.x;
        acc[4 * q4 + 1] += ((float)pi[4 * q4 + 1] * d) * sv.y;
        acc[4 * q4 + 2] += ((float)pi[4 * q4 + 2] * d) * sv.z;
        acc[4 * q4 + 3] += ((float)pi[4 * q4 + 3] * d) * sv.w;
      }
    }
  }

  // The k-lanes' sums, added in lane order; nodot also adds the splits in
  // split order into the first TN outputs.
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) red[kl * kBlockCols + ct * 16 + jj] = acc[jj];
  __syncthreads();
  if (MODE == kNoDot) {
    if (tid < cw) {  // output column b * cw + tid, from slot (j, tid) of every split
      float v = 0.f;
      for (int jj = 0; jj < nsplit; ++jj)
        for (int i = 0; i < kKLanes; ++i) v += red[i * kBlockCols + jj * cw + tid];
      partial[(size_t)l * N + b * cw + tid] = v;
    }
  } else {
    float v = 0.f;
    for (int i = 0; i < kKLanes; ++i) v += red[i * kBlockCols + tid];
    const int c = tid / 16;
    const int col = (c / per_split) * TN + b * cw + (c % per_split) * 16 + tid % 16;
    partial[(size_t)l * N + col] = v;
  }
}

// y[n] = sum_l partial[l][n] in layer order for n < n_out, else 0.
__global__ void layers_finish(const float* __restrict__ partial, float* __restrict__ y,
                              int L, int N, int n_out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float acc = 0.f;
  if (n < n_out)
    for (int l = 0; l < L; ++l) acc += partial[(size_t)l * N + n];
  y[n] = acc;
}

template <int MODE>
cudaError_t launch(const int8_t* w, const float* s, const __nv_bfloat16* x,
                   float* partial, int* checksum, float* y, int L, int K, int N,
                   int g, int nsplit, cudaStream_t st) {
  const dim3 grid(N / kBlockCols, L);
  size_t smem = (size_t)kKLanes * kBlockCols * sizeof(float);
  if (MODE == kBf16 || MODE == kPlain8) smem += (size_t)K * sizeof(float);
  if (MODE == kInt8) smem += (size_t)(K / g) * sizeof(float) + K;
  int8_gemv_kernel<MODE><<<grid, kThreads, smem, st>>>(w, s, x, partial, checksum,
                                                        K, N, g, nsplit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_out = MODE == kNoDot ? N / nsplit : N;
  layers_finish<<<(N + 255) / 256, 256, 0, st>>>(partial, y, L, N, n_out);
  return cudaGetLastError();
}

}  // namespace

// w int8 [L, K, N], s fp32 [L, K / g, N], x bf16 [1, K], all row-major and
// 16-byte aligned; partial fp32 scratch [L, N]; checksum int32 scratch
// [L, N / 256]; y fp32 [1, N]. mode: 0 nodot, 1 bf16, 2 int8, 3 plain8.
// The wrapper checks N % 256 == 0, nsplit in {1, 2, 4, 8, 16}, K % g == 0,
// g % 4 == 0, K <= 8192 (shared memory) and, for plain8, K % 1024 == 0,
// 1024 % g == 0 and nsplit == 1. Returns the launches' cudaError_t.
extern "C" int exp_int8(const void* w, const void* s, const void* x, void* partial,
                        void* checksum, void* y, int L, int K, int N, int g,
                        int mode, int nsplit, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(s);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  float* pp = static_cast<float*>(partial);
  int* cp = static_cast<int*>(checksum);
  float* yp = static_cast<float*>(y);
  cudaError_t err;
  switch (mode) {
    case kNoDot: err = launch<kNoDot>(wp, sp, xp, pp, cp, yp, L, K, N, g, nsplit, st); break;
    case kBf16: err = launch<kBf16>(wp, sp, xp, pp, cp, yp, L, K, N, g, nsplit, st); break;
    case kInt8: err = launch<kInt8>(wp, sp, xp, pp, cp, yp, L, K, N, g, nsplit, st); break;
    case kPlain8: err = launch<kPlain8>(wp, sp, xp, pp, cp, yp, L, K, N, g, nsplit, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
