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
// bytes and does one add per byte; the outscale matmul reads q once and
// does 2 M multiply-adds per weight byte on the tensor cores. At the
// TinyLlama-1.1B shapes the bytes take 1.3-21 us, the same order as a
// launch's fixed cost, so a call must be one launch that fills the card at
// once.
//
// What the designs do about it:
//   * stream: a (tk, tn) tile is split along its rows across r blocks, r
//     from the SM count (tools/exp_kernel.py `stream_plan`) so that
//     every shape's grid has at least two blocks per SM; split sp takes rows
//     [sp tk / r, (sp + 1) tk / r). 256 threads, each with eight 16-byte
//     loads in flight, sum bytes exactly in int32 by __dp4a against
//     0x01010101 (a byte at a time where tn or N is not a multiple of 16 or
//     q is not 16-byte aligned). Integer sums are exact, so the split
//     changes no tile's sum. Each block writes its sum to a scratch array
//     (so no load is dead); the blocks of the last column tile take a
//     ticket from a counter, and the last of them adds that column's
//     partials per tile in int64 and the tiles as fp32 in k order, the TPU
//     kernel's order: one launch a call. (Adding a tile's splits first
//     inside thread-block clusters, through distributed shared memory,
//     measured slower on the H100: tools/probe_costs.py, PERF.md.)
//   * outscale: the GEMM's pipeline (csrc/quant_gemm.cu) with the scales
//     moved to the output. A block takes 128 columns (4 warps of 32) and a
//     run of whole 64-row groups of one k-tile: each k-tile's tk / 64 groups
//     are split across r blocks (tools/exp_kernel.py `outscale_plan`), so
//     that every shape's grid has at least two blocks per SM. A 4-stage ring
//     of cp.async 16-byte copies holds one group a stage: its 64 x 128 int8
//     weight tile (XOR-swizzled by k-row), the group's x rows in x's dtype
//     and its row of scales, so a block keeps 24 KB of weight in flight.
//     int8 becomes an exact fp32 by a byte permute into 2^23 + (q + 128) and
//     one subtraction, and two such values pack into bf16x2 by a byte
//     permute; the weight is not scaled before the product. mma.sync
//     m16n8k16 (bf16 in, fp32 accumulate) runs with the roles swapped: the
//     weight columns are the 16-row A operand and x^T the n8 B operand, so
//     M <= 8 is one n8 tile and M <= 16 two, rows >= M zero-filled by the
//     copies. A group's four k16 steps go into a zeroed fragment, which is
//     then multiplied by s[group, n] in fp32 and added to the running
//     accumulators: product first, scale after, as the TPU kernel. The
//     splits write fp32 partials; the last block of a column tile (a
//     self-resetting counter) adds them in split order, then the k-tiles in
//     k order, and rounds once to bf16. No float atomics: results repeat
//     bit for bit.
// Scratch and counters are reused from call to call on one stream: two
// streams must not share them (the wrappers keep one set per device).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// Thread 0's ticket on a split counter: one atomic add with acquire-release
// semantics at device scope, which orders the block's partial writes (made
// before a __syncthreads) before it, and the writes of the blocks that took
// earlier tickets before what this block reads after it. Returns the old count.
__device__ __forceinline__ unsigned ticket(unsigned* counter) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n"
               : "=r"(old) : "l"(counter) : "memory");
  return old;
}

// ---------------------------------------------------------------------------
// stream

constexpr int kStreamThreads = 256;
constexpr int kUnroll = 8;  // 16-byte loads in flight a thread

__device__ __forceinline__ int sum16(const int4 v, int acc) {
  acc = __dp4a(v.x, 0x01010101, acc);
  acc = __dp4a(v.y, 0x01010101, acc);
  acc = __dp4a(v.z, 0x01010101, acc);
  return __dp4a(v.w, 0x01010101, acc);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's int32 sum, valid in thread 0.
__device__ __forceinline__ int block_sum(int v) {
  __shared__ int warps[kStreamThreads / 32];
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) warps[threadIdx.x / 32] = v;
  __syncthreads();
  v = threadIdx.x < kStreamThreads / 32 ? warps[threadIdx.x] : 0;
  return threadIdx.x < 32 ? warp_sum(v) : 0;
}

// Block (j, z) of the grid (N / tn, (K / tk) r): column tile j, k-tile
// z / r, its rows [sp tk / r, (sp + 1) tk / r) with sp = z % r. partial
// holds one int per block; counter is zero between launches. VEC: tn % 16
// == 0, N % 16 == 0, q 16-byte aligned.
template <bool VEC>
__global__ void __launch_bounds__(kStreamThreads)
stream_kernel(const int8_t* __restrict__ q, int* __restrict__ partial,
              unsigned* __restrict__ counter, float* __restrict__ out, int N,
              int tk, int tn, int r) {
  const int j = blockIdx.x, z = blockIdx.y, kt = z / r, sp = z % r;
  const int r0 = (int)((long long)sp * tk / r);
  const int rows = (int)((long long)(sp + 1) * tk / r) - r0;
  const int8_t* base = q + ((size_t)kt * tk + r0) * N + (size_t)j * tn;
  int acc = 0;
  if (VEC) {
    const unsigned vpr = tn / 16;  // 16-byte vectors per tile row
    const unsigned nv = (unsigned)rows * vpr;
    for (unsigned i = threadIdx.x; i < nv; i += kUnroll * kStreamThreads) {
      int4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned e = i + u * kStreamThreads;
        v[u] = e < nv ? __ldg(reinterpret_cast<const int4*>(base + (size_t)(e / vpr) * N) + e % vpr)
                      : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc = sum16(v[u], acc);
    }
  } else {
    const unsigned ne = (unsigned)rows * tn;
    for (unsigned e = threadIdx.x; e < ne; e += kStreamThreads)
      acc += base[(size_t)(e / tn) * N + e % tn];
  }
  const int v = block_sum(acc);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partial[(size_t)j * gridDim.y + z] = v;
    // only the last column tile's blocks count: its sums are the value
    last = j == gridDim.x - 1 && ticket(counter) == gridDim.y - 1;
  }
  __syncthreads();
  if (!last) return;
  // Tile sums of the last column in int64 (warp w takes tiles w, w + 8, ...),
  // then thread 0 adds them as fp32 in k order.
  const int n_k = gridDim.y / r, P = r;
  const int* p = partial + (size_t)j * gridDim.y;
  __shared__ float tiles[kStreamThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float total = 0.f;
  for (int k0 = 0; k0 < n_k; k0 += kStreamThreads / 32) {
    const int k = k0 + warp;
    if (k < n_k) {
      long long t = 0;
      for (int i0 = 0; i0 < P; i0 += 32 * kUnroll) {
        int pv[kUnroll];  // a lane's loads of this round, all in flight
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + 32 * u + lane;
          pv[u] = i < P ? __ldcg(p + (size_t)k * P + i) : 0;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) t += pv[u];
      }
      t = warp_sum(t);
      if (lane == 0) tiles[warp] = (float)t;
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int i = 0; i < kStreamThreads / 32 && k0 + i < n_k; ++i) total += tiles[i];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[0] = total;
    *counter = 0u;
  }
}

// ---------------------------------------------------------------------------
// outscale

constexpr int kG = 64;           // rows per scale group (the tool's G): one ring stage
constexpr int kOsBN = 128;       // weight columns per block: 4 warps x 32
constexpr int kOsThreads = 128;
constexpr int kOsStages = 4;
constexpr int kSubK = 16;        // K rows per mma step

// One ring stage: the int8 weight tile [kG][kOsBN] (32-byte column blocks
// XOR-swizzled by (k / 4) % 4), the x tile [NT * 8][kXLd] in x's dtype (16
// bytes of padding per row) and the group's scale row [kOsBN] in the
// scales' dtype. Every part is a multiple of 16 bytes.
template <typename XT, typename ST, int NT>
struct Stage {
  static constexpr int kXLd = kG + 16 / (int)sizeof(XT);
  static constexpr int kW = kG * kOsBN;
  static constexpr int kX = NT * 8 * kXLd * (int)sizeof(XT);
  static constexpr int kS = kOsBN * (int)sizeof(ST);
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

// Fills one stage with group grp (K rows [64 grp, +64)) of the block's
// columns [n0, n0 + 128). vec: x and s 16-byte aligned (q always is).
template <typename XT, typename ST, int NT>
__device__ __forceinline__ void load_stage(
    unsigned char* st, const XT* __restrict__ x, const int8_t* __restrict__ q,
    const ST* __restrict__ s, int M, int K, int N, int n0, int grp, bool vec) {
  using L = Stage<XT, ST, NT>;
  int8_t* ws = reinterpret_cast<int8_t*>(st);
  XT* xs = reinterpret_cast<XT*>(st + L::kW);
  ST* ss = reinterpret_cast<ST*>(st + L::kW + L::kX);
  const int tid = threadIdx.x, k0 = grp * kG;
  constexpr int WC = kOsBN / 16;
  for (int i = tid; i < kG * WC; i += kOsThreads) {
    const int r = i / WC, c = (i % WC) * 16;
    const bool in = n0 + c < N;
    cp_async16(ws + r * kOsBN + swz(r, c), in ? q + (size_t)(k0 + r) * N + n0 + c : q, in);
  }
  if (vec) {
    constexpr int XE = 16 / sizeof(XT), XC = kG / XE;
    for (int i = tid; i < NT * 8 * XC; i += kOsThreads) {
      const int r = i / XC, c = (i % XC) * XE;
      const bool in = r < M;
      cp_async16(xs + r * L::kXLd + c, in ? x + (size_t)r * K + k0 + c : x, in);
    }
    constexpr int SE = 16 / sizeof(ST), SC = kOsBN / SE;
    for (int i = tid; i < SC; i += kOsThreads) {
      const int c = i * SE;
      const bool in = n0 + c < N;
      cp_async16(ss + c, in ? s + (size_t)grp * N + n0 + c : s, in);
    }
  } else {
    for (int i = tid; i < NT * 8 * kG; i += kOsThreads) {
      const int r = i / kG, c = i % kG;
      xs[r * L::kXLd + c] = r < M ? x[(size_t)r * K + k0 + c] : zero<XT>();
    }
    for (int c = tid; c < kOsBN; c += kOsThreads)
      ss[c] = n0 + c < N ? s[(size_t)grp * N + n0 + c] : zero<ST>();
  }
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}
// byte i of the sign-flipped word u (q + 128) as the exact fp32 q
__device__ __forceinline__ float q_at(uint32_t u, int i) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) - 8388736.f;
}
// two exact integer-valued floats as bf16x2 (their upper halves)
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// The scales of columns c .. c + 3 from the stage's scale row, as fp32.
__device__ __forceinline__ void scale4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void scale4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(v.x << 16);
  o[1] = __uint_as_float(v.x & 0xFFFF0000u);
  o[2] = __uint_as_float(v.y << 16);
  o[3] = __uint_as_float(v.y & 0xFFFF0000u);
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

// Multiplies one stage (one group) and adds its scaled product into acc.
// Lane (gr = lane / 4, t = lane % 4) of warp w owns block columns
// c = 32 w + 4 gr .. +3; in each 16-row step it reads k-rows 4t .. 4t+3 of
// them, so its mma k-slots (2t, 2t+1 | 2t+8, 2t+9) stand for k-rows
// (4t, 4t+1 | 4t+2, 4t+3), in A and in B alike. Column c + 0 / c + 1 are
// rows gr / gr + 8 of m16 tile 0, c + 2 / c + 3 those of tile 1; n8 tile nt
// holds x rows 8 nt .. 8 nt + 7. Fragment element e of tile a is column
// c + 2a + e / 2, x row 8 nt + 2t + e % 2.
template <typename XT, typename ST, int NT>
__device__ __forceinline__ void compute_group(const unsigned char* st,
                                              float (&acc)[2][NT][4]) {
  using L = Stage<XT, ST, NT>;
  const int8_t* ws = reinterpret_cast<const int8_t*>(st);
  const XT* xs = reinterpret_cast<const XT*>(st + L::kW);
  const ST* ss = reinterpret_cast<const ST*>(st + L::kW + L::kX);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, t = lane & 3;
  const int col = warp * 32 + 4 * gr;
  float f[2][NT][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) f[a][nt][e] = 0.f;
#pragma unroll
  for (int sub = 0; sub < kG / kSubK; ++sub) {
    uint32_t u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = sub * kSubK + 4 * t + j;
      u[j] = *reinterpret_cast<const uint32_t*>(ws + r * kOsBN + swz(r, col)) ^ 0x80808080u;
    }
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lo[i] = pack_exact(q_at(u[0], i), q_at(u[1], i));
      hi[i] = pack_exact(q_at(u[2], i), q_at(u[3], i));
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t b0, b1;
      x_frag(xs + (nt * 8 + gr) * L::kXLd + sub * kSubK + 4 * t, b0, b1);
      mma_bf16(f[0][nt], lo[0], lo[1], hi[0], hi[1], b0, b1);
      mma_bf16(f[1][nt], lo[2], lo[3], hi[2], hi[3], b0, b1);
    }
  }
  float sc[4];
  scale4(ss + col, sc);
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[a][nt][e] = __fmaf_rn(f[a][nt][e], sc[2 * a + e / 2], acc[a][nt][e]);
}

__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* p, float a, float b, float c,
                                             float d) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_rn(a, b), pack_rn(c, d));
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Block (blockIdx.x, z): columns [128 blockIdx.x, +128) over split sp = z % r
// of k-tile kt = z / r, its groups [kt ng + sp ng / r, kt ng + (sp + 1) ng / r)
// with ng = tk / 64. One split (gridDim.y == 1) writes y; else each writes
// its fp32 partial [z][M][N], and the column tile's last block sums them.
template <typename XT, typename ST, int NT>
__global__ void __launch_bounds__(kOsThreads)
outscale_kernel(const XT* __restrict__ x, const int8_t* __restrict__ q,
                const ST* __restrict__ s, float* __restrict__ partial,
                unsigned* __restrict__ counters, __nv_bfloat16* __restrict__ y, int M,
                int K, int N, int tk, int r, bool vec) {
  using L = Stage<XT, ST, NT>;
  extern __shared__ __align__(128) unsigned char ring[];
  const int n0 = blockIdx.x * kOsBN, z = blockIdx.y;
  const int ngt = tk / kG, kt = z / r, sp = z % r;
  const int g0 = kt * ngt + sp * ngt / r;
  const int ng = kt * ngt + (sp + 1) * ngt / r - g0;

  float acc[2][NT][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][nt][e] = 0.f;

#pragma unroll
  for (int i = 0; i < kOsStages - 1; ++i) {
    if (i < ng)
      load_stage<XT, ST, NT>(ring + i * L::kBytes, x, q, s, M, K, N, n0, g0 + i, vec);
    cp_async_commit();
  }
  for (int it = 0; it < ng; ++it) {
    cp_async_wait<kOsStages - 2>();  // stage it has landed
    __syncthreads();                 // and every warp is done with stage it - 1
    const int next = it + kOsStages - 1;
    if (next < ng)
      load_stage<XT, ST, NT>(ring + (next % kOsStages) * L::kBytes, x, q, s, M, K, N, n0,
                             g0 + next, vec);
    cp_async_commit();
    compute_group<XT, ST, NT>(ring + (it % kOsStages) * L::kBytes, acc);
  }

  // this thread's outputs: x rows 8 nt + 2t + e, columns n .. n + 3
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = n0 + warp * 32 + 4 * (lane >> 2), t = lane & 3;
  const bool direct = gridDim.y == 1;
  if (n < N) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = nt * 8 + 2 * t + e;
        if (m >= M) continue;
        if (direct)
          store_bf16x4(y + (size_t)m * N + n, acc[0][nt][e], acc[0][nt][2 + e],
                       acc[1][nt][e], acc[1][nt][2 + e]);
        else
          *reinterpret_cast<float4*>(partial + ((size_t)z * M + m) * N + n) =
              make_float4(acc[0][nt][e], acc[0][nt][2 + e], acc[1][nt][e], acc[1][nt][2 + e]);
      }
  }
  if (direct) return;

  // The last block of this column tile to finish sums the splits' partials.
  // Thread (w = tid / 32, lane): columns c .. c + 3 of rows w, w + 4, ...; SB
  // splits' loads in flight, added in split order, k-tile by k-tile.
  __shared__ bool last;
  __syncthreads();
  if (tid == 0) last = ticket(counters + blockIdx.x) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  constexpr int RM = 2 * NT, SB = 8 / NT;
  const int c = n0 + 4 * lane, Z = gridDim.y;
  if (c < N) {
    float4 tot[RM], til[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) tot[i] = til[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z0 = 0; z0 < Z; z0 += SB) {
      float4 v[SB][RM];
#pragma unroll
      for (int b = 0; b < SB; ++b)
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int m = warp + 4 * i;
          v[b][i] = z0 + b < Z && m < M
                        ? __ldcg(reinterpret_cast<const float4*>(
                              partial + ((size_t)(z0 + b) * M + m) * N + c))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int b = 0; b < SB; ++b) {
        if (z0 + b >= Z) break;
        const int spz = (z0 + b) % r;
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          til[i] = spz == 0 ? v[b][i] : add4(til[i], v[b][i]);
          if (spz == r - 1) tot[i] = add4(tot[i], til[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int m = warp + 4 * i;
      if (m < M) store_bf16x4(y + (size_t)m * N + c, tot[i].x, tot[i].y, tot[i].z, tot[i].w);
    }
  }
  if (tid == 0) counters[blockIdx.x] = 0u;
}

template <typename XT, typename ST, int NT>
cudaError_t launch_outscale(const void* x, const void* q, const void* s, void* partial,
                            void* counters, void* y, int M, int K, int N, int tk, int r,
                            bool vec, cudaStream_t st) {
  constexpr int smem = kOsStages * Stage<XT, ST, NT>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      outscale_kernel<XT, ST, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((N + kOsBN - 1) / kOsBN, (K / tk) * r);
  outscale_kernel<XT, ST, NT><<<grid, kOsThreads, smem, st>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(q), static_cast<const ST*>(s),
      static_cast<float*>(partial), static_cast<unsigned*>(counters),
      static_cast<__nv_bfloat16*>(y), M, K, N, tk, r, vec);
  return cudaGetLastError();
}

template <typename XT, typename ST>
cudaError_t outscale_m(const void* x, const void* q, const void* s, void* partial,
                       void* counters, void* y, int M, int K, int N, int tk, int r,
                       bool vec, cudaStream_t st) {
  if (M <= 8)
    return launch_outscale<XT, ST, 1>(x, q, s, partial, counters, y, M, K, N, tk, r, vec, st);
  return launch_outscale<XT, ST, 2>(x, q, s, partial, counters, y, M, K, N, tk, r, vec, st);
}

// ---------------------------------------------------------------------------
// probes of the launch itself

// The call's fixed floor: one block that does nothing.
__global__ void empty_kernel() {}

// Cooperative launch with clusters: each block reads its neighbour's
// shared memory inside its cluster, then the whole grid meets at a grid
// barrier; block 0 counts the blocks that read the right value into
// flags[gridDim.x].
__global__ void coop_cluster_kernel(int* flags) {
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cl = cg::this_cluster();
  __shared__ int mine;
  if (threadIdx.x == 0) mine = blockIdx.x;
  cl.sync();
  const unsigned peer = (cl.block_rank() + 1) % cl.num_blocks();
  const int got = *cl.map_shared_rank(&mine, peer);
  cl.sync();
  if (threadIdx.x == 0) flags[blockIdx.x] = got == (int)(blockIdx.x - cl.block_rank() + peer);
  if (!grid.is_valid()) return;  // not launched cooperatively: no grid barrier
  grid.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int n = 0;
    for (unsigned b = 0; b < gridDim.x; ++b) n += flags[b];
    flags[gridDim.x] = n;
  }
}

}  // namespace

// q [K, N] int8 row-major; partial int32 scratch [N / tn, (K / tk) r];
// counter one uint32, zero between launches; out [1] fp32. K % tk == 0,
// N % tn == 0, 1 <= r <= tk. vec: tn % 16 == 0, N % 16 == 0 and q 16-byte
// aligned. Returns the launch's cudaError_t.
extern "C" int exp_stream(const void* q, void* partial, void* counter, void* out, int K,
                          int N, int tk, int tn, int r, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r < 1 || r > tk) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(N / tn, (K / tk) * r);
  const int8_t* qp = static_cast<const int8_t*>(q);
  int* pp = static_cast<int*>(partial);
  unsigned* cp = static_cast<unsigned*>(counter);
  float* op = static_cast<float*>(out);
  if (vec) stream_kernel<true><<<grid, kStreamThreads, 0, st>>>(qp, pp, cp, op, N, tk, tn, r);
  else stream_kernel<false><<<grid, kStreamThreads, 0, st>>>(qp, pp, cp, op, N, tk, tn, r);
  return static_cast<int>(cudaGetLastError());
}

// x [M, K] (fp32 or bf16), q [K, N] int8 and s [>= K / 64, N] (fp32 or
// bf16) row-major; partial fp32 scratch [(K / tk) r, M, N] (unused when
// (K / tk) r == 1); counters uint32 [ceil(N / 128)], zero between launches;
// y bf16 [M, N]. M <= 16, K % tk == 0, tk % 64 == 0, 1 <= r <= tk / 64,
// N % 64 == 0, q 16-byte aligned; vec: x and s 16-byte aligned. Returns the
// launch's cudaError_t.
extern "C" int exp_outscale(const void* x, int x_bf16, const void* q, const void* s,
                            int s_bf16, void* partial, void* counters, void* y, int M,
                            int K, int N, int tk, int r, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || M > 16 || tk % kG || r < 1 || r > tk / kG)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (x_bf16)
    err = s_bf16 ? outscale_m<__nv_bfloat16, __nv_bfloat16>(x, q, s, partial, counters, y, M, K, N, tk, r, vec, st)
                 : outscale_m<__nv_bfloat16, float>(x, q, s, partial, counters, y, M, K, N, tk, r, vec, st);
  else
    err = s_bf16 ? outscale_m<float, __nv_bfloat16>(x, q, s, partial, counters, y, M, K, N, tk, r, vec, st)
                 : outscale_m<float, float>(x, q, s, partial, counters, y, M, K, N, tk, r, vec, st);
  return static_cast<int>(err);
}

// One launch of an empty kernel: what a call through this library costs
// before any work. Returns the launch's cudaError_t.
extern "C" int exp_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// One launch of coop_cluster_kernel (blocks of 32 threads, clusters of
// `cluster` blocks along x) with the cooperative attribute and a cluster
// dimension together, through cudaLaunchKernelEx; flags int32 [blocks + 1].
// Returns the launch's cudaError_t: whether the card takes both at once.
extern "C" int exp_coop_cluster(void* flags, int blocks, int cluster, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(32);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = cluster;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, coop_cluster_kernel, static_cast<int*>(flags));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the answer is the code, not a fault
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
