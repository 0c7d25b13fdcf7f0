// B = 1 decode megakernel for Hopper (sm_90a): one launch computes a whole
// decode step of the layer stack.
//
// Replaces the TPU kernel kuiperllama_tpu/ops/pallas/fused_decode.py
// `_kernel` (entry `fused_decode_step`), which the JAX Generator takes by
// default for TinyLlama-1.1B, Llama-3.2-1B and Qwen2.5-0.5B. It computes
// what `_kernel` computes, with its rounding points:
//   per layer   h1 = bf16(rmsnorm(x)); y = bf16(h1 @ wqkv (+ bias))
//               q, k = bf16(rope(q, k)) (two fp32 products and one add each)
//               attention over slots < pos in fp32, the new token's score
//               merged analytically, p rounded to the cache dtype before
//               the pv product; attn = bf16(pv / denom)
//               x = bf16(x + attn @ wo)
//               h2 = bf16(rmsnorm(x)); gate, up = bf16(h2 @ w13)
//               act = bf16(bf16(silu(gate)) * up); x = bf16(x + act @ w2)
//   at the end  x_out = bf16(rmsnorm(x))
// The new K/V row of every layer is written into the caches at slot pos in
// place (attention reads only slots < pos, so there is no hazard).
//
// Two GEMV flavours, chosen per projection by the host (the JAX rule on its
// padded group rows, ops/tuning.py):
//   bf16 activation: per-group fp32 partials of bf16(h) x q, times the fp32
//     scales, summed over groups;
//   int8 activation: d = amax/127 per group (1 where amax is 0),
//     Aq = rint(h / d), exact int32 dot products with __dp4a on 4x4 byte
//     transposes of the weight, then sum(float(Pi) * d * s).
// Each k-lane scales its own share of a group's partial, and K splits are
// summed in a fixed order, so the result differs from the plain version
// only in fp32 summation order and repeats bit for bit from run to run.
//
// What bounds it on this card: bytes. Every weight byte is used once per
// step. TinyLlama-1.1B's 22 layers stream 976.5 MB of int8 weights and bf16
// scales per step, 0.291 ms at 3.35 TB/s; Qwen2.5-0.5B's 24 layers stream
// 715.7 MB of bf16, 0.214 ms. The design aims at that stream and at the
// host, which bounds the layered path:
//   * one cooperative persistent launch (cudaLaunchCooperativeKernel) per
//     step, the grid sized from the occupancy query (at most 2 blocks per
//     SM), so the host issues one launch instead of about 70 per layer;
//   * phases per layer (qkv | attention | wo | gate/up | w2) separated by a
//     grid-wide barrier (cooperative groups); every block forms the normed
//     activation itself (d <= 2048 is cheap), so no extra phase is needed;
//   * each GEMV phase is cut into (column tile, K split) work items, the
//     tile 64 to 256 columns wide so that every block gets an item even at
//     N = 2048; a thread owns 16 adjacent int8 columns (8 bf16, 4 fp32) and
//     reads them as one 16-byte load per row;
//   * K splits write fp32 partials; the last block of a tile to finish (an
//     integer counter, no float atomics) sums them in split order and runs
//     the phase's epilogue (bias, residual, SwiGLU).
// This first version is simple on purpose: no TMA, no wgmma, and the
// phase barriers drain the memory pipeline five times per layer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>

// Mirror of `_Args` in ops/kernels/fused_decode.py, field for field.
struct FusedArgs {
  const void* wqkv; const void* wqkv_s; const void* wo; const void* wo_s;
  const void* w13; const void* w13_s; const void* w2; const void* w2_s;
  const void* bqkv;
  const void* attn_norm; const void* ffn_norm; const void* final_norm;
  const void* x0; void* x_out; void* k_cache; void* v_cache;
  const void* pos; const void* sin; const void* cos;
  void* x; void* qkv; void* attn; void* act; void* partial; void* counters;
  unsigned long long* trace;  // optional: nullptr, or 2 + 5 L timestamps
  long long cache_layer_stride;
  int L, d, H, KH, hd, hidden, A, seq_len, g;
  int s_rows_qkv, s_rows_wo, s_rows_w13, s_rows_w2;
  int w_kind, s_bf16, x_bf16, cache_bf16, bias_bf16, has_bias, rope_half;
  int int8_act[4], col_threads[4], units_per_split[4];
  int grid, smem_bytes;
  float eps, scale;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRedFloats = 4096;
constexpr int kDenseUnitRows = 64;
constexpr float kNegInf = -1e30f;
enum { W_INT8 = 0, W_BF16 = 1, W_FP32 = 2 };
enum { P_QKV = 0, P_WO = 1, P_W13 = 2, P_W2 = 3 };

template <int KIND> struct Cols;
template <> struct Cols<W_INT8> { static constexpr int n = 16; };
template <> struct Cols<W_BF16> { static constexpr int n = 8; };
template <> struct Cols<W_FP32> { static constexpr int n = 4; };

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bf2f(unsigned short u) {
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}
// Reads of buffers that other blocks write during the launch go through L2
// (ld.global.cg): an SM's L1 is not coherent with the others.
__device__ __forceinline__ float ld_bf16_cg(const __nv_bfloat16* p) {
  return bf2f(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16*) { return bf16r(v); }

// Grid-wide barrier between phases: cooperative groups' grid sync, which the
// cooperative launch makes safe (every block is resident).
__device__ __forceinline__ void grid_sync() { cooperative_groups::this_grid().sync(); }

// Sum and max over the block in a fixed order; every thread gets the result.
__device__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) t += scratch[i];
  return t;
}

__device__ float block_max(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = scratch[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) t = fmaxf(t, scratch[i]);
  return t;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float load_x(const FusedArgs& a, bool first, int k) {
  if (first) {
    return a.x_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.x0)[k])
                    : static_cast<const float*>(a.x0)[k];
  }
  return __ldcg(static_cast<const float*>(a.x) + k);
}

// Eight consecutive values as fp32 through L2 (one or two 16-byte loads).
__device__ __forceinline__ void ld8_cg(const float* p, float* o) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void ld8_cg(const __nv_bfloat16* p, float* o) {
  const int4 v = __ldcg(reinterpret_cast<const int4*>(p));
  const unsigned short* u = reinterpret_cast<const unsigned short*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = bf2f(u[j]);
}

// hs[k] = src[k] for k < K (K % 8 == 0), 16-byte loads unrolled so that
// they are in flight together; returns this thread's sum of squares.
template <typename T>
__device__ float stage8(const T* __restrict__ src, int K, float* __restrict__ hs) {
  float ss = 0.f;
#pragma unroll 4
  for (int k = threadIdx.x * 8; k < K; k += kThreads * 8) {
    float v[8];
    ld8_cg(src + k, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      hs[k + j] = v[j];
      ss = fmaf(v[j], v[j], ss);
    }
  }
  return ss;
}

// hs[k] = bf16(rmsnorm(x)[k] * w[k]) for k < d (the JAX kernel's `_rmsnorm`).
__device__ void stage_norm(const FusedArgs& a, bool first, const float* w,
                           float* hs, float* scratch) {
  float ss;
  if (!first) ss = stage8(static_cast<const float*>(a.x), a.d, hs);
  else if (a.x_bf16) ss = stage8(static_cast<const __nv_bfloat16*>(a.x0), a.d, hs);
  else ss = stage8(static_cast<const float*>(a.x0), a.d, hs);
  const float ms = block_sum(ss, scratch) / static_cast<float>(a.d);
  const float r = 1.f / sqrtf(ms + a.eps);
  for (int k = threadIdx.x; k < a.d; k += kThreads) hs[k] = bf16r(hs[k] * r * w[k]);
  __syncthreads();
}

__device__ void stage_bf16(const __nv_bfloat16* src, int K, float* hs) {
  stage8(src, K, hs);
  __syncthreads();
}

// Per-group int8 quantization of hs (the JAX `_quant_act`): four consecutive
// k packed little-endian into one int, ready for __dp4a.
__device__ void quantize_act(const float* hs, int K, int g, int* aq, float* dg) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int grp = warp; grp < K / g; grp += kWarps) {
    const float* hp = hs + grp * g;
    float m = 0.f;
    for (int e = lane; e < g; e += 32) m = fmaxf(m, fabsf(hp[e]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float dd = m > 0.f ? m / 127.f : 1.f;
    if (lane == 0) dg[grp] = dd;
    for (int c = lane; c < g / 4; c += 32) {
      unsigned int packed = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qv = static_cast<int>(rintf(hp[4 * c + i] / dd));
        packed |= (static_cast<unsigned int>(qv) & 0xffu) << (8 * i);
      }
      aq[(grp * g) / 4 + c] = static_cast<int>(packed);
    }
  }
  __syncthreads();
}

// 16 consecutive scales of one group row, fp32 or bf16 in memory.
__device__ __forceinline__ void load_scales16(const void* s, int s_bf16, size_t off,
                                              float* sc) {
  if (s_bf16) {
    const int4* p = reinterpret_cast<const int4*>(static_cast<const __nv_bfloat16*>(s) + off);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int4 v = __ldg(p + h);
      const unsigned short* u = reinterpret_cast<const unsigned short*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[8 * h + j] = bf2f(u[j]);
    }
  } else {
    const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(s) + off);
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float4 v = __ldg(p + h);
      sc[4 * h] = v.x; sc[4 * h + 1] = v.y; sc[4 * h + 2] = v.z; sc[4 * h + 3] = v.w;
    }
  }
}

// acc[j] (this thread's columns) over rows [row0, row1) of one layer's weight.
template <int KIND>
__device__ __forceinline__ void gemv_accumulate(
    const void* w, const void* s, int s_bf16, int N, int col0, int row0, int row1,
    int g, bool int8a, const float* hs, const int* aq, const float* dg, int kl,
    int klanes, float* acc) {
  constexpr int CPT = Cols<KIND>::n;
  if constexpr (KIND == W_INT8) {
    const int8_t* q = static_cast<const int8_t*>(w);
    for (int grp = row0 / g; grp < row1 / g; ++grp) {
      const int kb = grp * g;
      float sc[16];
      // the group's scales are loaded first, so their latency overlaps the rows'
      load_scales16(s, s_bf16, (size_t)grp * N + col0, sc);
      if (int8a) {
        int ip[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) ip[j] = 0;
#pragma unroll 2
        for (int c = kl; c < g / 4; c += klanes) {
          const int row = kb + 4 * c;
          const int a4 = aq[row / 4];
          int4 r[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            r[i] = __ldg(reinterpret_cast<const int4*>(q + (size_t)(row + i) * N + col0));
          const unsigned int* w0 = reinterpret_cast<const unsigned int*>(&r[0]);
          const unsigned int* w1 = reinterpret_cast<const unsigned int*>(&r[1]);
          const unsigned int* w2 = reinterpret_cast<const unsigned int*>(&r[2]);
          const unsigned int* w3 = reinterpret_cast<const unsigned int*>(&r[3]);
#pragma unroll
          for (int wi = 0; wi < 4; ++wi) {
            // 4x4 byte transpose: column c gets (row0[c], row1[c], row2[c], row3[c])
            const unsigned int t0 = __byte_perm(w0[wi], w1[wi], 0x5140);
            const unsigned int t1 = __byte_perm(w2[wi], w3[wi], 0x5140);
            const unsigned int t2 = __byte_perm(w0[wi], w1[wi], 0x7362);
            const unsigned int t3 = __byte_perm(w2[wi], w3[wi], 0x7362);
            ip[4 * wi + 0] = __dp4a(static_cast<int>(__byte_perm(t0, t1, 0x5410)), a4, ip[4 * wi + 0]);
            ip[4 * wi + 1] = __dp4a(static_cast<int>(__byte_perm(t0, t1, 0x7632)), a4, ip[4 * wi + 1]);
            ip[4 * wi + 2] = __dp4a(static_cast<int>(__byte_perm(t2, t3, 0x5410)), a4, ip[4 * wi + 2]);
            ip[4 * wi + 3] = __dp4a(static_cast<int>(__byte_perm(t2, t3, 0x7632)), a4, ip[4 * wi + 3]);
          }
        }
        const float dd = dg[grp];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          acc[j] = fmaf(__fmul_rn(static_cast<float>(ip[j]), dd), sc[j], acc[j]);
      } else {
        float part[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) part[j] = 0.f;
#pragma unroll 4
        for (int k = kl; k < g; k += klanes) {
          const float xv = hs[kb + k];
          const int4 v = __ldg(reinterpret_cast<const int4*>(q + (size_t)(kb + k) * N + col0));
          const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
          for (int j = 0; j < 16; ++j) part[j] = fmaf(xv, static_cast<float>(b[j]), part[j]);
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[j] = fmaf(part[j], sc[j], acc[j]);
      }
    }
  } else if constexpr (KIND == W_BF16) {
    const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(w);
#pragma unroll 4
    for (int row = row0 + kl; row < row1; row += klanes) {
      const float xv = hs[row];
      const int4 v = __ldg(reinterpret_cast<const int4*>(wp + (size_t)row * N + col0));
      const unsigned short* u = reinterpret_cast<const unsigned short*>(&v);
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[j] = fmaf(xv, bf2f(u[j]), acc[j]);
    }
  } else {
    const float* wp = static_cast<const float*>(w);
#pragma unroll 4
    for (int row = row0 + kl; row < row1; row += klanes) {
      const float xv = hs[row];
      const float4 v = __ldg(reinterpret_cast<const float4*>(wp + (size_t)row * N + col0));
      acc[0] = fmaf(xv, v.x, acc[0]);
      acc[1] = fmaf(xv, v.y, acc[1]);
      acc[2] = fmaf(xv, v.z, acc[2]);
      acc[3] = fmaf(xv, v.w, acc[3]);
    }
  }
}

struct Smem {
  float* hs; int* aq; float* dg; float* red; float* red2; float* out; float* misc;
};

// One column tile of one K split: out[c] for the W = ct * CPT columns from
// col_base, summed over the block's k-lanes in a fixed order.
template <int KIND>
__device__ void gemv_tile(const void* w, const void* s, int s_bf16, int N,
                          int col_base, int col_end, int row0, int row1, int g,
                          bool int8a, int ct, const Smem& sm, float* out) {
  constexpr int CPT = Cols<KIND>::n;
  const int tid = threadIdx.x;
  const int W = ct * CPT;
  const int klanes = kThreads / ct;
  const int cthr = tid % ct, kl = tid / ct;
  const int col0 = col_base + cthr * CPT;
  float acc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) acc[j] = 0.f;
  if (col0 < col_end)  // widths are multiples of CPT: a run is wholly in or out
    gemv_accumulate<KIND>(w, s, s_bf16, N, col0, row0, row1, g, int8a, sm.hs, sm.aq,
                          sm.dg, kl, klanes, acc);
#pragma unroll
  for (int j = 0; j < CPT; ++j) sm.red[kl * W + cthr * CPT + j] = acc[j];
  __syncthreads();
  const int P = kThreads / W;  // W divides 256
  {
    const int c = tid % W, part = tid / W;
    float t = 0.f;
    for (int l = part; l < klanes; l += P) t += sm.red[l * W + c];
    sm.red2[part * W + c] = t;
  }
  __syncthreads();
  if (tid < W) {
    float t = 0.f;
    for (int p = 0; p < P; ++p) t += sm.red2[p * W + tid];
    out[tid] = t;
  }
  __syncthreads();
}

// The phase's epilogue for output column `col` (v1: the up half of w13).
__device__ void epilogue(const FusedArgs& a, int proj, int layer, bool first, int col,
                         float v0, float v1) {
  if (proj == P_QKV) {
    const int n = (a.H + 2 * a.KH) * a.hd;
    if (a.has_bias) {
      const size_t bi = (size_t)layer * n + col;
      v0 += a.bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.bqkv)[bi])
                        : static_cast<const float*>(a.bqkv)[bi];
    }
    static_cast<__nv_bfloat16*>(a.qkv)[col] = __float2bfloat16_rn(v0);
  } else if (proj == P_WO) {
    float* x = static_cast<float*>(a.x);
    x[col] = bf16r(load_x(a, first, col) + v0);
  } else if (proj == P_W13) {
    const float gate = bf16r(v0), up = bf16r(v1);
    const float sig = 1.f / (1.f + expf(-gate));
    static_cast<__nv_bfloat16*>(a.act)[col] = __float2bfloat16_rn(bf16r(gate * sig) * up);
  } else {
    float* x = static_cast<float*>(a.x);
    x[col] = bf16r(__ldcg(x + col) + v0);
  }
}

// Geometry of one projection's stacked weight: K rows, row stride N,
// ncols output columns per half (w13 has a gate and an up half).
struct Proj {
  int K, N, ncols, halves, srows;
  const void* w;
  const void* s;
  template <int KIND> __device__ size_t w_bytes() const {
    return (size_t)K * N * (KIND == W_INT8 ? 1 : (KIND == W_BF16 ? 2 : 4));
  }
  __device__ size_t s_bytes(const FusedArgs& a) const {
    return (size_t)srows * N * (a.s_bf16 ? 2 : 4);
  }
};

__device__ Proj proj_geom(const FusedArgs& a, int proj) {
  const int nqkv = (a.H + 2 * a.KH) * a.hd;
  switch (proj) {
    case P_QKV: return {a.d, nqkv, nqkv, 1, a.s_rows_qkv, a.wqkv, a.wqkv_s};
    case P_WO: return {a.H * a.hd, a.d, a.d, 1, a.s_rows_wo, a.wo, a.wo_s};
    case P_W13: return {a.d, 2 * a.hidden, a.hidden, 2, a.s_rows_w13, a.w13, a.w13_s};
    default: return {a.hidden, a.d, a.d, 1, a.s_rows_w2, a.w2, a.w2_s};
  }
}

template <int KIND>
__device__ void gemv_phase(const FusedArgs& a, int proj, int layer, const Smem& sm) {
  constexpr int CPT = Cols<KIND>::n;
  const bool first = layer == 0;
  const Proj pg = proj_geom(a, proj);
  const int K = pg.K, N = pg.N, ncols = pg.ncols, halves = pg.halves;
  const int ct = a.col_threads[proj], ups = a.units_per_split[proj];
  const bool int8a = KIND == W_INT8 && a.int8_act[proj];
  const int unit = KIND == W_INT8 ? a.g : (K % kDenseUnitRows == 0 ? kDenseUnitRows : K);
  const int units = K / unit;
  const int W = ct * CPT;
  const int tiles = (ncols + W - 1) / W;
  const int splits = (units + ups - 1) / ups;
  const int items = tiles * splits;
  if (static_cast<int>(blockIdx.x) >= items) return;

  switch (proj) {
    case P_QKV: stage_norm(a, first, static_cast<const float*>(a.attn_norm) + (size_t)layer * a.d, sm.hs, sm.misc); break;
    case P_WO: stage_bf16(static_cast<const __nv_bfloat16*>(a.attn), K, sm.hs); break;
    case P_W13: stage_norm(a, false, static_cast<const float*>(a.ffn_norm) + (size_t)layer * a.d, sm.hs, sm.misc); break;
    default: stage_bf16(static_cast<const __nv_bfloat16*>(a.act), K, sm.hs); break;
  }
  if (int8a) quantize_act(sm.hs, K, a.g, sm.aq, sm.dg);

  const char* wl = static_cast<const char*>(pg.w) + (size_t)layer * pg.w_bytes<KIND>();
  const void* sl = nullptr;
  if (KIND == W_INT8) sl = static_cast<const char*>(pg.s) + (size_t)layer * pg.s_bytes(a);
  float* partial = static_cast<float*>(a.partial);
  unsigned int* counters = static_cast<unsigned int*>(a.counters);
  int* flag = reinterpret_cast<int*>(sm.misc + 63);
  const int tid = threadIdx.x;

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int tile = item / splits, split = item % splits;
    const int row0 = split * ups * unit;
    const int row1 = min(K, row0 + ups * unit);
    for (int h = 0; h < halves; ++h)
      gemv_tile<KIND>(wl, sl, a.s_bf16, N, h * ncols + tile * W, h * ncols + ncols, row0,
                      row1, a.g, int8a, ct, sm, sm.out + h * W);
    const int col = tile * W + tid;
    if (splits == 1) {
      if (tid < W && col < ncols)
        epilogue(a, proj, layer, first, col, sm.out[tid], halves == 2 ? sm.out[W + tid] : 0.f);
      continue;
    }
    if (tid < W && col < ncols)
      for (int h = 0; h < halves; ++h)
        partial[((size_t)split * halves + h) * ncols + col] = sm.out[h * W + tid];
    __threadfence();
    __syncthreads();
    if (tid == 0) *flag = atomicAdd(counters + tile, 1u) == static_cast<unsigned>(splits - 1);
    __syncthreads();
    if (*flag) {
      __threadfence();
      if (tid < W && col < ncols) {
        float v[2] = {0.f, 0.f};
        for (int h = 0; h < halves; ++h) {
#pragma unroll 8
          for (int sp = 0; sp < splits; ++sp)
            v[h] += __ldcg(partial + ((size_t)sp * halves + h) * ncols + col);
        }
        epilogue(a, proj, layer, first, col, v[0], v[1]);
      }
      if (tid == 0) counters[tile] = 0u;
    }
    __syncthreads();
  }
}

// Eight cache elements as fp32, from one (bf16) or two (fp32) 16-byte loads.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const unsigned short* u = reinterpret_cast<const unsigned short*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = bf2f(u[j]);
}
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

// One query head's attention for one layer; writes attn[h] and, for the
// first query head of each KV head, the new K/V row at slot pos.
template <typename CT>
__device__ void attention_head(const FusedArgs& a, int layer, int h, int pos, float* sm,
                               float* scratch) {
  const int hd = a.hd, h2 = hd / 2, KV = a.KH * hd;
  const int kv_mul = a.H / a.KH, kh = h / kv_mul;
  const int tid = threadIdx.x, lane = tid & 31;
  float* qf = sm;
  float* kn = sm + hd;
  float* vn = sm + 2 * hd;
  float* pvred = sm + 3 * hd;                 // [kThreads * 8]
  float* scores = sm + 3 * hd + kThreads * 8;  // [A]
  const __nv_bfloat16* y = static_cast<const __nv_bfloat16*>(a.qkv);
  const int pr = min(pos, a.seq_len - 1);
  const float* sn = static_cast<const float*>(a.sin) + (size_t)pr * h2;
  const float* cs = static_cast<const float*>(a.cos) + (size_t)pr * h2;
  for (int j = tid; j < h2; j += kThreads) {
    const int ia = a.rope_half ? j : 2 * j;
    const int ib = a.rope_half ? j + h2 : 2 * j + 1;
    const float sv = sn[j], cv = cs[j];
    const __nv_bfloat16* srcs[2] = {y + h * hd, y + a.H * hd + kh * hd};
    float* dsts[2] = {qf, kn};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float xa = ld_bf16_cg(srcs[r] + ia), xb = ld_bf16_cg(srcs[r] + ib);
      dsts[r][ia] = bf16r(__fadd_rn(__fmul_rn(xa, cv), __fmul_rn(xb, -sv)));
      dsts[r][ib] = bf16r(__fadd_rn(__fmul_rn(xa, sv), __fmul_rn(xb, cv)));
    }
  }
  for (int e = tid; e < hd; e += kThreads) vn[e] = ld_bf16_cg(y + (a.H + a.KH) * hd + kh * hd + e);
  __syncthreads();

  const size_t lbase = (size_t)layer * a.cache_layer_stride + (size_t)kh * hd;
  const CT* kc = static_cast<const CT*>(a.k_cache) + lbase;
  const CT* vc = static_cast<const CT*>(a.v_cache) + lbase;
  // scores: one thread per slot, its K row read as 16-byte loads that are
  // all in flight at once
  float lmax = kNegInf;
  for (int t = tid; t < pos; t += kThreads) {
    const CT* kr = kc + (size_t)t * KV;
    float acc = 0.f;
#pragma unroll 8
    for (int e = 0; e < hd; e += 8) {
      float kv8[8];
      load8(kr + e, kv8);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc = fmaf(qf[e + j], kv8[j], acc);
    }
    const float sc = acc * a.scale;
    scores[t] = sc;
    lmax = fmaxf(lmax, sc);
  }
  float an = 0.f;
  for (int e = lane; e < hd; e += 32) an = fmaf(qf[e], kn[e], an);
  const float s_new = warp_sum(an) * a.scale;  // the same in every warp
  const float m = fmaxf(block_max(lmax, scratch), s_new);

  float psum = 0.f;
  for (int t = tid; t < pos; t += kThreads) {
    const float p = expf(scores[t] - m);
    psum += p;
    scores[t] = round_to(p, static_cast<CT*>(nullptr));  // p in the cache dtype
  }
  const float p_new = expf(s_new - m);
  const float denom = block_sum(psum, scratch) + p_new;

  // pv: a thread owns 8 adjacent lanes of the head for every n_sl-th slot
  const int ng8 = hd / 8, n_sl = kThreads / ng8;
  const int eg = tid % ng8, sl = tid / ng8;
  if (sl < n_sl) {
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int t = sl; t < pos; t += n_sl) {
      const float pt = scores[t];
      float v8[8];
      load8(vc + (size_t)t * KV + eg * 8, v8);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = fmaf(pt, v8[j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) pvred[sl * hd + eg * 8 + j] = acc[j];
  }
  __syncthreads();
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.attn) + (size_t)h * hd;
  for (int e = tid; e < hd; e += kThreads) {
    float v = 0.f;
    for (int r = 0; r < n_sl; ++r) v += pvred[r * hd + e];
    v = __fadd_rn(v, __fmul_rn(p_new, vn[e]));
    out[e] = __float2bfloat16_rn(v / denom);
  }
  if (h % kv_mul == 0) {
    const size_t row = (size_t)layer * a.cache_layer_stride + (size_t)pos * KV + (size_t)kh * hd;
    CT* kw = static_cast<CT*>(a.k_cache) + row;
    CT* vw = static_cast<CT*>(a.v_cache) + row;
    for (int e = tid; e < hd; e += kThreads) {
      store(kw + e, kn[e]);
      store(vw + e, vn[e]);
    }
  }
  __syncthreads();
}

// Optional phase trace: block 0 stores the global timer (ns) at the start,
// after each phase's grid barrier and at the end. chip_smoke.py reads it
// (`fused_decode.phase_times`) for the time of each phase per layer.
__device__ __forceinline__ void mark(const FusedArgs& a, int idx) {
  if (a.trace != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.trace[idx] = t;
  }
}

template <int KIND>
__global__ void __launch_bounds__(kThreads) fused_decode_kernel(const FusedArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kp = (max(a.d, a.hidden) + 15) / 16 * 16;
  Smem sm;
  sm.hs = reinterpret_cast<float*>(smem);
  sm.aq = reinterpret_cast<int*>(smem + 4 * (size_t)kp);
  sm.dg = reinterpret_cast<float*>(smem + 5 * (size_t)kp);
  sm.red = reinterpret_cast<float*>(smem + 6 * (size_t)kp);
  sm.red2 = sm.red + kRedFloats;
  sm.out = sm.red2 + kThreads;
  sm.misc = reinterpret_cast<float*>(smem + a.smem_bytes) - 64;
  const int pos = *static_cast<const int*>(a.pos);
  mark(a, 0);
  for (int l = 0; l < a.L; ++l) {
    gemv_phase<KIND>(a, P_QKV, l, sm);
    grid_sync();
    mark(a, 1 + 5 * l);
    for (int h = blockIdx.x; h < a.H; h += gridDim.x) {
      if (a.cache_bf16)
        attention_head<__nv_bfloat16>(a, l, h, pos, reinterpret_cast<float*>(smem), sm.misc);
      else
        attention_head<float>(a, l, h, pos, reinterpret_cast<float*>(smem), sm.misc);
    }
    grid_sync();
    mark(a, 2 + 5 * l);
    gemv_phase<KIND>(a, P_WO, l, sm);
    grid_sync();
    mark(a, 3 + 5 * l);
    gemv_phase<KIND>(a, P_W13, l, sm);
    grid_sync();
    mark(a, 4 + 5 * l);
    gemv_phase<KIND>(a, P_W2, l, sm);
    grid_sync();
    mark(a, 5 + 5 * l);
  }
  if (blockIdx.x == 0) {
    stage_norm(a, a.L == 0, static_cast<const float*>(a.final_norm), sm.hs, sm.misc);
    for (int k = threadIdx.x; k < a.d; k += kThreads) {
      if (a.x_bf16) static_cast<__nv_bfloat16*>(a.x_out)[k] = __float2bfloat16_rn(sm.hs[k]);
      else static_cast<float*>(a.x_out)[k] = sm.hs[k];
    }
    __syncthreads();
    mark(a, 1 + 5 * a.L);
  }
}

template <int KIND>
cudaError_t launch(const FusedArgs& a, cudaStream_t stream) {
  auto fn = fused_decode_kernel<KIND>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         a.smem_bytes);
  if (err != cudaSuccess) return err;
  FusedArgs arg = a;
  void* params[] = {&arg};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fn), dim3(a.grid),
                                    dim3(kThreads), params, a.smem_bytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int KIND>
cudaError_t occupancy(int smem, int* out) {
  auto fn = fused_decode_kernel<KIND>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, kThreads, smem);
}

}  // namespace

// One decode step: a cooperative launch of a->grid blocks of 256 threads on
// `stream`. Returns the cudaError_t of the launch (a refused cooperative
// launch is an error, never a fallback).
extern "C" int fused_decode(const FusedArgs* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (a->w_kind) {
    case W_INT8: err = launch<W_INT8>(*a, st); break;
    case W_BF16: err = launch<W_BF16>(*a, st); break;
    case W_FP32: err = launch<W_FP32>(*a, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Blocks of the kernel for weight kind `w_kind` that fit one SM with `smem`
// bytes of dynamic shared memory each.
extern "C" int fused_decode_blocks_per_sm(int w_kind, int smem, int* out) {
  cudaError_t err;
  switch (w_kind) {
    case W_INT8: err = occupancy<W_INT8>(smem, out); break;
    case W_BF16: err = occupancy<W_BF16>(smem, out); break;
    case W_FP32: err = occupancy<W_FP32>(smem, out); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
