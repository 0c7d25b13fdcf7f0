// Big-model B = 1 decode megakernel for Hopper (sm_90a): one launch computes
// a whole decode step of a Llama-2-7B / Llama-3-8B class layer stack.
//
// Replaces the TPU kernel kuiperllama_tpu/ops/pallas/fused_decode_big.py
// `_kernel` (entry `fused_decode_step_big`), which the JAX Generator takes
// under KT_FUSED_BIG=1 when the small megakernel's plan does not fit. It
// computes the step of fused_decode.cu (same phases, same rounding points,
// csrc/fused_decode.cu:8-16) with one difference: every GEMV (qkv, wo,
// gate/up, w2) takes the int8 activation when int8_act is set (KT_BIG_INT8,
// the default) and the bf16 activation when not. The JAX kernel quantizes
// the wo activation per wo row tile and the w2 activation per FFN tile;
// every tile edge there is a group edge, so that is per-group quantization
// of the whole row, which this kernel does.
//
// What bounds it on this card. At Llama-2-7B INT8 g 64 with bf16 scales the
// layer stack streams 6.48 GB of int8 and 0.20 GB of scales per step: 1.99
// ms at 3.35 TB/s (Llama-3-8B: 7.2 GB, 2.15 ms). The weight stream does not
// set the time: each phase is a chain of latencies that the stream waits
// behind (the grid barrier, staging the activation, the walk's loads, the
// k-lane reduction, the split sum). tools/big_phase_costs.py takes each
// piece out in turn. On the first port's kernel (4.17 ms a step at g 64)
// the grid barriers were worth 1.38 ms, attention 0.53, the split sums
// 0.40, the group flushes 0.30 (one after every quad a k-lane took, at g
// 64), the quantizing 0.18, the norm staging 0.17 and the k-lane reduction
// 0.15 (PERF.md). What this design does about them:
//   * a k-lane walks a contiguous run of its split's quads (4 rows), two
//     quads' eight 16-byte loads in flight at a time, and sums the __dp4a
//     products in int32 over the part of each group its run covers; it
//     scales them once, at the group's end (a run covers one or two groups
//     at g 64), with the scales it loaded when the group began;
//   * a block stages only the rows of its K split: the rms norm's sum of
//     squares reads the row once a phase, and each thread quantizes its
//     eight values in registers, the g / 8 threads of a group finding its
//     amax by shuffles (the same values as stage_norm and quantize_groups);
//   * two grid barriers a layer instead of five: attention waits only for
//     the qkv tiles that hold its head's columns, wo only for the heads its
//     split reads, w2 only for the gate/up tiles its split reads, through
//     per-tile and per-head completion flags. gate/up still waits for all
//     of wo (its norm reads the whole residual), and qkv for all of w2. The
//     phases that may now overlap keep apart: their split partials and
//     counters lie in separate regions, and the residual stream is double
//     buffered;
//   * the work items (column tile x K split), their fixed-order split
//     reduction and the k-lane reduction are the small kernel's, as are
//     attention, the epilogues and the cooperative launch.
// It holds 128 registers at two blocks an SM; ptxas spills 8 bytes, two
// long-lived values stored once and read once an item (the design without
// the flags spills none and measured slower).
// Tried and measured slower (PERF.md): a warp owning whole groups
// (its sub-lanes' int32 sums reduce-scattered by shuffles; a wo item of one
// group keeps one warp of eight busy), the first loads issued ahead of the
// staging or the barrier (the registers they hold spill), L2 prefetches of
// the next phase's weights, a shuffle-first k-lane reduction, scales read
// at the flush from L1, and three quads a batch (both spill); earlier, a
// producer-warp ring and register and L2 prefetches. No TMA and no wgmma:
// the GEMV is a matrix-vector product, which the tensor cores do not speed
// up.

#include "fused_decode_common.cuh"

namespace {

__device__ __forceinline__ int4 ld_stream(const int8_t* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

// The residual stream, double-buffered so that no phase writes what a phase
// it may overlap reads: wo's epilogue reads x (x0 in layer 0's) and writes
// x', gate/up normalizes x', w2's epilogue writes x = x' + ...; qkv and
// the final norm read x. `prime` selects x'.
__device__ __forceinline__ float* residual(const FusedArgs& a, bool prime) {
  return static_cast<float*>(a.x) + (prime ? a.d : 0);
}

// The sum of squares of src[0, K) in stage8's order (so the norm is stage_norm's).
template <typename T>
__device__ float row_sumsq(const T* __restrict__ src, int K) {
  float ss = 0.f;
#pragma unroll 4
  for (int k = threadIdx.x * 8; k < K; k += kThreads * 8) {
    float v[8];
    ld8_cg(src + k, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) ss = fmaf(v[j], v[j], ss);
  }
  return ss;
}

// The activation of one K split [row0, row1): the packed int8 aq and group
// scales dg (INT8A), or hs (the bf16 activation). For qkv and gate/up it is
// bf16(rmsnorm(x)[k] * w[k]), stage_norm's value; the block forms the rms
// factor `rn` once per phase (rn < 0 until then). For wo and w2 it is the
// previous phase's bf16 output. Thread t takes the eight k from row0 + 8 t;
// the g / 8 threads of a group (a power of two that divides 32) find its
// amax by shuffles, then quantize as quantize_groups does.
template <bool INT8A>
__device__ __forceinline__ void stage_split(const FusedArgs& a, int proj, int layer, bool first,
                                            int row0, int row1, float& rn, const Smem& sm) {
  const int g = a.g, team = g / 8, n8 = (row1 - row0) / 8;
  const bool normed = proj == P_QKV || proj == P_W13;
  const float* wn = static_cast<const float*>(proj == P_QKV ? a.attn_norm : a.ffn_norm) +
                    (size_t)layer * a.d;
  const bool xfirst = first && proj == P_QKV;  // the residual stream is still x0
  const float* x = residual(a, proj == P_W13);
  if (normed && rn < 0.f) {
    float ss;
    if (!xfirst) ss = row_sumsq(x, a.d);
    else if (a.x_bf16) ss = row_sumsq(static_cast<const __nv_bfloat16*>(a.x0), a.d);
    else ss = row_sumsq(static_cast<const float*>(a.x0), a.d);
    rn = 1.f / sqrtf(block_sum(ss, sm.misc) / static_cast<float>(a.d) + a.eps);
  }
  const bool shuffled = INT8A && team <= 32 && (team & (team - 1)) == 0;
  for (int base = 0; base < n8; base += kThreads) {
    const int t = base + static_cast<int>(threadIdx.x);
    const bool ok = t < n8;
    const int k = row0 + 8 * t;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0.f;
    if (ok) {
      if (normed) {
        if (!xfirst) ld8_cg(x + k, v);
        else if (a.x_bf16) ld8_cg(static_cast<const __nv_bfloat16*>(a.x0) + k, v);
        else ld8_cg(static_cast<const float*>(a.x0) + k, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = bf16r(v[j] * rn * wn[k + j]);
      } else {
        ld8_cg(static_cast<const __nv_bfloat16*>(proj == P_WO ? a.attn : a.act) + k, v);
      }
    }
    if (shuffled) {
      float m = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(v[j]));
      for (int o = 1; o < team; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float dd = m > 0.f ? m / 127.f : 1.f;
      if (ok) {
        if (t % team == 0) sm.dg[k / g] = dd;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          unsigned int packed = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int qv = static_cast<int>(rintf(v[4 * h + i] / dd));
            packed |= (static_cast<unsigned int>(qv) & 0xffu) << (8 * i);
          }
          sm.aq[k / 4 + h] = static_cast<int>(packed);
        }
      }
    } else if (ok) {
#pragma unroll
      for (int j = 0; j < 8; ++j) sm.hs[k + j] = v[j];
    }
  }
  __syncthreads();
  if (INT8A && !shuffled) quantize_groups(sm.hs, row0 / g, row1 / g, g, sm.aq, sm.dg);
}

// acc[j] += ip[j] * d * s[j] for the lane's group, then ip = 0.
__device__ __forceinline__ void flush_group(int* ip, const float* sc, float dd, float* acc) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    acc[j] = fmaf(__fmul_rn(static_cast<float>(ip[j]), dd), sc[j], acc[j]);
    ip[j] = 0;
  }
}

// Quads c and c + 1 (rows 4 c to 4 c + 7) for the lane's 16 columns from
// col0: eight 16-byte loads, zeros past quad c1.
__device__ __forceinline__ void load_quads(const int8_t* q, int N, int col0, int c, int c1,
                                           int4* r) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    r[i] = c + i / 4 < c1 ? ld_stream(q + ((size_t)4 * c + i) * N + col0) : make_int4(0, 0, 0, 0);
}

// A k-lane's run of one item: the quads [c0, c1) of the K split [row0,
// row1), contiguous; the split's quads are dealt out in klanes runs that
// differ by at most one quad.
struct Run {
  int c0, c1;
};
__device__ __forceinline__ Run lane_run(int row0, int row1, int kl, int klanes) {
  const int base = row0 / 4, nq = (row1 - row0) / 4;
  return {base + kl * nq / klanes, base + (kl + 1) * nq / klanes};
}

// acc[j] for this thread's 16 int8 columns over the quads of its run, int8
// activation. The run is contiguous, so the lane's int32 sums cover whole
// groups (or the ends of one) and are scaled once per group it touches, at
// the group's end; two quads' eight loads are in flight at a time.
__device__ __forceinline__ void stream_int8(const int8_t* q, const void* s, int s_bf16, int N,
                                            int col0, Run run, int qpg, const int* aq,
                                            const float* dg, float* acc) {
  if (run.c0 >= run.c1) return;
  int ip[16];
  float sc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) ip[j] = 0;
  int grp = run.c0 / qpg, edge = (grp + 1) * qpg;
  load_scales16(s, s_bf16, (size_t)grp * N + col0, sc);
  for (int c = run.c0; c < run.c1; c += 2) {
    int4 r[8];
    load_quads(q, N, col0, c, run.c1, r);
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      if (c + b < run.c1) {
        if (c + b == edge) {
          flush_group(ip, sc, dg[grp], acc);
          ++grp;
          edge += qpg;
          load_scales16(s, s_bf16, (size_t)grp * N + col0, sc);
        }
        dp4a_quad(r + 4 * b, aq[c + b], ip);
      }
    }
  }
  flush_group(ip, sc, dg[grp], acc);
}

// Completion flags, in the split-counter buffer past the split counters
// (fused_decode_big_scratch gives the buffer's size): one per qkv column
// tile, one per query head and one per gate/up column tile, each counting
// the layers it finished in this launch; block 0 zeroes them at the
// launch's end, when no block waits any more. A phase that may overlap the one before it (wo
// after qkv, w2 after gate/up) counts its splits from kSplitB on and keeps
// its partials past the other's (`split_space`).
constexpr int kSplitB = 2048, kTileFlags = 4096, kHeadFlags = kTileFlags + 2048,
              kFfnFlags = kTileFlags + 4096, kFlagWords = 6144;

__device__ __forceinline__ unsigned* flag_at(const FusedArgs& a, int i) {
  return static_cast<unsigned*>(a.counters) + i;
}

// One thread publishes what its block wrote before the __syncthreads that
// came just before: a release add, cumulative over the block's writes
// through the barrier (as CUTLASS's semaphores release).
__device__ __forceinline__ void signal_flag(unsigned* f) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(f) : "memory");
}

// Thread 0 waits until *f >= target (an acquire load); the caller's
// __syncthreads then orders the block's reads after it. Every block is
// resident (cooperative launch) and producers never wait on consumers, so a
// wait that does not end is a fault: it traps rather than hang the card.
__device__ __forceinline__ void wait_flag(const unsigned* f, unsigned target) {
  for (unsigned spin = 0;; ++spin) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(f) : "memory");
    if (v >= target) return;
    if (spin > (1u << 24)) __trap();
    __nanosleep(64);
  }
}

// The attention phase of one layer, one block per query head as
// attention_phase does it; in place of a grid barrier on each side, a head
// waits only for the qkv tiles that hold its q, k and v columns, and raises
// its own flag once attn[h] is written.
__device__ __forceinline__ void attention_big(const FusedArgs& a, int layer, int pos,
                                              unsigned char* smem, const Smem& sm) {
  const int hd = a.hd, kv_mul = a.H / a.KH, Wq = a.col_threads[P_QKV] * 16;
  for (int h = blockIdx.x; h < a.H; h += gridDim.x) {
    if (threadIdx.x == 0) {
      const int kh = h / kv_mul;
      const int col[3] = {h * hd, (a.H + kh) * hd, (a.H + a.KH + kh) * hd};
      for (int i = 0; i < 3; ++i)
        for (int t = col[i] / Wq; t <= (col[i] + hd - 1) / Wq; ++t)
          wait_flag(flag_at(a, kTileFlags + t), layer + 1);
    }
    __syncthreads();
    if (a.cache_bf16)
      attention_head<__nv_bfloat16>(a, layer, h, pos, pos, reinterpret_cast<float*>(smem), sm.misc);
    else
      attention_head<float>(a, layer, h, pos, pos, reinterpret_cast<float*>(smem), sm.misc);
    if (threadIdx.x == 0) signal_flag(flag_at(a, kHeadFlags + h));  // after its __syncthreads
  }
}

// A GEMV phase's reduction length, columns and halves (proj_geom's K, ncols
// and halves), on the host too: fused_decode_big_scratch sizes the
// workspace from them.
struct PhaseDims {
  int K, ncols, halves;
};
__host__ __device__ __forceinline__ PhaseDims phase_dims(const FusedArgs& a, int proj) {
  const int nqkv = (a.H + 2 * a.KH) * a.hd;
  switch (proj) {
    case P_QKV: return {a.d, nqkv, 1};
    case P_WO: return {a.H * a.hd, a.d, 1};
    case P_W13: return {a.d, a.hidden, 2};
    default: return {a.hidden, a.d, 1};
  }
}

// The fp32 partials of one phase's K splits ([split][half][ncols]) when it
// has more than one.
__host__ __device__ __forceinline__ int split_floats(const FusedArgs& a, int proj) {
  const PhaseDims pd = phase_dims(a, proj);
  const int ups = a.units_per_split[proj];
  const int splits = (pd.K / a.g + ups - 1) / ups;
  return splits > 1 ? splits * pd.halves * pd.ncols : 0;
}

// The split partials of the phases that may overlap the one before them (wo
// and w2) lie past qkv's and gate/up's, so the partials take the larger of
// each pair.
__host__ __device__ __forceinline__ int first_split_floats(const FusedArgs& a) {
  const int q = split_floats(a, P_QKV), f = split_floats(a, P_W13);
  return q > f ? q : f;
}

// Where phase `proj` keeps its split partials and counters: wo and w2 past
// qkv's and gate/up's.
__device__ __forceinline__ void split_space(const FusedArgs& a, int proj, float** partial,
                                            unsigned** counters) {
  const bool second = proj == P_WO || proj == P_W2;
  *partial = static_cast<float*>(a.partial) + (second ? first_split_floats(a) : 0);
  *counters = static_cast<unsigned*>(a.counters) + (second ? kSplitB : 0);
}

// fused_decode_common.cuh `epilogue`, with wo's and w2's residual adds on
// the double-buffered stream (`residual`).
__device__ __forceinline__ void epilogue_big(const FusedArgs& a, int proj, int layer, bool first,
                                             int col, float v0, float v1) {
  if (proj == P_WO)
    residual(a, true)[col] = bf16r(load_x(a, first, col) + v0);
  else if (proj == P_W2)
    residual(a, false)[col] = bf16r(__ldcg(residual(a, true) + col) + v0);
  else
    epilogue(a, proj, layer, first, col, v0, v1);
}

// finish_item (fused_decode_common.cuh) on the phase's own partials and
// counters: with one split the block runs the epilogue on its tile;
// otherwise it writes its partials and the last block of the tile (an
// integer counter, no float atomics) adds the splits in split order and
// runs the epilogue. One acq_rel add releases the block's partials and,
// for the last block, acquires the others' (two fences measured slower).
// Returns whether this block ran the epilogue (the same in every thread).
__device__ __forceinline__ bool finish_big(const FusedArgs& a, int proj, int layer, bool first,
                                           int tile, int split, int splits, int W, int ncols,
                                           int halves, const Smem& sm) {
  float* partial;
  unsigned* counters;
  split_space(a, proj, &partial, &counters);
  int* last = reinterpret_cast<int*>(sm.misc + 63);
  const int tid = threadIdx.x;
  const int col = tile * W + tid;
  if (splits == 1) {
    if (tid < W && col < ncols)
      epilogue_big(a, proj, layer, first, col, sm.out[tid], halves == 2 ? sm.out[W + tid] : 0.f);
    return true;
  }
  if (tid < W && col < ncols)
    for (int h = 0; h < halves; ++h)
      partial[((size_t)split * halves + h) * ncols + col] = sm.out[h * W + tid];
  __syncthreads();
  if (tid == 0) {  // release the block's partials, acquire the others' if last
    unsigned old;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;"
                 : "=r"(old) : "l"(counters + tile) : "memory");
    *last = old == static_cast<unsigned>(splits - 1);
  }
  __syncthreads();
  const bool ran = *last;
  if (ran) {
    if (tid < W && col < ncols) {
      float v[2] = {0.f, 0.f};
      for (int h = 0; h < halves; ++h) {
#pragma unroll 8
        for (int sp = 0; sp < splits; ++sp)
          v[h] += __ldcg(partial + ((size_t)sp * halves + h) * ncols + col);
      }
      epilogue_big(a, proj, layer, first, col, v[0], v[1]);
    }
    if (tid == 0) counters[tile] = 0u;
  }
  __syncthreads();
  return ran;
}

// One GEMV phase: each block stages only the rows of the split it works on
// (stage_split), then its k-lanes walk the item.
template <bool INT8A>
__device__ __forceinline__ void gemv_phase_big(const FusedArgs& a, int proj, int layer,
                                               const Smem& sm) {
  const Proj pg = proj_geom(a, proj);
  const int K = pg.K, N = pg.N, ncols = pg.ncols, halves = pg.halves;
  const int ct = a.col_threads[proj], ups = a.units_per_split[proj];
  const int g = a.g, W = ct * 16, klanes = kThreads / ct;
  const int tiles = (ncols + W - 1) / W;
  const int splits = (K / g + ups - 1) / ups;
  const int items = tiles * splits;
  if (static_cast<int>(blockIdx.x) >= items) return;
  const bool first = layer == 0;
  const int8_t* wl = static_cast<const int8_t*>(pg.w) + (size_t)layer * pg.w_bytes<W_INT8>();
  const void* sl = static_cast<const char*>(pg.s) + (size_t)layer * pg.s_bytes(a);
  const int cthr = threadIdx.x % ct, kl = threadIdx.x / ct;
  float rn = -1.f;
  int staged0 = -1;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int tile = item / splits, split = item % splits;
    const int row0 = split * ups * g;
    const int row1 = min(K, row0 + ups * g);
    if (row0 != staged0) {
      if (proj == P_WO) {  // the heads whose attn rows the split reads
        if (threadIdx.x == 0)
          for (int h = row0 / a.hd; h <= (row1 - 1) / a.hd; ++h)
            wait_flag(flag_at(a, kHeadFlags + h), layer + 1);
        __syncthreads();
      } else if (proj == P_W2) {  // the gate/up tiles whose act columns it reads
        const int wg = a.col_threads[P_W13] * 16;
        if (threadIdx.x == 0)
          for (int t = row0 / wg; t <= (row1 - 1) / wg; ++t)
            wait_flag(flag_at(a, kFfnFlags + t), layer + 1);
        __syncthreads();
      }
      stage_split<INT8A>(a, proj, layer, first, row0, row1, rn, sm);
      staged0 = row0;
    }
    for (int h = 0; h < halves; ++h) {
      const int col0 = h * ncols + tile * W + cthr * 16;
      float acc[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j] = 0.f;
      if (col0 < h * ncols + ncols) {  // widths are multiples of 16: a run is wholly in or out
        if constexpr (INT8A)
          stream_int8(wl, sl, a.s_bf16, N, col0, lane_run(row0, row1, kl, klanes), g / 4,
                      sm.aq, sm.dg, acc);
        else
          gemv_accumulate<W_INT8>(wl, sl, a.s_bf16, N, col0, row0, row1, g, false, sm.hs,
                                  sm.aq, sm.dg, kl, klanes, acc);
      }
      tile_reduce<16>(acc, ct, sm, sm.out + h * W);
    }
    const bool ran = finish_big(a, proj, layer, first, tile, split, splits, W, ncols, halves, sm);
    if (proj == P_QKV || proj == P_W13) {  // the block that ran the epilogue raises the tile's flag
      __syncthreads();
      if (threadIdx.x == 0 && ran)
        signal_flag(flag_at(a, (proj == P_QKV ? kTileFlags : kFfnFlags) + tile));
    }
  }
}

template <bool INT8A>
__global__ void __launch_bounds__(kThreads, 2) fused_big_kernel(const FusedArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm = smem_layout(smem, a);
  const int pos = *static_cast<const int*>(a.pos);
  mark(a, 0);
  for (int l = 0; l < a.L; ++l) {
    gemv_phase_big<INT8A>(a, P_QKV, l, sm);
    mark(a, 1 + 5 * l);
    attention_big(a, l, pos, smem, sm);
    mark(a, 2 + 5 * l);
    gemv_phase_big<INT8A>(a, P_WO, l, sm);
    grid_sync();
    mark(a, 3 + 5 * l);
    gemv_phase_big<INT8A>(a, P_W13, l, sm);
    mark(a, 4 + 5 * l);
    gemv_phase_big<INT8A>(a, P_W2, l, sm);
    if (l + 1 < a.L) {
      grid_sync();
      mark(a, 5 + 5 * l);
    }
  }
  grid_sync();  // the last layer's barrier: no block waits on a flag after it
  mark(a, 5 * a.L);
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < kFlagWords; i += kThreads) *flag_at(a, kTileFlags + i) = 0u;
    final_norm_out(a, sm);
    mark(a, 1 + 5 * a.L);
  }
}

const void* kernel_for(int int8a) {
  return int8a ? reinterpret_cast<const void*>(fused_big_kernel<true>)
               : reinterpret_cast<const void*>(fused_big_kernel<false>);
}

}  // namespace

// One decode step: a cooperative launch of a->grid blocks of 256 threads on
// `stream`; int8 weights only, int8 activations when a->int8_act[0].
// Returns the cudaError_t of the launch.
extern "C" int fused_decode_big(const FusedArgs* a, void* stream) {
  if (a->w_kind != W_INT8 || a->g % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_cooperative(kernel_for(a->int8_act[0]), *a, a->grid,
                                             a->smem_bytes,
                                             static_cast<cudaStream_t>(stream)));
}

// The scratch of a launch with arguments `a`, its plan filled in: fp32
// split partials (wo's and w2's past qkv's and gate/up's, split_space),
// counter words (the split counters, then the completion flags) and the
// residual stream's floats (two buffers, `residual`). The wrapper sizes its
// workspace from them, so this file alone knows the layout. Returns
// cudaErrorInvalidValue when a phase has more column tiles, or the model
// more query heads, than the split counters and flags hold.
extern "C" int fused_decode_big_scratch(const FusedArgs* a, int* partial_floats,
                                        int* counter_words, int* x_floats) {
  for (int proj = P_QKV; proj <= P_W2; ++proj) {
    const int width = a->col_threads[proj] * Cols<W_INT8>::n;
    if (width < 1 || (phase_dims(*a, proj).ncols + width - 1) / width > kSplitB)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a->H > kSplitB) return static_cast<int>(cudaErrorInvalidValue);
  const int wo = split_floats(*a, P_WO), w2 = split_floats(*a, P_W2);
  *partial_floats = first_split_floats(*a) + (wo > w2 ? wo : w2);
  *counter_words = kTileFlags + kFlagWords;
  *x_floats = 2 * a->d;
  return 0;
}

// Blocks of the kernel variant (int8 activations or not) that fit one SM
// with `smem` bytes of dynamic shared memory each.
extern "C" int fused_decode_big_blocks_per_sm(int int8a, int smem, int* out) {
  return static_cast<int>(blocks_per_sm(kernel_for(int8a), smem, out));
}

// The kernel variant's registers a thread and local-memory bytes a thread
// (spills and local arrays), as ptxas compiled it.
extern "C" int fused_decode_big_attributes(int int8a, int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel_for(int8a));
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}
