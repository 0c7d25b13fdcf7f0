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
// What bounds it on this card: bytes. At Llama-2-7B INT8 g 64 with bf16
// scales the layer stack streams 6.48 GB of int8 and 0.20 GB of scales per
// step: 1.99 ms at 3.35 TB/s (Llama-3-8B: 7.2 GB, 2.15 ms). A GEMV phase
// moves 17-90 MB, so the fixed cost of a phase (barrier, staging), which
// dominates the small kernel at 1-6 MB a phase, is amortized here, and the
// rate at which the weights stream sets the time. The design aims at that:
//   * int8 x int8 GEMVs (__dp4a) in which each k-lane walks its quads of 4
//     weight rows two at a time, issuing both quads' eight 16-byte loads
//     before it uses either: 128 B a thread, 32 KB a block, and with two
//     blocks an SM (__launch_bounds__(256, 2)) 64 KB in flight per SM,
//     beyond the ~25 KB that 3.35 TB/s needs at the card's latency; the
//     lane's group scales are applied once per group it touches;
//   * a block stages and quantizes only the rows of its own K split (the
//     rms norm of qkv and gate/up still reads the whole row for its sum of
//     squares), into shared memory sized for K = 14336 (Llama-3-8B's w2);
//   * the work items (column tile x K split) and their fixed-order split
//     reduction are the small kernel's (fused_decode_common.cuh), as are
//     attention, the epilogues and the cooperative launch.
// No TMA ring and no wgmma yet: the GEMV is a matrix-vector product, which
// the tensor cores do not speed up, and plain 16-byte loads in flight were
// judged enough for a first version.

#include "fused_decode_common.cuh"

namespace {

__device__ __forceinline__ int4 ld_stream(const int8_t* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

// acc[j] += ip[j] * d * s[j] for the lane's group `grp`, then ip = 0.
__device__ __forceinline__ void flush_group(int* ip, const float* sc, float dd, float* acc) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    acc[j] = fmaf(__fmul_rn(static_cast<float>(ip[j]), dd), sc[j], acc[j]);
    ip[j] = 0;
  }
}

// One quad (4 rows) of the lane's walk: when it starts a new group, the
// previous group's int32 sums are scaled into acc and the new group's
// scales are loaded.
__device__ __forceinline__ void quad_step(int cq, const int4* r, const void* s, int s_bf16,
                                          int N, int col0, int qpg, const int* aq,
                                          const float* dg, int& cur, int* ip, float* sc,
                                          float* acc) {
  const int grp = cq / qpg;
  if (grp != cur) {
    if (cur >= 0) flush_group(ip, sc, dg[cur], acc);
    load_scales16(s, s_bf16, (size_t)grp * N + col0, sc);
    cur = grp;
  }
  dp4a_quad(r, aq[cq], ip);
}

// acc[j] for this thread's 16 int8 columns over rows [row0, row1), int8
// activation: lane kl takes quads kl, kl + klanes, ..., two per iteration
// with all eight loads in flight before the first is used.
__device__ __forceinline__ void stream_int8(const int8_t* q, const void* s, int s_bf16, int N,
                                            int col0, int row0, int row1, int g,
                                            const int* aq, const float* dg, int kl,
                                            int klanes, float* acc) {
  const int qpg = g / 4, q1 = row1 / 4;
  int ip[16];
  float sc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) ip[j] = 0;
  int cur = -1;
  for (int c = row0 / 4 + kl; c < q1; c += 2 * klanes) {
    const int c1 = c + klanes;
    const bool has1 = c1 < q1;
    int4 r0[4], r1[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) r0[i] = ld_stream(q + (size_t)(4 * c + i) * N + col0);
    if (has1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) r1[i] = ld_stream(q + (size_t)(4 * c1 + i) * N + col0);
    }
    quad_step(c, r0, s, s_bf16, N, col0, qpg, aq, dg, cur, ip, sc, acc);
    if (has1) quad_step(c1, r1, s, s_bf16, N, col0, qpg, aq, dg, cur, ip, sc, acc);
  }
  if (cur >= 0) flush_group(ip, sc, dg[cur], acc);
}

template <bool INT8A>
__device__ void big_tile(const int8_t* w, const void* s, int s_bf16, int N, int col_base,
                         int col_end, int row0, int row1, int g, int ct, const Smem& sm,
                         float* out) {
  const int tid = threadIdx.x;
  const int klanes = kThreads / ct;
  const int cthr = tid % ct, kl = tid / ct;
  const int col0 = col_base + cthr * 16;
  float acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0.f;
  if (col0 < col_end) {  // widths are multiples of 16: a run is wholly in or out
    if constexpr (INT8A)
      stream_int8(w, s, s_bf16, N, col0, row0, row1, g, sm.aq, sm.dg, kl, klanes, acc);
    else
      gemv_accumulate<W_INT8>(w, s, s_bf16, N, col0, row0, row1, g, false, sm.hs, sm.aq,
                              sm.dg, kl, klanes, acc);
  }
  tile_reduce<16>(acc, ct, sm, out);
}

// hs[k] for k in [row0, row1) from a bf16 activation written by the
// previous phase (row0 and row1 multiples of 8).
__device__ void stage_bf16_rows(const void* src, int row0, int row1, float* hs) {
  stage8(static_cast<const __nv_bfloat16*>(src) + row0, row1 - row0, hs + row0);
  __syncthreads();
}

// One GEMV phase: like the small kernel's `gemv_phase`, but each block stages
// and quantizes only the rows of the split it works on.
template <bool INT8A>
__device__ void gemv_phase_big(const FusedArgs& a, int proj, int layer, const Smem& sm) {
  const Proj pg = proj_geom(a, proj);
  const int K = pg.K, N = pg.N, ncols = pg.ncols, halves = pg.halves;
  const int ct = a.col_threads[proj], ups = a.units_per_split[proj];
  const int g = a.g, units = K / g, W = ct * 16;
  const int tiles = (ncols + W - 1) / W;
  const int splits = (units + ups - 1) / ups;
  const int items = tiles * splits;
  if (static_cast<int>(blockIdx.x) >= items) return;
  const bool first = layer == 0;

  if (proj == P_QKV)
    stage_norm(a, first, static_cast<const float*>(a.attn_norm) + (size_t)layer * a.d, sm.hs, sm.misc);
  else if (proj == P_W13)
    stage_norm(a, false, static_cast<const float*>(a.ffn_norm) + (size_t)layer * a.d, sm.hs, sm.misc);

  const int8_t* wl = static_cast<const int8_t*>(pg.w) + (size_t)layer * pg.w_bytes<W_INT8>();
  const void* sl = static_cast<const char*>(pg.s) + (size_t)layer * pg.s_bytes(a);
  int staged0 = -1, staged1 = -1;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int tile = item / splits, split = item % splits;
    const int row0 = split * ups * g;
    const int row1 = min(K, row0 + ups * g);
    if (row0 != staged0 || row1 != staged1) {
      if (proj == P_WO) stage_bf16_rows(a.attn, row0, row1, sm.hs);
      else if (proj == P_W2) stage_bf16_rows(a.act, row0, row1, sm.hs);
      if (INT8A) quantize_groups(sm.hs, row0 / g, row1 / g, g, sm.aq, sm.dg);
      staged0 = row0;
      staged1 = row1;
    }
    for (int h = 0; h < halves; ++h)
      big_tile<INT8A>(wl, sl, a.s_bf16, N, h * ncols + tile * W, h * ncols + ncols, row0,
                      row1, g, ct, sm, sm.out + h * W);
    finish_item(a, proj, layer, first, tile, split, splits, W, ncols, halves, sm);
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
    grid_sync();
    mark(a, 1 + 5 * l);
    attention_phase(a, l, pos, pos, smem, sm);
    grid_sync();
    mark(a, 2 + 5 * l);
    gemv_phase_big<INT8A>(a, P_WO, l, sm);
    grid_sync();
    mark(a, 3 + 5 * l);
    gemv_phase_big<INT8A>(a, P_W13, l, sm);
    grid_sync();
    mark(a, 4 + 5 * l);
    gemv_phase_big<INT8A>(a, P_W2, l, sm);
    grid_sync();
    mark(a, 5 + 5 * l);
  }
  if (blockIdx.x == 0) {
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

// Blocks of the kernel variant (int8 activations or not) that fit one SM
// with `smem` bytes of dynamic shared memory each.
extern "C" int fused_decode_big_blocks_per_sm(int int8a, int smem, int* out) {
  return static_cast<int>(blocks_per_sm(kernel_for(int8a), smem, out));
}
