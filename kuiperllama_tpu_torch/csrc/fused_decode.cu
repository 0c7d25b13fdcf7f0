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
//     the phase's epilogue (bias, residual, SwiGLU);
//   * the bf16-activation GEMVs turn int8 weights into fp32 by a byte
//     permute into the mantissa of 2^23 (exact), not a conversion
//     instruction, which runs at a quarter of the fp32 rate; the K splits'
//     finish fences once per block, not once per thread.
// The last two are the redesigns of this kernel that measured faster
// (tools/fused_phase_costs.py times its fixed costs; PERF.md has the
// readings, and the designs tried and not kept: counters in place of the
// grid barriers with weights copied ahead, splits added by the consumers,
// the rmsnorm from tile sums of squares, fewer K splits, the K/V history
// prefetched into L2). No TMA and no
// wgmma: the phase barriers still drain the memory pipeline five times per
// layer.

#include "fused_decode_common.cuh"

namespace {

template <int KIND>
__global__ void __launch_bounds__(kThreads) fused_decode_kernel(const FusedArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm = smem_layout(smem, a);
  const int pos = *static_cast<const int*>(a.pos);
  mark(a, 0);
  for (int l = 0; l < a.L; ++l) {
    gemv_phase<KIND>(a, P_QKV, l, l == 0, sm);
    grid_sync();
    mark(a, 1 + 5 * l);
    attention_phase(a, l, pos, pos, smem, sm);
    grid_sync();
    mark(a, 2 + 5 * l);
    gemv_phase<KIND>(a, P_WO, l, l == 0, sm);
    grid_sync();
    mark(a, 3 + 5 * l);
    gemv_phase<KIND>(a, P_W13, l, l == 0, sm);
    grid_sync();
    mark(a, 4 + 5 * l);
    gemv_phase<KIND>(a, P_W2, l, l == 0, sm);
    grid_sync();
    mark(a, 5 + 5 * l);
  }
  if (blockIdx.x == 0) {
    final_norm_out(a, sm);
    mark(a, 1 + 5 * a.L);
  }
}

template <int KIND>
const void* kernel_fn() {
  return reinterpret_cast<const void*>(fused_decode_kernel<KIND>);
}

const void* kernel_for(int w_kind) {
  switch (w_kind) {
    case W_INT8: return kernel_fn<W_INT8>();
    case W_BF16: return kernel_fn<W_BF16>();
    case W_FP32: return kernel_fn<W_FP32>();
    default: return nullptr;
  }
}

}  // namespace

// One decode step: a cooperative launch of a->grid blocks of 256 threads on
// `stream`. Returns the cudaError_t of the launch (a refused cooperative
// launch is an error, never a fallback).
extern "C" int fused_decode(const FusedArgs* a, void* stream) {
  const void* fn = kernel_for(a->w_kind);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_cooperative(fn, *a, a->grid, a->smem_bytes,
                                             static_cast<cudaStream_t>(stream)));
}

// Blocks of the kernel for weight kind `w_kind` that fit one SM with `smem`
// bytes of dynamic shared memory each.
extern "C" int fused_decode_blocks_per_sm(int w_kind, int smem, int* out) {
  const void* fn = kernel_for(w_kind);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(blocks_per_sm(fn, smem, out));
}
