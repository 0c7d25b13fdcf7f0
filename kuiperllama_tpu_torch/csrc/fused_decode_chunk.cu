// Greedy chunk megakernel for Hopper (sm_90a): `steps` greedy B = 1 decode
// steps in one launch, lm_head, argmax and the next token's embedding
// included.
//
// Replaces the TPU kernel kuiperllama_tpu/ops/pallas/fused_decode.py
// `_chunk_kernel` (entry `fused_decode_chunk`), which the JAX Generator
// takes under KT_FUSED_CHUNK=1 for greedy sampling when the small plan
// fits. Each iteration s (slot pos0 + s) is the step of fused_decode.cu (the
// same phases, plan and per-projection activation types) and then:
//   * the final rmsnorm, which every block forms itself;
//   * the lm_head GEMV over column tiles spread over the blocks; a quantized
//     lm_head takes the int8 activation when its padded scale rows reach the
//     int8 rule (the host decides, `lm_int8a`), unlike the per-step route's
//     lm_head, which goes through the bf16-activation GEMV;
//   * the first-max argmax: the block that finishes a tile writes the
//     tile's (max, first column); after a grid barrier every block reduces
//     the pairs with the same comparison (larger value, then lower index),
//     so every block holds the same token and ties go to the lower index;
//   * the token goes to tokens[s] and its embedding row, rounded to bf16
//     (the wrapper hands the table over in bf16), becomes the residual
//     stream of step s + 1. Step 0 starts from x0 as given.
// The chunk's K/V rows are written into the caches in place at pos0 + s
// (the JAX kernel collects them and writes them after the chunk). A later
// step reads them back: their scores use K in bf16 (what was written) and
// their p is rounded to bf16 before the pv product whatever the cache dtype,
// while history slots (< pos0) round p to the cache dtype.
//
// What bounds it on this card: bytes per step, the layer stack plus the
// lm_head: TinyLlama-1.1B INT8 g 256 1.04 GB (0.311 ms at 3.35 TB/s),
// Qwen2.5-0.5B bf16 988 MB (0.295 ms), of which its 151936 x 896 dense
// lm_head is 272 MB. The design removes what the per-step route pays per
// token outside the megakernel (the lm_head launch, the sampling ops and
// the host's launching of each), at the cost of an in-kernel lm_head phase
// and one more grid barrier for the argmax. Everything else is the per-step
// kernel's design (fused_decode.cu), the split finish of the lm_head's tiles
// included (one fence per block); no TMA, no wgmma.

#include "fused_decode_common.cuh"

// Mirror of `_ChunkArgs` in ops/kernels/fused_decode.py.
struct ChunkArgs {
  FusedArgs f;
  const void* lm; const void* lm_s; const void* emb;
  int* tokens; float* pmax; int* pidx;
  int steps, vocab, lm_kind, lm_g, lm_s_bf16, lm_int8a, lm_ct, lm_ups;
};

namespace {

constexpr int kNoIndex = 0x7fffffff;

// (v, i) beats (w, j): larger value, then lower index.
__device__ __forceinline__ bool beats(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

// The block's best (value, index); every thread gets it.
__device__ void block_argmax(float& v, int& i, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    const int j = __shfl_xor_sync(0xffffffffu, i, o);
    if (beats(w, j, v, i)) { v = w; i = j; }
  }
  int* iscratch = reinterpret_cast<int*>(scratch + kWarps);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    scratch[threadIdx.x >> 5] = v;
    iscratch[threadIdx.x >> 5] = i;
  }
  __syncthreads();
  v = scratch[0];
  i = iscratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w)
    if (beats(scratch[w], iscratch[w], v, i)) { v = scratch[w]; i = iscratch[w]; }
  __syncthreads();
}

// The lm_head phase of one step: logits of the final-normed row, and per
// column tile its (max, first column) in pmax/pidx.
template <int LK>
__device__ void lm_phase(const ChunkArgs& c, const Smem& sm) {
  const FusedArgs& a = c.f;
  constexpr int CPT = Cols<LK>::n;
  const int K = a.d, N = c.vocab, ct = c.lm_ct, ups = c.lm_ups;
  const int unit = LK == W_INT8 ? c.lm_g : (K % kDenseUnitRows == 0 ? kDenseUnitRows : K);
  const int units = K / unit, W = ct * CPT;
  const int tiles = (N + W - 1) / W;
  const int splits = (units + ups - 1) / ups;
  const int items = tiles * splits;
  if (static_cast<int>(blockIdx.x) >= items) return;
  stage_norm(a, false, static_cast<const float*>(a.final_norm), sm.hs, sm.misc);
  const bool int8a = LK == W_INT8 && c.lm_int8a;
  if (int8a) quantize_act(sm.hs, K, c.lm_g, sm.aq, sm.dg);
  float* partial = static_cast<float*>(a.partial);
  unsigned int* counters = static_cast<unsigned int*>(a.counters);
  int* flag = reinterpret_cast<int*>(sm.misc + 63);
  const int tid = threadIdx.x;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int tile = item / splits, split = item % splits;
    const int row0 = split * ups * unit;
    const int row1 = min(K, row0 + ups * unit);
    gemv_tile<LK>(c.lm, c.lm_s, c.lm_s_bf16, N, tile * W, N, row0, row1, c.lm_g, int8a, ct,
                  sm, sm.out);
    const int col = tile * W + tid;
    const bool mine = tid < W && col < N;
    float v = kNegInf;
    int idx = kNoIndex;
    bool finish = splits == 1;
    if (finish) {
      if (mine) { v = sm.out[tid]; idx = col; }
    } else {
      if (mine) partial[(size_t)split * N + col] = sm.out[tid];
      __syncthreads();
      if (tid == 0) {  // one fence and count for the block, as finish_item
        __threadfence();
        *flag = atomicAdd(counters + tile, 1u) == static_cast<unsigned>(splits - 1);
        if (*flag) __threadfence();
      }
      __syncthreads();
      finish = *flag != 0;
      if (finish) {
        if (mine) {
          float t = 0.f;
          for (int sp = 0; sp < splits; ++sp) t += __ldcg(partial + (size_t)sp * N + col);
          v = t;
          idx = col;
        }
        if (tid == 0) counters[tile] = 0u;
      }
    }
    if (finish) {  // the same for every thread of the block
      block_argmax(v, idx, sm.misc);
      if (tid == 0) {
        c.pmax[tile] = v;
        c.pidx[tile] = idx;
      }
    }
    __syncthreads();
  }
}

// After the lm_head phase's barrier: the token every block agrees on.
__device__ int reduce_token(const ChunkArgs& c, const Smem& sm) {
  const int W = c.lm_ct * (c.lm_kind == W_INT8 ? 16 : (c.lm_kind == W_BF16 ? 8 : 4));
  const int tiles = (c.vocab + W - 1) / W;
  float v = kNegInf;
  int idx = kNoIndex;
  for (int t = threadIdx.x; t < tiles; t += kThreads) {
    const float w = __ldcg(c.pmax + t);
    const int j = __ldcg(c.pidx + t);
    if (beats(w, j, v, idx)) { v = w; idx = j; }
  }
  block_argmax(v, idx, sm.misc);
  return idx;
}

template <int KIND>
__global__ void __launch_bounds__(kThreads) fused_chunk_kernel(const ChunkArgs c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const FusedArgs& a = c.f;
  const Smem sm = smem_layout(smem, a);
  const int pos0 = *static_cast<const int*>(a.pos);
  if (pos0 < 0 || pos0 + c.steps > a.A) {  // outside the window: no step runs
    if (blockIdx.x == 0)
      for (int s = threadIdx.x; s < c.steps; s += kThreads) c.tokens[s] = -1;
    return;
  }
  for (int s = 0; s < c.steps; ++s) {
    const int pos = pos0 + s;
    for (int l = 0; l < a.L; ++l) {
      const bool first = s == 0 && l == 0;
      gemv_phase<KIND>(a, P_QKV, l, first, sm);
      grid_sync();
      attention_phase(a, l, pos, pos0, smem, sm);
      grid_sync();
      gemv_phase<KIND>(a, P_WO, l, first, sm);
      grid_sync();
      gemv_phase<KIND>(a, P_W13, l, first, sm);
      grid_sync();
      gemv_phase<KIND>(a, P_W2, l, first, sm);
      grid_sync();
    }
    switch (c.lm_kind) {
      case W_INT8: lm_phase<W_INT8>(c, sm); break;
      case W_BF16: lm_phase<W_BF16>(c, sm); break;
      default: lm_phase<W_FP32>(c, sm); break;
    }
    grid_sync();
    const int tok = reduce_token(c, sm);
    if (blockIdx.x == 0 && threadIdx.x == 0) c.tokens[s] = tok;
    if (s + 1 < c.steps) {
      // every block writes the same row; the next reads of x follow a
      // block barrier (its own writes) or a grid barrier (the others')
      const __nv_bfloat16* row = static_cast<const __nv_bfloat16*>(c.emb) + (size_t)tok * a.d;
      float* x = static_cast<float*>(a.x);
      for (int k = threadIdx.x; k < a.d; k += kThreads) x[k] = __bfloat162float(row[k]);
      __threadfence();
      __syncthreads();
    }
  }
}

const void* kernel_for(int w_kind) {
  switch (w_kind) {
    case W_INT8: return reinterpret_cast<const void*>(fused_chunk_kernel<W_INT8>);
    case W_BF16: return reinterpret_cast<const void*>(fused_chunk_kernel<W_BF16>);
    case W_FP32: return reinterpret_cast<const void*>(fused_chunk_kernel<W_FP32>);
    default: return nullptr;
  }
}

}  // namespace

// `steps` greedy steps: a cooperative launch of c->f.grid blocks of 256
// threads on `stream`. Returns the cudaError_t of the launch.
extern "C" int fused_decode_chunk(const ChunkArgs* c, void* stream) {
  const void* fn = kernel_for(c->f.w_kind);
  if (fn == nullptr || c->lm_kind < W_INT8 || c->lm_kind > W_FP32)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_cooperative(fn, *c, c->f.grid, c->f.smem_bytes,
                                             static_cast<cudaStream_t>(stream)));
}

// Blocks of the kernel for weight kind `w_kind` that fit one SM with `smem`
// bytes of dynamic shared memory each.
extern "C" int fused_decode_chunk_blocks_per_sm(int w_kind, int smem, int* out) {
  const void* fn = kernel_for(w_kind);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(blocks_per_sm(fn, smem, out));
}
