// Paged flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel kuiperllama_tpu/ops/pallas/paged_attention.py
// `_kernel` (entry `paged_attention_flat`), which every PagedEngine decode
// step runs once per layer. It computes what `_kernel` computes: for each
// row b with items in the flat work list (flat_b sorted over [0, n_items)),
// flash statistics over the row's pages of one layer, for every query head
// h against kv head h / kv_mul, page by page in work-list order:
//   s      = (q . k) / sqrt(hd), fp32 accumulation of the products (k is
//            rounded to q's dtype first, as `kbuf.astype(q.dtype)`)
//   mask   tok0 + t < seq_lens[b]; a masked slot scores -1e30, weighs 0
//   m_new  = max(m, max_t s);  p = exp(s - m_new);  corr = exp(m - m_new)
//   l      = l * corr + sum_t p
//   acc    = acc * corr + sum_t pool_dtype(p) * v   (p rounded before pv)
// and writes the UNNORMALISED acc [B, H, hd], m [B, H], l [B, H] in fp32.
// A row with no items gets the flash identity (acc 0, m -1e30, l 0), where
// the TPU kernel leaves it unwritten.
//
// What bounds it on this card: the bytes of the K/V pages it reads. Every
// valid token's K and V row of the kv head is read once and used for kv_mul
// heads' worth of multiply-adds (at most 2 x 8 per byte): far below the
// card's ~295 operations per byte. At Llama-2-7B, eight rows of 1 to 1024
// tokens (2,998 in all) are 49 MB of bf16 K/V, 14.7 us at 3.35 TB/s. The
// design aims at that stream, simply:
//   * one block per (kv head, row), 128 threads; the block finds its row's
//     item range in the sorted flat_b by binary search and keeps the
//     kv_mul query heads of its kv head in shared memory, so each K/V byte
//     serves all of them;
//   * a token's hd values of one kv head are contiguous (the pool layout is
//     [L, P, ps, KH*hd]), so every load is 16 bytes: for the scores one
//     thread per token reads its K row; for pv each thread owns a 16-byte
//     column chunk and walks a strided set of tokens, neighbouring threads
//     on neighbouring chunks;
//   * slots at or past seq_len are not read at all (their weight is 0), so
//     a partly filled last page costs only its valid rows;
//   * pages run in order with the running max, sum and accumulator carried
//     in the block (the TPU kernel's page-sequential recurrence, so p is
//     rounded at the same point), and the token groups' partial
//     accumulators are summed in a fixed order: results repeat bit for bit.
// This first version is simple on purpose: no page split across blocks
// (at B = 8 the grid is KH x 8 blocks for 132 SMs), no cp.async or TMA
// ring, and three block barriers per page.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

template <typename PT>
struct Pool;

template <>
struct Pool<float> {
  static constexpr int kVec = 4;  // values per 16-byte load
  __device__ static void load(const float* p, float* out) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static float round(float x) { return x; }
};

template <>
struct Pool<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// First index in sorted a[0, n) whose value is >= key.
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Block (kv head blockIdx.x, row blockIdx.y). MAXMUL >= kv_mul bounds the
// per-thread register arrays.
template <typename PT, int MAXMUL>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const void* __restrict__ q, int q_bf16,
                       const PT* __restrict__ kp, const PT* __restrict__ vp,
                       const int* __restrict__ flat_b, const int* __restrict__ flat_page,
                       const int* __restrict__ flat_tok0, const int* __restrict__ n_items_p,
                       const int* __restrict__ seq_lens, float* __restrict__ acc_out,
                       float* __restrict__ m_out, float* __restrict__ l_out,
                       int H, int KH, int hd, int ps, int n_pages, int max_items,
                       float scale) {
  constexpr int VEC = Pool<PT>::kVec;
  const int kh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int kv_mul = H / KH, h0 = kh * kv_mul;
  const long long kv_dim = static_cast<long long>(KH) * hd;

  extern __shared__ float smem[];
  float* qs = smem;               // [kv_mul][hd] the block's query heads
  float* ss = qs + kv_mul * hd;   // [kv_mul][ps] scores of the current page
  float* pr = ss + kv_mul * ps;   // [kv_mul][ps] p rounded to the pool dtype
  float* red = pr + kv_mul * ps;  // [kv_mul][hd] sum of the token groups
  __shared__ float m_s[MAXMUL], l_s[MAXMUL], corr_s[MAXMUL];

  const int n = min(*n_items_p, max_items);
  const int lo = lower_bound(flat_b, n, b);
  const int hi = lower_bound(flat_b, n, b + 1);

  for (int i = tid; i < kv_mul * hd; i += kThreads) {
    const size_t qi = (static_cast<size_t>(b) * H + h0) * hd + i;
    qs[i] = q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[qi])
                   : static_cast<const float*>(q)[qi];
  }
  if (tid < MAXMUL) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    corr_s[tid] = 1.f;
  }
  // a bf16 query meets fp32 K rows rounded to bf16, as the TPU kernel casts
  // the page to q's dtype
  const bool round_k = q_bf16 && sizeof(PT) == 4;
  const int chunks = hd / VEC;           // 16-byte chunks of a K/V row
  const int groups = kThreads / chunks;  // token groups of the pv product
  const int c = tid % chunks, grp = tid / chunks;
  const int seq_len = seq_lens[b];
  float acc[MAXMUL][VEC];
#pragma unroll
  for (int j = 0; j < MAXMUL; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[j][e] = 0.f;
  __syncthreads();

  for (int it = lo; it < hi; ++it) {
    const long long page = min(max(flat_page[it], 0), n_pages - 1);
    const int nvalid = max(0, min(ps, seq_len - flat_tok0[it]));
    const long long base = page * ps * kv_dim + static_cast<long long>(kh) * hd;

    // scores: one thread per token, 16-byte loads along its K row
    for (int t = tid; t < ps; t += kThreads) {
      float s[MAXMUL];
#pragma unroll
      for (int j = 0; j < MAXMUL; ++j) s[j] = 0.f;
      if (t < nvalid) {
        const PT* krow = kp + base + t * kv_dim;
        for (int d0 = 0; d0 < hd; d0 += VEC) {
          float kv[VEC];
          Pool<PT>::load(krow + d0, kv);
          if (round_k) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) kv[e] = Pool<__nv_bfloat16>::round(kv[e]);
          }
#pragma unroll
          for (int j = 0; j < MAXMUL; ++j) {
            if (j < kv_mul) {
              const float* qj = qs + j * hd + d0;
#pragma unroll
              for (int e = 0; e < VEC; ++e) s[j] = fmaf(qj[e], kv[e], s[j]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < MAXMUL; ++j)
        if (j < kv_mul) ss[j * ps + t] = t < nvalid ? s[j] * scale : kNegInf;
    }
    __syncthreads();

    // running max, p and the page's sum: one warp per query head
    for (int j = warp; j < kv_mul; j += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < ps; t += 32) mx = fmaxf(mx, ss[j * ps + t]);
      mx = warp_max(mx);
      const float m_old = m_s[j];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < ps; t += 32) {
        const float p = t < nvalid ? expf(ss[j * ps + t] - m_new) : 0.f;
        pr[j * ps + t] = Pool<PT>::round(p);
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[j] = l_s[j] * corr + sum;
        m_s[j] = m_new;
        corr_s[j] = corr;
      }
    }
    __syncthreads();

    // pv: this thread's column chunk over its token group
#pragma unroll
    for (int j = 0; j < MAXMUL; ++j) {
      if (j < kv_mul) {
        const float corr = corr_s[j];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[j][e] *= corr;
      }
    }
    const PT* vcol = vp + base + c * VEC;
    for (int t = grp; t < nvalid; t += groups) {
      float vv[VEC];
      Pool<PT>::load(vcol + t * kv_dim, vv);
#pragma unroll
      for (int j = 0; j < MAXMUL; ++j) {
        if (j < kv_mul) {
          const float p = pr[j * ps + t];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[j][e] = fmaf(p, vv[e], acc[j][e]);
        }
      }
    }
    __syncthreads();  // the next page overwrites ss, pr and corr_s
  }

  // sum the token groups' partial accumulators in group order
  for (int g = 0; g < groups; ++g) {
    if (grp == g) {
#pragma unroll
      for (int j = 0; j < MAXMUL; ++j) {
        if (j < kv_mul) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            float* r = red + j * hd + c * VEC + e;
            *r = (g == 0 ? 0.f : *r) + acc[j][e];
          }
        }
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < kv_mul * hd; i += kThreads)
    acc_out[(static_cast<size_t>(b) * H + h0) * hd + i] = red[i];
  if (tid < kv_mul) {
    m_out[static_cast<size_t>(b) * H + h0 + tid] = m_s[tid];
    l_out[static_cast<size_t>(b) * H + h0 + tid] = l_s[tid];
  }
}

template <typename PT, int MAXMUL>
cudaError_t launch(const void* q, int q_bf16, const void* kp, const void* vp,
                   const int* fb, const int* fp, const int* ft, const int* ni,
                   const int* sl, float* acc, float* m, float* l, int B, int H,
                   int KH, int hd, int ps, int n_pages, int max_items, float scale,
                   cudaStream_t stream) {
  const int kv_mul = H / KH;
  const size_t smem = static_cast<size_t>(2 * kv_mul * (hd + ps)) * sizeof(float);
  paged_attention_kernel<PT, MAXMUL><<<dim3(KH, B), kThreads, smem, stream>>>(
      q, q_bf16, static_cast<const PT*>(kp), static_cast<const PT*>(vp), fb, fp,
      ft, ni, sl, acc, m, l, H, KH, hd, ps, n_pages, max_items, scale);
  return cudaGetLastError();
}

template <typename PT>
cudaError_t launch_mul(const void* q, int q_bf16, const void* kp, const void* vp,
                       const int* fb, const int* fp, const int* ft, const int* ni,
                       const int* sl, float* acc, float* m, float* l, int B, int H,
                       int KH, int hd, int ps, int n_pages, int max_items, float scale,
                       cudaStream_t st) {
  const int kv_mul = H / KH;
  if (kv_mul <= 1)
    return launch<PT, 1>(q, q_bf16, kp, vp, fb, fp, ft, ni, sl, acc, m, l, B, H, KH, hd, ps, n_pages, max_items, scale, st);
  if (kv_mul <= 2)
    return launch<PT, 2>(q, q_bf16, kp, vp, fb, fp, ft, ni, sl, acc, m, l, B, H, KH, hd, ps, n_pages, max_items, scale, st);
  if (kv_mul <= 4)
    return launch<PT, 4>(q, q_bf16, kp, vp, fb, fp, ft, ni, sl, acc, m, l, B, H, KH, hd, ps, n_pages, max_items, scale, st);
  if (kv_mul <= 8)
    return launch<PT, 8>(q, q_bf16, kp, vp, fb, fp, ft, ni, sl, acc, m, l, B, H, KH, hd, ps, n_pages, max_items, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B, H, hd] (fp32 or bf16); k_pages, v_pages: one layer's pool
// [n_pages, ps, KH*hd] (both fp32 or both bf16), 16-byte aligned; flat_b,
// flat_page, flat_tok0 [max_items] int32 and n_items [1] int32, the work
// list of build_work_list; seq_lens [B] int32; acc [B, H, hd], m [B, H],
// l [B, H] fp32 outputs, every row written. Needs kv_mul = H / KH <= 8,
// hd a multiple of 16 bytes' worth of the pool dtype with 128 divisible by
// hd / (values per 16 bytes). Returns the launch's cudaError_t.
extern "C" int paged_attention(const void* q, int q_bf16, const void* k_pages,
                               const void* v_pages, int pool_bf16, const int* flat_b,
                               const int* flat_page, const int* flat_tok0,
                               const int* n_items, const int* seq_lens, float* acc,
                               float* m, float* l, int B, int H, int KH, int hd, int ps,
                               int n_pages, int max_items, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      pool_bf16
          ? launch_mul<__nv_bfloat16>(q, q_bf16, k_pages, v_pages, flat_b, flat_page,
                                      flat_tok0, n_items, seq_lens, acc, m, l, B, H, KH,
                                      hd, ps, n_pages, max_items, scale, st)
          : launch_mul<float>(q, q_bf16, k_pages, v_pages, flat_b, flat_page, flat_tok0,
                              n_items, seq_lens, acc, m, l, B, H, KH, hd, ps, n_pages,
                              max_items, scale, st);
  return static_cast<int>(err);
}
