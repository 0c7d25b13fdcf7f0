// Paged flash-decode attention for Hopper (sm_90a), split over the work list.
//
// Replaces the TPU kernel kuiperllama_tpu/ops/pallas/paged_attention.py
// `_kernel` (entry `paged_attention_flat`), which every PagedEngine decode
// step runs once per layer. It computes what `_kernel` computes: for each
// row b with items in the flat work list (flat_b sorted over [0, n_items)),
// flash statistics over the row's pages of one layer, for every query head
// h against kv head h / kv_mul:
//   s      = (q . k) / sqrt(hd), fp32 accumulation of the products (k is
//            rounded to q's dtype first, as `kbuf.astype(q.dtype)`)
//   mask   tok0 + t < seq_lens[b]; a masked slot weighs 0
//   m      = max_t s;  l = sum_t exp(s - m);  acc = sum_t exp(s - m) v
// and writes the UNNORMALISED acc [B, H, hd], m [B, H], l [B, H] in fp32.
// A row with no items gets the flash identity (acc 0, m -1e30, l 0), where
// the TPU kernel leaves it unwritten.
//
// What bounds it on this card: the bytes of the K/V pages it reads. Every
// valid token's K and V row of the kv head is read once and used for kv_mul
// heads' worth of multiply-adds (at most 2 x 8 per byte): far below the
// card's ~295 operations per byte. At Llama-2-7B, eight rows of 1 to 1024
// tokens (2,998 in all) are 49 MB of bf16 K/V, 14.7 us at 3.35 TB/s. The
// TPU kernel walks a row's pages in order on one core; here the pages are
// split across blocks (flash-decoding), so the time is not one block's walk
// of the longest row:
//   * pass 1, one block per (work item, kv head): the grid spans the work
//     list's padded length and blocks at or past *n_items exit, so n_items
//     stays on the device. A block copies its page's valid K rows and then
//     its V rows of the kv head into shared memory with cp.async, 16 bytes a
//     thread and neighbouring threads on neighbouring bytes of a token's row
//     (a page's rows are kv_dim apart, each row's hd values contiguous), so
//     every load coalesces and up to 64 KB a block are in flight. It scores
//     the page against its kv_mul query heads (one thread per token, K rows
//     read from shared memory with a 16-byte row pad against bank
//     conflicts) while V lands, then writes the page's own statistics:
//     m_i = max_t s, p = exp(s - m_i) (rounded to the pool dtype before the
//     pv product, as the TPU kernel rounds it), l_i, acc_i into fp32
//     scratch. Slots at or past seq_len are not read at all;
//   * pass 2, one block per (row, query head): merges the row's items in
//     work-list order, m = max m_i, l = sum l_i exp(m_i - m),
//     acc = sum acc_i exp(m_i - m).
// Every sum runs in a fixed order (token groups by butterfly shuffles, then
// warps in order; items in order) and there are no atomics: results repeat
// bit for bit. Against the page-sequential recurrence m is exact (a max is
// order-free); l and acc differ in summation order, and with a bf16 pool p
// is rounded relative to its page's max instead of the running max.

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
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static float round(float x) { return x; }
};

template <>
struct Pool<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
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

// Shared memory of pass 1, in bytes: K rows (or, after the scores, the
// token groups' partial accumulators), V rows, the query heads, the scores.
struct Layout {
  int ld;            // row pitch of the K/V tiles, in pool elements
  size_t kv, red, q, p, total;
  __host__ __device__ Layout(int kv_mul, int hd, int ps, int elem) {
    ld = hd + 16 / elem;
    kv = static_cast<size_t>(ps) * ld * elem;
    red = static_cast<size_t>(kWarps) * kv_mul * hd * 4;
    q = static_cast<size_t>(kv_mul) * hd * 4;
    p = static_cast<size_t>(kv_mul) * ps * 4;
    total = (kv > red ? kv : red) + kv + q + p;
  }
};

// Pass 1. Block (work item blockIdx.x, kv head blockIdx.y). MAXMUL >= kv_mul
// bounds the per-thread register arrays.
template <typename PT, int MAXMUL>
__global__ void __launch_bounds__(kThreads)
page_stats_kernel(const void* __restrict__ q, int q_bf16, const PT* __restrict__ kp,
                  const PT* __restrict__ vp, const int* __restrict__ flat_b,
                  const int* __restrict__ flat_page, const int* __restrict__ flat_tok0,
                  const int* __restrict__ n_items_p, const int* __restrict__ seq_lens,
                  float* __restrict__ part_acc, float* __restrict__ part_m,
                  float* __restrict__ part_l, int H, int KH, int hd, int ps,
                  int n_pages, int max_items, float scale) {
  constexpr int VEC = Pool<PT>::kVec;
  const int it = blockIdx.x, kh = blockIdx.y;
  if (it >= min(*n_items_p, max_items)) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kv_mul = H / KH, h0 = kh * kv_mul;
  const long long kv_dim = static_cast<long long>(KH) * hd;
  const int b = flat_b[it];
  const long long page = min(max(flat_page[it], 0), n_pages - 1);
  const int nvalid = max(0, min(ps, seq_lens[b] - flat_tok0[it]));
  const long long base = page * ps * kv_dim + static_cast<long long>(kh) * hd;

  const Layout lay(kv_mul, hd, ps, sizeof(PT));
  extern __shared__ __align__(16) unsigned char smem[];
  PT* ks = reinterpret_cast<PT*>(smem);
  float* red = reinterpret_cast<float*>(smem);  // reuses ks after the scores
  const size_t kv_region = lay.kv > lay.red ? lay.kv : lay.red;
  PT* vs = reinterpret_cast<PT*>(smem + kv_region);
  float* qs = reinterpret_cast<float*>(smem + kv_region + lay.kv);
  float* pr = reinterpret_cast<float*>(smem + kv_region + lay.kv + lay.q);

  // K rows, then V rows, of the page's valid tokens: two copy groups
  const int chunks = hd / VEC;
  for (int i = tid; i < nvalid * chunks; i += kThreads) {
    const int t = i / chunks, c = (i % chunks) * VEC;
    cp_async16(ks + t * lay.ld + c, kp + base + t * kv_dim + c);
  }
  cp_async_commit();
  for (int i = tid; i < nvalid * chunks; i += kThreads) {
    const int t = i / chunks, c = (i % chunks) * VEC;
    cp_async16(vs + t * lay.ld + c, vp + base + t * kv_dim + c);
  }
  cp_async_commit();
  for (int i = tid; i < kv_mul * hd; i += kThreads) {
    const size_t qi = (static_cast<size_t>(b) * H + h0) * hd + i;
    qs[i] = q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[qi])
                   : static_cast<const float*>(q)[qi];
  }
  cp_async_wait<1>();  // K has landed (V may still be in flight)
  __syncthreads();

  // scores: one thread per token
  // a bf16 query meets fp32 K rows rounded to bf16, as the TPU kernel casts
  // the page to q's dtype
  const bool round_k = q_bf16 && sizeof(PT) == 4;
  for (int t = tid; t < ps; t += kThreads) {
    float s[MAXMUL];
#pragma unroll
    for (int j = 0; j < MAXMUL; ++j) s[j] = 0.f;
    if (t < nvalid) {
      const PT* krow = ks + t * lay.ld;
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
      if (j < kv_mul) pr[j * ps + t] = t < nvalid ? s[j] * scale : kNegInf;
  }
  __syncthreads();

  // the page's max, p and sum: one warp per query head
  for (int j = warp; j < kv_mul; j += kWarps) {
    float mx = kNegInf;
    for (int t = lane; t < ps; t += 32) mx = fmaxf(mx, pr[j * ps + t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < ps; t += 32) {
      const float p = t < nvalid ? expf(pr[j * ps + t] - mx) : 0.f;
      pr[j * ps + t] = Pool<PT>::round(p);
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const size_t o = static_cast<size_t>(it) * H + h0 + j;
      part_m[o] = mx;
      part_l[o] = sum;
    }
  }
  cp_async_wait<0>();  // V has landed
  __syncthreads();

  // pv: this thread's 16-byte column chunk over its token group
  const int groups = kThreads / chunks;
  const int c = tid % chunks, grp = tid / chunks;
  float acc[MAXMUL][VEC];
#pragma unroll
  for (int j = 0; j < MAXMUL; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[j][e] = 0.f;
  for (int t = grp; t < nvalid; t += groups) {
    float vv[VEC];
    Pool<PT>::load(vs + t * lay.ld + c * VEC, vv);
#pragma unroll
    for (int j = 0; j < MAXMUL; ++j) {
      if (j < kv_mul) {
        const float p = pr[j * ps + t];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[j][e] = fmaf(p, vv[e], acc[j][e]);
      }
    }
  }
  // the token groups of a warp (lanes chunks apart) by butterfly shuffles,
  // then one partial per warp (or per group, if a group spans warps)
  for (int o = chunks; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < MAXMUL; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[j][e] += __shfl_xor_sync(0xffffffffu, acc[j][e], o);
  }
  const int per_warp = chunks < 32 ? 32 / chunks : 1;  // groups in a warp
  const int parts = groups / per_warp;
  if (grp % per_warp == 0) {
    const int part = grp / per_warp;
#pragma unroll
    for (int j = 0; j < MAXMUL; ++j)
      if (j < kv_mul)
#pragma unroll
        for (int e = 0; e < VEC; ++e) red[(part * kv_mul + j) * hd + c * VEC + e] = acc[j][e];
  }
  __syncthreads();
  for (int i = tid; i < kv_mul * hd; i += kThreads) {
    float a = 0.f;
    for (int part = 0; part < parts; ++part) a += red[part * kv_mul * hd + i];
    part_acc[(static_cast<size_t>(it) * H + h0) * hd + i] = a;
  }
}

// Pass 2. Block (row blockIdx.x, query head blockIdx.y): the row's items in
// work-list order.
__global__ void __launch_bounds__(kThreads)
merge_items_kernel(const int* __restrict__ flat_b, const int* __restrict__ n_items_p,
                   const float* __restrict__ part_acc, const float* __restrict__ part_m,
                   const float* __restrict__ part_l, float* __restrict__ acc_out,
                   float* __restrict__ m_out, float* __restrict__ l_out, int H,
                   int hd, int max_items) {
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int n = min(*n_items_p, max_items);
  const int lo = lower_bound(flat_b, n, b);
  const int hi = lower_bound(flat_b, n, b + 1);
  float mx = kNegInf;
  for (int i = lo; i < hi; ++i) mx = fmaxf(mx, part_m[static_cast<size_t>(i) * H + h]);
  for (int d = tid; d < hd; d += kThreads) {
    float a = 0.f;
    for (int i = lo; i < hi; ++i) {
      const size_t o = static_cast<size_t>(i) * H + h;
      a += part_acc[o * hd + d] * expf(part_m[o] - mx);
    }
    acc_out[(static_cast<size_t>(b) * H + h) * hd + d] = a;
  }
  if (tid == 0) {
    float l = 0.f;
    for (int i = lo; i < hi; ++i) {
      const size_t o = static_cast<size_t>(i) * H + h;
      l += part_l[o] * expf(part_m[o] - mx);
    }
    m_out[static_cast<size_t>(b) * H + h] = mx;
    l_out[static_cast<size_t>(b) * H + h] = l;
  }
}

// Lets `kernel` take as much dynamic shared memory as a block of this
// device may opt in to; once per kernel.
template <typename Kernel>
cudaError_t allow_max_smem(Kernel kernel) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  return err;
}

template <typename PT, int MAXMUL>
cudaError_t launch_stats(const void* q, int q_bf16, const void* kp, const void* vp,
                         const int* fb, const int* fp, const int* ft, const int* ni,
                         const int* sl, float* pacc, float* pm, float* pl, int H,
                         int KH, int hd, int ps, int n_pages, int max_items,
                         float scale, cudaStream_t stream) {
  const Layout lay(H / KH, hd, ps, sizeof(PT));
  static const cudaError_t attr = allow_max_smem(page_stats_kernel<PT, MAXMUL>);
  if (attr != cudaSuccess) return attr;
  page_stats_kernel<PT, MAXMUL><<<dim3(max_items, KH), kThreads, lay.total, stream>>>(
      q, q_bf16, static_cast<const PT*>(kp), static_cast<const PT*>(vp), fb, fp,
      ft, ni, sl, pacc, pm, pl, H, KH, hd, ps, n_pages, max_items, scale);
  return cudaGetLastError();
}

template <typename PT>
cudaError_t launch_mul(const void* q, int q_bf16, const void* kp, const void* vp,
                       const int* fb, const int* fp, const int* ft, const int* ni,
                       const int* sl, float* pacc, float* pm, float* pl, int H,
                       int KH, int hd, int ps, int n_pages, int max_items, float scale,
                       cudaStream_t st) {
  const int kv_mul = H / KH;
  if (kv_mul <= 1)
    return launch_stats<PT, 1>(q, q_bf16, kp, vp, fb, fp, ft, ni, sl, pacc, pm, pl, H, KH, hd, ps, n_pages, max_items, scale, st);
  if (kv_mul <= 2)
    return launch_stats<PT, 2>(q, q_bf16, kp, vp, fb, fp, ft, ni, sl, pacc, pm, pl, H, KH, hd, ps, n_pages, max_items, scale, st);
  if (kv_mul <= 4)
    return launch_stats<PT, 4>(q, q_bf16, kp, vp, fb, fp, ft, ni, sl, pacc, pm, pl, H, KH, hd, ps, n_pages, max_items, scale, st);
  if (kv_mul <= 8)
    return launch_stats<PT, 8>(q, q_bf16, kp, vp, fb, fp, ft, ni, sl, pacc, pm, pl, H, KH, hd, ps, n_pages, max_items, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B, H, hd] (fp32 or bf16); k_pages, v_pages: one layer's pool
// [n_pages, ps, KH*hd] (both fp32 or both bf16), 16-byte aligned; flat_b,
// flat_page, flat_tok0 [max_items] int32 and n_items [1] int32, the work
// list of build_work_list; seq_lens [B] int32; part_acc [max_items, H, hd],
// part_m and part_l [max_items, H] fp32 scratch; acc [B, H, hd], m [B, H],
// l [B, H] fp32 outputs, every row written. Needs kv_mul = H / KH <= 8, hd
// a multiple of 16 bytes' worth of the pool dtype with 128 divisible by
// hd / (values per 16 bytes), and pass 1's shared memory (Layout) within
// what a block may opt in to. Two launches; returns the first failing
// launch's cudaError_t.
extern "C" int paged_attention(const void* q, int q_bf16, const void* k_pages,
                               const void* v_pages, int pool_bf16, const int* flat_b,
                               const int* flat_page, const int* flat_tok0,
                               const int* n_items, const int* seq_lens, float* part_acc,
                               float* part_m, float* part_l, float* acc, float* m,
                               float* l, int B, int H, int KH, int hd, int ps,
                               int n_pages, int max_items, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      pool_bf16
          ? launch_mul<__nv_bfloat16>(q, q_bf16, k_pages, v_pages, flat_b, flat_page,
                                      flat_tok0, n_items, seq_lens, part_acc, part_m,
                                      part_l, H, KH, hd, ps, n_pages, max_items, scale, st)
          : launch_mul<float>(q, q_bf16, k_pages, v_pages, flat_b, flat_page, flat_tok0,
                              n_items, seq_lens, part_acc, part_m, part_l, H, KH, hd, ps,
                              n_pages, max_items, scale, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_items_kernel<<<dim3(B, H), kThreads, 0, st>>>(flat_b, n_items, part_acc, part_m,
                                                      part_l, acc, m, l, H, hd, max_items);
  return static_cast<int>(cudaGetLastError());
}
