// Paged decode attention for Hopper (sm_90a), one source for both pool types.
//
// Replaces the Pallas TPU kernels `_paged_attn_kernel` (16-bit pool) and
// `_paged_attn_q8_kernel` (int8 pool) of
// src/repro/kernels/paged_attn/paged_attn.py.  What it computes is theirs:
// one query per sequence, the GQA group of query heads per kv head, keys read
// through the page table, an online softmax, and a key kept iff
// `idx < length` and, with a window, `idx > length - 1 - window`.  A row with
// no valid key (an idle slot, `length == 0`) gives zeros, as Pallas does.
// On the int8 pool the K scale of each key's page multiplies its logit and
// the V scale multiplies that key's probability before `p * v` is added to
// the accumulator.
//
// What bounds it on an H100: bytes.  Each key of a sequence is read once per
// kv head (Dh values of K and of V) and used by only `group` queries, so the
// work is a few FLOPs per byte, far below the ~295 FLOP/byte the card needs
// before its tensor cores limit.  The design therefore only tries not to
// waste bytes:
//   * one block per (sequence, kv head) holds the whole query group, so a kv
//     row is read once for the group, not `group` times as the Pallas grid
//     (B, Hkv, pages) over query heads would on a GPU;
//   * the page loop runs inside the block, over the valid keys only:
//     [max(0, length - window), length), never the padding pages of the
//     table, and the ragged tail of the last page is skipped;
//   * K and V stay in their storage type (bf16, fp32 or int8) in device
//     memory and turn into fp32 in registers; nothing is dequantized to
//     device memory.
// It is a first, simple kernel: no tensor cores, no TMA, and no split over
// the key axis (flash-decoding), which a small batch would need to fill the
// card's 132 SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int KT = 64;  // keys per tile of the page loop

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// grid (Hkv, B), block THREADS.  Shared: row offsets of the tile's keys, then
// q (G x Dh), acc (G x Dh), probabilities (G x KT), m, l, alpha (G), and the
// V scales of the tile's keys (KT).
template <typename T, bool Q8>
__global__ void __launch_bounds__(THREADS) paged_attn_kernel(
    const T* __restrict__ q,
    const typename std::conditional<Q8, int8_t, T>::type* __restrict__ k_pool,
    const typename std::conditional<Q8, int8_t, T>::type* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ page_table, const int* __restrict__ lengths,
    T* __restrict__ out, int Hq, int Hkv, int Dh, int ps, int mp, int window,
    float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  size_t* row_s = reinterpret_cast<size_t*>(smem_raw);
  float* q_s = reinterpret_cast<float*>(row_s + KT);
  float* acc_s = q_s + G * Dh;
  float* p_s = acc_s + G * Dh;
  float* m_s = p_s + G * KT;
  float* l_s = m_s + G;
  float* a_s = l_s + G;
  float* vsc_s = a_s + G;

  const T* qb = q + ((size_t)b * Hq + (size_t)h * G) * Dh;
  for (int i = tid; i < G * Dh; i += THREADS) {
    q_s[i] = to_f(qb[i]);
    acc_s[i] = 0.f;
  }
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  const int length = lengths[b];
  // every key in [lo, hi) is valid, every other key is masked; keys past
  // the page table's width are out of reach, as in the plain version
  const int lo = window > 0 ? max(0, length - window) : 0;
  const int hi = min(length, mp * ps);
  const int* pt = page_table + (size_t)b * mp;
  __syncthreads();

  for (int t0 = lo; t0 < hi; t0 += KT) {
    const int nt = min(KT, hi - t0);
    // logits: one warp per key, lanes over Dh
    for (int t = warp; t < nt; t += NWARPS) {
      const int idx = t0 + t;
      const int page = pt[idx / ps];
      const size_t row = (((size_t)page * ps + idx % ps) * Hkv + h) * Dh;
      const float ks = Q8 ? k_scale[(size_t)page * Hkv + h] : 1.f;
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
        for (int d = lane; d < Dh; d += 32)
          dot += q_s[g * Dh + d] * to_f(k_pool[row + d]);
        dot = warp_sum(dot);
        if (lane == 0) p_s[g * KT + t] = dot * (scale * ks);
      }
      if (lane == 0) {
        row_s[t] = row;
        if (Q8) vsc_s[t] = v_scale[(size_t)page * Hkv + h];
      }
    }
    __syncthreads();
    // online-softmax statistics: one warp per query of the group
    for (int g = warp; g < G; g += NWARPS) {
      float mx = NEG_INF;
      for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, p_s[g * KT + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < nt; t += 32) {
        const float p = expf(p_s[g * KT + t] - m_new);
        p_s[g * KT + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + sum_t p_t * (v scale) * v_t
    for (int i = tid; i < G * Dh; i += THREADS) {
      const int g = i / Dh, d = i - g * Dh;
      float a = acc_s[i] * a_s[g];
      for (int t = 0; t < nt; ++t) {
        float p = p_s[g * KT + t];
        if (Q8) p *= vsc_s[t];
        a += p * to_f(v_pool[row_s[t] + d]);
      }
      acc_s[i] = a;
    }
    __syncthreads();
  }

  T* ob = out + ((size_t)b * Hq + (size_t)h * G) * Dh;
  for (int i = tid; i < G * Dh; i += THREADS) {
    const float l = l_s[i / Dh];
    ob[i] = from_f<T>(acc_s[i] / (l == 0.f ? 1.f : l));
  }
}

template <typename T, bool Q8>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale, const void* page_table,
           const void* lengths, void* out, int B, int Hq, int Hkv, int Dh,
           int ps, int mp, int window, void* stream) {
  using KV = typename std::conditional<Q8, int8_t, T>::type;
  const int G = Hq / Hkv;
  const size_t smem =
      KT * sizeof(size_t) + sizeof(float) * (2 * G * Dh + G * KT + 3 * G + KT);
  auto kern = paged_attn_kernel<T, Q8>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const dim3 grid(Hkv, B);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k_pool),
      static_cast<const KV*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<T*>(out), Hq, Hkv, Dh, ps,
      mp, window, 1.0f / sqrtf((float)Dh));
  return (int)cudaGetLastError();
}

}  // namespace

#define PAGED_ATTN_ENTRY(NAME, T, Q8)                                        \
  extern "C" int NAME(const void* q, const void* k_pool, const void* v_pool, \
                      const void* k_scale, const void* v_scale,              \
                      const void* page_table, const void* lengths, void* out, \
                      int B, int Hq, int Hkv, int Dh, int ps, int mp,        \
                      int window, void* stream) {                            \
    return launch<T, Q8>(q, k_pool, v_pool, k_scale, v_scale, page_table,    \
                         lengths, out, B, Hq, Hkv, Dh, ps, mp, window,       \
                         stream);                                            \
  }

PAGED_ATTN_ENTRY(paged_attn_f32, float, false)
PAGED_ATTN_ENTRY(paged_attn_bf16, __nv_bfloat16, false)
PAGED_ATTN_ENTRY(paged_attn_q8_f32, float, true)
PAGED_ATTN_ENTRY(paged_attn_q8_bf16, __nv_bfloat16, true)
