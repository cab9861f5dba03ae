// Paged selective-prefill attention (MPIC) for Hopper (sm_90a), one source
// for both pool types.
//
// Replaces the Pallas TPU kernels `_sel_attn_paged_kernel` (16-bit pool) and
// `_sel_attn_paged_q8_kernel` (int8 pool) of
// src/repro/kernels/selective_attn/selective_attn.py.  What it computes is
// theirs: the selected (recomputed) queries sit at their original prompt
// positions `q_pos`; keys and values are read through the page table, and
// slot `i` of a sequence holds position `i`.  A key is kept iff
// `i < length`, `i <= q_pos` and, with a window, `i > q_pos - window`.  An
// online softmax over the kept keys; a query row with none gives zeros.  On
// the int8 pool the K scale of each key's page multiplies its logit and the V
// scale multiplies that key's probability before `p * v` is accumulated.
//
// Layouts are the model's, read in place: q and out (B, Sq, Hq, Dh), pools
// (P, page_size, Hkv, Dh), page_table (B, mp), q_pos (B, Sq), lengths (B,),
// scales (P, Hkv).  The ragged edge of Sq is masked here; nothing is padded.
//
// What bounds it on an H100: at the served shapes (a few hundred selected
// queries against ~1.2k cached keys, Dh 128) the arithmetic, ~4 * Dh FLOPs
// per (query, key) pair, outweighs the bytes by far more than the card's
// ~295 FLOP/byte, so a kernel at its limit would be bound by tensor-core
// operations.  This first kernel does its math in fp32 on the CUDA cores, so
// it is bound by those (67 TFLOP/s fp32 peak), not by bytes.  What the
// design does:
//   * one block per (sequence, kv head, tile of queries) holds the tile for
//     all `group` query heads of that kv head, so each kv tile it loads into
//     shared memory serves the whole group (the Pallas grid (B, Hq, ...)
//     reads each page once per query head);
//   * the key loop runs inside the block and stops at the last key any query
//     of the tile can see, min(length, max(q_pos in tile) + 1), and starts
//     at the first one a window lets it see; the Pallas kernel walks every
//     page of the table and masks;
//   * K/V tiles are read once from device memory, coalesced along Dh, and
//     turned into fp32 in shared memory (int8 without a pass through device
//     memory).
// Moving the two products onto `wgmma` with TMA-fed tiles is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int KT = 32;    // keys per tile of the page loop
constexpr int ROWS = 16;  // (query, head) rows per block, at least `group`

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

// grid (ceil(Sq / QT), Hkv, B), block THREADS.  Block rows r = qi * G + g:
// query qi of the tile, head g of the group.  Shared: key row offsets (KT),
// K/V scales (KT each), q (R x Dh), acc (R x Dh), K tile (KT x (Dh+1), padded
// against bank conflicts), V tile (KT x Dh), logits/probabilities (R x KT),
// m, l, alpha (R), and the tile's query positions (QT).
template <typename T, bool Q8>
__global__ void __launch_bounds__(THREADS) sel_attn_paged_kernel(
    const T* __restrict__ q,
    const typename std::conditional<Q8, int8_t, T>::type* __restrict__ k_pool,
    const typename std::conditional<Q8, int8_t, T>::type* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ page_table, const int* __restrict__ q_pos,
    const int* __restrict__ lengths, T* __restrict__ out, int Sq, int Hq,
    int Hkv, int Dh, int ps, int mp, int window, int QT, float scale) {
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * QT;
  const int G = Hq / Hkv;
  const int R = QT * G;
  const int nq = min(QT, Sq - q0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  size_t* row_s = reinterpret_cast<size_t*>(smem_raw);
  float* ksc_s = reinterpret_cast<float*>(row_s + KT);
  float* vsc_s = ksc_s + KT;
  float* q_s = vsc_s + KT;
  float* acc_s = q_s + R * Dh;
  float* k_s = acc_s + R * Dh;
  float* v_s = k_s + KT * (Dh + 1);
  float* p_s = v_s + KT * Dh;
  float* m_s = p_s + R * KT;
  float* l_s = m_s + R;
  float* a_s = l_s + R;
  int* qpos_s = reinterpret_cast<int*>(a_s + R);
  __shared__ int range_s[2];

  for (int i = tid; i < R * Dh; i += THREADS) {
    const int r = i / Dh, d = i - r * Dh;
    const int qi = r / G, g = r - qi * G;
    q_s[i] = qi < nq ? to_f(q[(((size_t)b * Sq + q0 + qi) * Hq + h * G + g) *
                                   Dh + d])
                     : 0.f;
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < R; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  for (int i = tid; i < nq; i += THREADS) qpos_s[i] = q_pos[(size_t)b * Sq + q0 + i];
  __syncthreads();
  const int length = lengths[b];
  if (tid == 0) {
    int qmin = qpos_s[0], qmax = qpos_s[0];
    for (int i = 1; i < nq; ++i) {
      qmin = min(qmin, qpos_s[i]);
      qmax = max(qmax, qpos_s[i]);
    }
    // keys past the page table's width are out of reach, as in the plain
    // version
    range_s[0] = window > 0 ? max(0, qmin - window + 1) : 0;
    range_s[1] = min(min(length, qmax + 1), mp * ps);
  }
  __syncthreads();
  const int lo = range_s[0], hi = range_s[1];
  const int* pt = page_table + (size_t)b * mp;

  for (int t0 = lo; t0 < hi; t0 += KT) {
    const int nt = min(KT, hi - t0);
    for (int t = tid; t < nt; t += THREADS) {
      const int idx = t0 + t;
      const int page = pt[idx / ps];
      row_s[t] = (((size_t)page * ps + idx % ps) * Hkv + h) * Dh;
      if (Q8) {
        ksc_s[t] = k_scale[(size_t)page * Hkv + h];
        vsc_s[t] = v_scale[(size_t)page * Hkv + h];
      }
    }
    __syncthreads();
    for (int i = tid; i < nt * Dh; i += THREADS) {
      const int t = i / Dh, d = i - t * Dh;
      k_s[t * (Dh + 1) + d] = to_f(k_pool[row_s[t] + d]);
      v_s[t * Dh + d] = to_f(v_pool[row_s[t] + d]);
    }
    __syncthreads();
    // masked logits; NEG_INF marks a key the row may not see
    for (int i = tid; i < R * KT; i += THREADS) {
      const int r = i / KT, t = i - r * KT;
      const int qi = r / G;
      float s = NEG_INF;
      if (t < nt && qi < nq) {
        const int idx = t0 + t, qp = qpos_s[qi];
        if (idx <= qp && (window <= 0 || idx > qp - window)) {
          float dot = 0.f;
          for (int d = 0; d < Dh; ++d)
            dot += q_s[r * Dh + d] * k_s[t * (Dh + 1) + d];
          s = dot * (Q8 ? scale * ksc_s[t] : scale);
        }
      }
      p_s[i] = s;
    }
    __syncthreads();
    // online-softmax statistics: one warp per row
    for (int r = warp; r < R; r += NWARPS) {
      float mx = NEG_INF;
      for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, p_s[r * KT + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < KT; t += 32) {
        const float s = p_s[r * KT + t];
        const float p = s <= NEG_INF ? 0.f : expf(s - m_new);
        p_s[r * KT + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + sum_t p_t * (v scale) * v_t
    for (int i = tid; i < R * Dh; i += THREADS) {
      const int r = i / Dh, d = i - r * Dh;
      float a = acc_s[i] * a_s[r];
      for (int t = 0; t < nt; ++t) {
        float p = p_s[r * KT + t];
        if (Q8) p *= vsc_s[t];
        a += p * v_s[t * Dh + d];
      }
      acc_s[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < R * Dh; i += THREADS) {
    const int r = i / Dh, d = i - r * Dh;
    const int qi = r / G, g = r - qi * G;
    if (qi >= nq) continue;
    const float l = l_s[r];
    out[(((size_t)b * Sq + q0 + qi) * Hq + h * G + g) * Dh + d] =
        from_f<T>(acc_s[i] / (l == 0.f ? 1.f : l));
  }
}

template <typename T, bool Q8>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale, const void* page_table,
           const void* q_pos, const void* lengths, void* out, int B, int Sq,
           int Hq, int Hkv, int Dh, int ps, int mp, int window, void* stream) {
  using KV = typename std::conditional<Q8, int8_t, T>::type;
  const int G = Hq / Hkv;
  const int QT = G >= ROWS ? 1 : ROWS / G;
  const int R = QT * G;
  const size_t smem = KT * sizeof(size_t) +
                      sizeof(float) * (2 * KT + 2 * R * Dh + KT * (Dh + 1) +
                                       KT * Dh + R * KT + 3 * R) +
                      sizeof(int) * QT;
  auto kern = sel_attn_paged_kernel<T, Q8>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const dim3 grid((Sq + QT - 1) / QT, Hkv, B);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k_pool),
      static_cast<const KV*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(page_table),
      static_cast<const int*>(q_pos), static_cast<const int*>(lengths),
      static_cast<T*>(out), Sq, Hq, Hkv, Dh, ps, mp, window, QT,
      1.0f / sqrtf((float)Dh));
  return (int)cudaGetLastError();
}

}  // namespace

#define SEL_ATTN_ENTRY(NAME, T, Q8)                                           \
  extern "C" int NAME(const void* q, const void* k_pool, const void* v_pool,  \
                      const void* k_scale, const void* v_scale,               \
                      const void* page_table, const void* q_pos,              \
                      const void* lengths, void* out, int B, int Sq, int Hq,  \
                      int Hkv, int Dh, int ps, int mp, int window,            \
                      void* stream) {                                         \
    return launch<T, Q8>(q, k_pool, v_pool, k_scale, v_scale, page_table,     \
                         q_pos, lengths, out, B, Sq, Hq, Hkv, Dh, ps, mp,     \
                         window, stream);                                     \
  }

SEL_ATTN_ENTRY(sel_attn_paged_f32, float, false)
SEL_ATTN_ENTRY(sel_attn_paged_bf16, __nv_bfloat16, false)
SEL_ATTN_ENTRY(sel_attn_paged_q8_f32, float, true)
SEL_ATTN_ENTRY(sel_attn_paged_q8_bf16, __nv_bfloat16, true)
