// Selective-attention kernels (MPIC) for Hopper (sm_90a): the paged
// selective prefill, one kernel for both pool types, and below it the dense
// selective attention over an explicit kv_pos.
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

// ---------------------------------------------------------------------------
// Dense selective attention over an explicit kv_pos.
//
// Replaces the Pallas TPU kernel `_sel_attn_kernel` of
// src/repro/kernels/selective_attn/selective_attn.py: every dense attention
// pass of the serving path (the baselines' prefills, dense mpic/cacheblend,
// the media upload and the dense-cache decode step).  Queries sit at
// positions `q_pos`; key slot `i` holds the token at position `kv_pos[i]`,
// in any order, with INVALID_POS (int32 max) for an empty slot.  A key is
// kept iff `kv_pos != INVALID_POS && kv_pos <= q_pos` and, with a window,
// `kv_pos > q_pos - window`.  An online softmax over the kept keys, summed
// in fp32 and rounded once; a row with no kept key gives zeros.
//
// Layouts are the model's, read in place: q and out (B, Sq, Hq, Dh), k and v
// (B, Skv, Hkv, Dh), q_pos (B, Sq), kv_pos (B, Skv).  Both ragged edges (Sq
// and Skv) are masked here; nothing is padded.
//
// What bounds it on an H100: at the prefill shapes (hundreds to ~1.3k
// queries against a 2048-slot cache, Dh 128) the ~4 * Dh FLOPs per kept
// (query, key) pair outweigh the bytes, so a kernel at its limit would be
// bound by tensor-core operations; the decode step (one query per sequence)
// is bound by the bytes of the kept keys.  This kernel does its math in fp32
// on the CUDA cores.  What the design does:
//   * one block per (sequence, kv head, tile of queries) holds up to 16
//     (query, head) rows of one GQA group, so each K/V tile it loads serves
//     the whole group;
//   * a K/V tile is loaded only if one of its keys is visible to one of the
//     block's rows, judged from each key's own kv_pos (no order is assumed:
//     the loop visits every tile and skips the ones with no visible key);
//   * a logit is computed by a whole warp: each lane holds Dh/32 of the
//     row's q in registers and forms partial dots with 32 keys, and a
//     transposing butterfly (31 shuffles for 32 sums) leaves lane t with the
//     logit of key t, so the softmax statistics are warp reductions;
//   * P.V reads each V row once per warp from shared memory as a vector and
//     updates every row the warp owns.
// Moving both products onto `mma.sync` / `wgmma` tensor-core tiles is later
// work.

namespace {

constexpr int DENSE_ROWS = 16;                // (query, head) rows per block
constexpr int ROWS_PER_WARP = DENSE_ROWS / NWARPS;
constexpr int INVALID_POS = 0x7fffffff;

template <int OFF>
__device__ __forceinline__ void butterfly_step(float (&v)[32], int lane) {
  const bool upper = lane & OFF;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = upper ? v[i] : v[i + OFF];
    const float keep = upper ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// v[t] on every lane -> the sum over the warp of v[lane], on lane `lane`.
__device__ __forceinline__ float transpose_sum(float (&v)[32], int lane) {
  butterfly_step<16>(v, lane);
  butterfly_step<8>(v, lane);
  butterfly_step<4>(v, lane);
  butterfly_step<2>(v, lane);
  butterfly_step<1>(v, lane);
  return v[0];
}

template <typename T>
struct Vec16;  // 16 bytes of T
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void to_f(const void* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void to_f(const void* p, float* out) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x, out[2 * i + 1] = f.y;
    }
  }
};

// DPL consecutive floats of shared memory (16-byte aligned when DPL >= 4).
template <int DPL>
__device__ __forceinline__ void load_row(const float* p, float (&x)[DPL]) {
  if constexpr (DPL % 4 == 0) {
#pragma unroll
    for (int j = 0; j < DPL; j += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + j);
      x[j] = f.x, x[j + 1] = f.y, x[j + 2] = f.z, x[j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < DPL; ++j) x[j] = p[j];
  }
}

// grid (ceil(Sq / QT), Hkv * (G / GB), B), block THREADS.  The block's rows
// r = qi * GB + g: query qi of the tile, head g of its GB-head part of the
// group; warp w owns rows [w * ROWS_PER_WARP, (w + 1) * ROWS_PER_WARP).
// Lane l holds elements [l * DPL, (l + 1) * DPL) of each row.  Shared: the
// K and V tiles (KT x Dh fp32 each), the tile's kv positions and
// visibility, the probabilities (DENSE_ROWS x KT).
template <typename T, int DPL>
__global__ void __launch_bounds__(THREADS) sel_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
    T* __restrict__ out, int Sq, int Skv, int Hq, int Hkv, int window, int QT,
    int GB, float scale) {
  constexpr int Dh = DPL * 32;
  constexpr int VN = Vec16<T>::N;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int parts = G / GB;
  const int h = blockIdx.y / parts;                  // kv head
  const int head0 = h * G + (blockIdx.y % parts) * GB;
  const int q0 = blockIdx.x * QT;
  const int nq = min(QT, Sq - q0);
  const int R = QT * GB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);
  float* v_s = k_s + KT * Dh;
  float* p_s = v_s + KT * Dh;
  int* kp_s = reinterpret_cast<int*>(p_s + DENSE_ROWS * KT);
  __shared__ int qrange_s[2];

  // this warp's rows: query position, q slice, running m / l / acc
  int qp[ROWS_PER_WARP];
  bool live[ROWS_PER_WARP];
  float qv[ROWS_PER_WARP][DPL];
  float acc[ROWS_PER_WARP][DPL];
  float m[ROWS_PER_WARP], l[ROWS_PER_WARP];
  int qmin = 0x7fffffff, qmax = -0x7fffffff - 1;
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = warp * ROWS_PER_WARP + i;
    const int qi = r / GB, g = r - qi * GB;
    live[i] = r < R && qi < nq;
    qp[i] = live[i] ? q_pos[(size_t)b * Sq + q0 + qi] : 0;
    const size_t base =
        (((size_t)b * Sq + q0 + qi) * Hq + head0 + g) * Dh + lane * DPL;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      qv[i][j] = live[i] ? to_f(q[base + j]) : 0.f;
      acc[i][j] = 0.f;
    }
    m[i] = NEG_INF;
    l[i] = 0.f;
    if (live[i]) {
      qmin = min(qmin, qp[i]);
      qmax = max(qmax, qp[i]);
    }
  }
  if (tid == 0) {
    qrange_s[0] = 0x7fffffff;
    qrange_s[1] = -0x7fffffff - 1;
  }
  __syncthreads();
  if (lane == 0) {
    atomicMin(&qrange_s[0], qmin);
    atomicMax(&qrange_s[1], qmax);
  }
  __syncthreads();
  const int bq_min = qrange_s[0], bq_max = qrange_s[1];
  const int* kvp = kv_pos + (size_t)b * Skv;

  for (int t0 = 0; t0 < Skv; t0 += KT) {
    const int nt = min(KT, Skv - t0);
    // positions of the tile's keys; does any block row see any of them?
    int vis = 0;
    if (tid < KT) {
      const int p = tid < nt ? kvp[t0 + tid] : INVALID_POS;
      kp_s[tid] = p;
      vis = p != INVALID_POS && p <= bq_max &&
            (window <= 0 || p > bq_min - window);
    }
    if (!__syncthreads_or(vis)) continue;
    for (int i = tid; i < nt * (Dh / VN); i += THREADS) {
      const int t = i / (Dh / VN), c = i - t * (Dh / VN);
      const size_t g = (((size_t)b * Skv + t0 + t) * Hkv + h) * Dh + c * VN;
      Vec16<T>::to_f(k + g, k_s + t * Dh + c * VN);
      Vec16<T>::to_f(v + g, v_s + t * Dh + c * VN);
    }
    __syncthreads();
    // rows are live in order, so live[0] says whether the warp has any
    if (live[0]) {
      // partial dots of every row with all 32 keys: each K row is read
      // from shared memory once per warp
      float dots[ROWS_PER_WARP][32];
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        float kr[DPL];
        load_row<DPL>(k_s + t * Dh + lane * DPL, kr);
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < DPL; ++j) s += qv[i][j] * kr[j];
          dots[i][t] = s;
        }
      }
      const int kp = kp_s[lane];
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) {
        if (!live[i]) continue;                      // warp-uniform
        const float dot = transpose_sum(dots[i], lane);  // key `lane`
        const bool ok = lane < nt && kp != INVALID_POS && kp <= qp[i] &&
                        (window <= 0 || kp > qp[i] - window);
        const float s = ok ? dot * scale : NEG_INF;
        const float m_new = fmaxf(m[i], warp_max(s));
        const float p = ok ? expf(s - m_new) : 0.f;
        const float alpha = expf(m[i] - m_new);
        l[i] = alpha * l[i] + warp_sum(p);
        m[i] = m_new;
        p_s[(warp * ROWS_PER_WARP + i) * KT + lane] = p;
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[i][j] *= alpha;
      }
      __syncwarp();
      for (int t = 0; t < nt; ++t) {
        float vv[DPL];
        load_row<DPL>(v_s + t * Dh + lane * DPL, vv);
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
          const float p = p_s[(warp * ROWS_PER_WARP + i) * KT + t];
#pragma unroll
          for (int j = 0; j < DPL; ++j) acc[i][j] += p * vv[j];
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    if (!live[i]) continue;
    const int r = warp * ROWS_PER_WARP + i;
    const int qi = r / GB, g = r - qi * GB;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    const size_t base =
        (((size_t)b * Sq + q0 + qi) * Hq + head0 + g) * Dh + lane * DPL;
#pragma unroll
    for (int j = 0; j < DPL; ++j) out[base + j] = from_f<T>(acc[i][j] * inv);
  }
}

template <typename T, int DPL>
int launch_dense(const void* q, const void* k, const void* v,
                 const void* q_pos, const void* kv_pos, void* out, int B,
                 int Sq, int Skv, int Hq, int Hkv, int window, void* stream) {
  const int G = Hq / Hkv;
  int GB = G < DENSE_ROWS ? G : DENSE_ROWS;   // heads of the group per block
  while (G % GB) --GB;
  const int QT = DENSE_ROWS / GB;
  const size_t smem = sizeof(float) * (2 * KT * DPL * 32 + DENSE_ROWS * KT) +
                      sizeof(int) * KT;
  auto kern = sel_attn_kernel<T, DPL>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const dim3 grid((Sq + QT - 1) / QT, Hkv * (G / GB), B);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<T*>(out), Sq, Skv, Hq, Hkv,
      window, QT, GB, 1.0f / sqrtf((float)(DPL * 32)));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dense(const void* q, const void* k, const void* v,
                   const void* q_pos, const void* kv_pos, void* out, int B,
                   int Sq, int Skv, int Hq, int Hkv, int Dh, int window,
                   void* stream) {
  switch (Dh) {
    case 32:
      return launch_dense<T, 1>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, Hq,
                                Hkv, window, stream);
    case 64:
      return launch_dense<T, 2>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, Hq,
                                Hkv, window, stream);
    case 128:
      return launch_dense<T, 4>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, Hq,
                                Hkv, window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

#define SEL_ATTN_DENSE_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const void* q, const void* k, const void* v,           \
                      const void* q_pos, const void* kv_pos, void* out,      \
                      int B, int Sq, int Skv, int Hq, int Hkv, int Dh,       \
                      int window, void* stream) {                            \
    return dispatch_dense<T>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, Hq,    \
                             Hkv, Dh, window, stream);                       \
  }

SEL_ATTN_DENSE_ENTRY(sel_attn_f32, float)
SEL_ATTN_DENSE_ENTRY(sel_attn_bf16, __nv_bfloat16)
