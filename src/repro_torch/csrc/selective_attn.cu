// Selective-attention kernels (MPIC) for Hopper (sm_90a): the paged
// selective prefill, in two kernels chosen by dtype, and below them the
// dense selective attention over an explicit kv_pos.
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
// scale multiplies that key's probability in P.V (not in the normaliser).
// The output is rounded once.
//
// Layouts are the model's, read in place: q and out (B, Sq, Hq, Dh), pools
// (P, page_size, Hkv, Dh), page_table (B, mp), q_pos (B, Sq), lengths (B,),
// scales (P, Hkv).  The ragged edge of Sq is masked here; nothing is padded.
//
// What bounds it on an H100: at the served shapes (a few hundred selected
// queries against ~1.3k cached keys, Dh 128) the ~4 * Dh operations per kept
// (query, key) pair outweigh the bytes by far more than the card's
// ~295 FLOP/byte, so a kernel at its limit is bound by tensor-core
// operations.  The grid is under one wave there (4 query tiles x 32 heads),
// and the selected rows are sorted by position, so the time is the walk of
// the block whose rows sit last in the prompt: one warp's chain of dependent
// tensor-core products, shared-memory loads and exponents, step after step.
//
// bf16 q (every serving pass): `sel_attn_paged_mma_kernel`, both products
// on the tensor cores with `mma.sync.m16n8k16` (bf16 in, fp32 sums):
//   * a block of 8 warps holds 64 (query, head) rows r = qi * G + g of one kv
//     head, so each K/V step it loads serves the whole GQA group.  Four row
//     groups of 16 rows, each held by two warps that take alternate halves
//     of every 128-key step and merge their softmax sums at the end: the
//     longest walk is half as long, and each scheduler has two warps to
//     switch between.  q sits in registers as A fragments for the walk;
//   * each key row is fetched through its own page-table entry (any page
//     size) with 16-byte `cp.async` into a two-stage ring: step n+1 loads
//     while step n computes.  int8 pages land raw and are widened to bf16 in
//     shared memory (exact: |x| <= 128);
//   * the key loop runs from the window's first visible key to the last key
//     any row of the block can see, and a warp skips the products of keys
//     none of its rows sees;
//   * S = Q.K^T in fp32 (bf16 products are exact), scaled (times the page's
//     K scale on int8) and masked by position before the exponent; the
//     online softmax runs in registers in log2 units (exp2), reduced over
//     each row's quad.  The products are ordered so that none waits on the
//     one before it;
//   * P.V takes P from the accumulators of S without a trip through shared
//     memory.  P is split into two bf16 halves, hi = bf16(p) and
//     lo = bf16(p - hi), and both are multiplied by the same V fragments
//     (`ldmatrix.trans`): one bf16 rounding of P alone would break the
//     tolerance the kernel is held to (kernels/check.py) ~20x, the split
//     leaves at most 2^-18 p;
//   * shared-memory rows are padded by 16 bytes, so `ldmatrix` reads them
//     without bank conflicts.
// Head dims 64 and 128.  `wgmma` with TMA-fed tiles and warp specialisation
// are later work.
//
// fp32 q (the fp32 tests and small models): `sel_attn_paged_kernel`, the
// first port, in fp32 on the CUDA cores: one block per (sequence, kv head,
// 16 rows), each logit a serial dot product out of shared memory.
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

template <bool Q8>
int launch_f32(const void* q, const void* k_pool, const void* v_pool,
               const void* k_scale, const void* v_scale,
               const void* page_table, const void* q_pos, const void* lengths,
               void* out, int B, int Sq, int Hq, int Hkv, int Dh, int ps,
               int mp, int window, void* stream) {
  using KV = typename std::conditional<Q8, int8_t, float>::type;
  const int G = Hq / Hkv;
  const int QT = G >= ROWS ? 1 : ROWS / G;
  const int R = QT * G;
  const size_t smem = KT * sizeof(size_t) +
                      sizeof(float) * (2 * KT + 2 * R * Dh + KT * (Dh + 1) +
                                       KT * Dh + R * KT + 3 * R) +
                      sizeof(int) * QT;
  auto kern = sel_attn_paged_kernel<float, Q8>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const dim3 grid((Sq + QT - 1) / QT, Hkv, B);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const KV*>(k_pool),
      static_cast<const KV*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(page_table),
      static_cast<const int*>(q_pos), static_cast<const int*>(lengths),
      static_cast<float*>(out), Sq, Hq, Hkv, Dh, ps, mp, window, QT,
      1.0f / sqrtf((float)Dh));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel.

constexpr int MMA_ROWS = 64;          // (query, head) rows per block
constexpr int MMA_KT = 64;            // keys per warp per step
constexpr int MMA_KEYS = 2 * MMA_KT;  // keys per step: two key parts
constexpr int MMA_THREADS = 32 * 8;   // 4 row groups x 2 key parts
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled where `full` is false (nothing is
// read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo_col,
                                              __nv_bfloat16 hi_col) {
  __nv_bfloat162 v;
  v.x = lo_col;
  v.y = hi_col;
  return *reinterpret_cast<uint32_t*>(&v);
}

// p (fp32) -> hi = bf16(p), lo = bf16(p - hi), packed in pairs of columns
__device__ __forceinline__ void split2(float p0, float p1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16(p0), h1 = __float2bfloat16(p1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(__float2bfloat16(p0 - __bfloat162float(h0)),
                 __float2bfloat16(p1 - __bfloat162float(h1)));
}

template <int DH, bool Q8>
struct MmaSmem {
  static constexpr int SD = DH + 8;  // padded bf16 row: 16 bytes more
  using KV = typename std::conditional<Q8, int8_t, __nv_bfloat16>::type;
  // bytes of one pool row (K or V) as it lands from the pool
  static constexpr int LAND_ROW = Q8 ? DH : SD * 2;
  static constexpr int LAND = MMA_KEYS * LAND_ROW;  // one step's K (or V)
  static constexpr int Q_BYTES = MMA_ROWS * SD * 2;
  static constexpr int RING = 2 * 2 * LAND;  // 2 stages of K and V
  static constexpr int WIDE = Q8 ? 2 * MMA_KEYS * SD * 2 : 0;  // int8 -> bf16
  static constexpr int SCALES = Q8 ? 2 * 2 * MMA_KEYS * 4 : 0;
  static constexpr int BYTES = Q_BYTES + RING + WIDE + SCALES;
  // the end of the key loop reuses the ring to merge the key parts
  static_assert(RING >= 4 * 32 * (DH / 2 + 4) * (int)sizeof(float),
                "no room to merge the key parts");
};

// grid (ceil(Sq * G / MMA_ROWS), Hkv, B), block MMA_THREADS.  Block rows
// r = blockIdx.x * MMA_ROWS + i over the (query, head) rows of kv head h,
// r = qi * G + g.  Warp w holds row group rg = w % 4, block rows
// [16 rg, 16 rg + 16), over key part kp = w / 4: of each step's MMA_KEYS
// keys, the MMA_KT from kp * MMA_KT on.  The parts of a row group keep
// their own softmax sums and merge them after the key loop.  Within a
// warp, lane = 4 * gid + tig holds rows gid and gid + 8 and, of each
// 8-column fragment, columns 2 tig and 2 tig + 1 (the m16n8k16 accumulator
// layout).  Logits are kept in log2 units (times log2 e) for exp2.
template <int DH, bool Q8>
__global__ void __launch_bounds__(MMA_THREADS) sel_attn_paged_mma_kernel(
    const __nv_bfloat16* __restrict__ q,
    const typename MmaSmem<DH, Q8>::KV* __restrict__ k_pool,
    const typename MmaSmem<DH, Q8>::KV* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ page_table, const int* __restrict__ q_pos,
    const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out, int Sq,
    int Hq, int Hkv, int ps, int mp, int window, float scale) {
  using S = MmaSmem<DH, Q8>;
  using KV = typename S::KV;
  constexpr int SD = S::SD;
  constexpr int KSTEPS = DH / 16;  // k-steps of Q.K^T
  constexpr int DTILES = DH / 8;   // n-tiles of P.V
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int G = Hq / Hkv;
  const int rows = Sq * G;
  const int r0 = blockIdx.x * MMA_ROWS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp & 3, kp = warp >> 2;
  const int gid = lane >> 2, tig = lane & 3;
  const float scale2 = scale * LOG2E;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* ring = smem_raw + S::Q_BYTES;
  __nv_bfloat16* wide = reinterpret_cast<__nv_bfloat16*>(ring + S::RING);
  float* scales = reinterpret_cast<float*>(ring + S::RING + S::WIDE);
  __shared__ int range_s[2];

  // q rows -> shared (zeros past the last row), then A fragments
  constexpr int QCH = DH / 8;  // 16-byte chunks of a bf16 row
  for (int i = tid; i < MMA_ROWS * QCH; i += MMA_THREADS) {
    const int rr = i / QCH, c = i - rr * QCH;
    const int r = r0 + rr;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < rows) {
      const int qi = r / G, g = r - qi * G;
      v = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * Sq + qi) * Hq + h * G + g) * DH + c * 8);
    }
    *reinterpret_cast<uint4*>(q_s + rr * SD + c * 8) = v;
  }
  if (tid == 0) {
    range_s[0] = 0x7fffffff;
    range_s[1] = -1;
  }
  // this thread's two rows: query positions (-1: a row past the end, which
  // sees no key)
  int qp[2];
  int wmin = 0x7fffffff, wmax = -1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + rg * 16 + gid + 8 * i;
    qp[i] = r < rows ? q_pos[(size_t)b * Sq + r / G] : -1;
    if (qp[i] >= 0) {
      wmin = min(wmin, qp[i]);
      wmax = max(wmax, qp[i]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    wmin = min(wmin, __shfl_xor_sync(0xffffffffu, wmin, o));
    wmax = max(wmax, __shfl_xor_sync(0xffffffffu, wmax, o));
  }
  __syncthreads();
  if (lane == 0 && kp == 0 && wmax >= 0) {
    atomicMin(&range_s[0], wmin);
    atomicMax(&range_s[1], wmax);
  }
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    ldmatrix_x4(qf[kk],
                q_s + (rg * 16 + (lane & 15)) * SD + kk * 16 + (lane >> 4) * 8);
  __syncthreads();

  // keys the block reads: the window's first visible key up to the last
  // key a row can see, within the length and the page table's width
  const int length = lengths[b];
  const int lo = window > 0 ? max(0, range_s[0] - window + 1) : 0;
  const int hi = min(min(length, range_s[1] + 1), mp * ps);
  const int nsteps = hi > lo ? (hi - lo + MMA_KEYS - 1) / MMA_KEYS : 0;
  const int* pt = page_table + (size_t)b * mp;
  // the keys this warp's rows can see
  const int wlo = window > 0 ? wmin - window + 1 : 0;

  // step n -> ring stage n & 1: each key row through its own page
  auto load_step = [&](int n) {
    const int t0 = lo + n * MMA_KEYS;
    unsigned char* kd = ring + (n & 1) * 2 * S::LAND;
    unsigned char* vd = kd + S::LAND;
    constexpr int CH = DH * (int)sizeof(KV) / 16;  // 16-byte chunks a row
    for (int i = tid; i < MMA_KEYS * CH; i += MMA_THREADS) {
      const int t = i / CH, c = i - t * CH;
      const int idx = t0 + t;
      const bool in = idx < hi;
      size_t off = 0;
      if (in) {
        const int page = pt[idx / ps];
        off = (((size_t)page * ps + idx % ps) * Hkv + h) * DH;
      }
      cp_async16(kd + t * S::LAND_ROW + c * 16,
                 reinterpret_cast<const unsigned char*>(k_pool + off) + c * 16,
                 in);
      cp_async16(vd + t * S::LAND_ROW + c * 16,
                 reinterpret_cast<const unsigned char*>(v_pool + off) + c * 16,
                 in);
    }
    if (Q8 && tid < MMA_KEYS) {
      const int idx = t0 + tid;
      float ks = 0.f, vs = 0.f;
      if (idx < hi) {
        const size_t p = (size_t)pt[idx / ps] * Hkv + h;
        ks = k_scale[p];
        vs = v_scale[p];
      }
      scales[(n & 1) * 2 * MMA_KEYS + tid] = ks;
      scales[(n & 1) * 2 * MMA_KEYS + MMA_KEYS + tid] = vs;
    }
  };

  float o[DTILES][4];
#pragma unroll
  for (int j = 0; j < DTILES; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running max, log2 units
  float l[2] = {0.f, 0.f};          // this thread's part of each row's sum

  if (nsteps > 0) load_step(0);
  cp_async_commit();
  for (int n = 0; n < nsteps; ++n) {
    if (n + 1 < nsteps) load_step(n + 1);
    cp_async_commit();
    cp_async_wait<1>();  // step n has landed (this thread's copies)
    __syncthreads();     // ... and every thread's
    const __nv_bfloat16* k_t;
    const __nv_bfloat16* v_t;
    const float* ks_t = scales + (n & 1) * 2 * MMA_KEYS + kp * MMA_KT;
    const float* vs_t = ks_t + MMA_KEYS;
    if constexpr (Q8) {
      // widen the int8 step to bf16, exactly
      const int8_t* kr = reinterpret_cast<const int8_t*>(ring +
                                                         (n & 1) * 2 * S::LAND);
      constexpr int CH = DH / 16;
      for (int i = tid; i < 2 * MMA_KEYS * CH; i += MMA_THREADS) {
        const int t = i / CH, c = i - t * CH;  // t < 2 KEYS: K rows, then V
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + t * DH + c * 16);
        const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
        uint32_t y[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const uint32_t w = words[e >> 1];
          const int sh = 16 * (e & 1);  // byte 2e % 4 of w, and the next
          const int x0 = (int)(w << (24 - sh)) >> 24;
          const int x1 = (int)(w << (16 - sh)) >> 24;
          y[e] = pack_bf16(__float2bfloat16((float)x0),
                           __float2bfloat16((float)x1));
        }
        uint4* dst = reinterpret_cast<uint4*>(wide + t * SD + c * 16);
        dst[0] = make_uint4(y[0], y[1], y[2], y[3]);
        dst[1] = make_uint4(y[4], y[5], y[6], y[7]);
      }
      __syncthreads();
      k_t = wide + kp * MMA_KT * SD;
      v_t = wide + (MMA_KEYS + kp * MMA_KT) * SD;
    } else {
      const __nv_bfloat16* st = reinterpret_cast<const __nv_bfloat16*>(
          ring + (n & 1) * 2 * S::LAND);
      k_t = st + kp * MMA_KT * SD;
      v_t = st + (MMA_KEYS + kp * MMA_KT) * SD;
    }
    const int t0 = lo + n * MMA_KEYS + kp * MMA_KT;

    // does any row of this warp see a key of its part of the step?
    if (wmax >= 0 && t0 < hi && t0 <= wmax && t0 + MMA_KT - 1 >= wlo) {
      // S = Q.K^T: 8 fragments of 8 keys; all 8 K fragments of a k-step
      // pair are loaded first, so the 16 products that follow are
      // independent of each other and of the loads
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; kk += 2) {
        uint32_t kb[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          ldmatrix_x4(kb[j], k_t + (8 * j + (lane & 7)) * SD + kk * 16 +
                                 (lane >> 3) * 8);
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_bf16(s[j], qf[kk], kb[j][0], kb[j][1]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mma_bf16(s[j], qf[kk + 1], kb[j][2], kb[j][3]);
      }
      // scale, mask, online softmax (rows gid and gid + 8)
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * tig + (e & 1);
          const int idx = t0 + col;
          const int row = e >> 1;
          const bool ok = idx < hi && idx <= qp[row] &&
                          (window <= 0 || idx > qp[row] - window);
          const float sc = Q8 ? scale2 * ks_t[col] : scale2;
          s[j][e] = ok ? s[j][e] * sc : NEG_INF;
          mx[row] = fmaxf(mx[row], s[j][e]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e >> 1;
          const float p =
              s[j][e] <= NEG_INF ? 0.f : exp2f(s[j][e] - m[row]);
          l[row] += p;
          s[j][e] = Q8 ? p * vs_t[8 * j + 2 * tig + (e & 1)] : p;
        }
      }
#pragma unroll
      for (int j = 0; j < DTILES; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
      // O += P.V over 4 steps of 16 keys; P = hi + lo.  Four n-tiles at a
      // time: their hi products, then their lo products, so no product
      // waits on the one before it
#pragma unroll
      for (int ks = 0; ks < MMA_KT / 16; ++ks) {
        uint32_t ph[4], pl[4];
        split2(s[2 * ks][0], s[2 * ks][1], ph[0], pl[0]);
        split2(s[2 * ks][2], s[2 * ks][3], ph[1], pl[1]);
        split2(s[2 * ks + 1][0], s[2 * ks + 1][1], ph[2], pl[2]);
        split2(s[2 * ks + 1][2], s[2 * ks + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int dp = 0; dp < DTILES / 2; dp += 2) {
          uint32_t vb[2][4];
#pragma unroll
          for (int u = 0; u < 2; ++u)
            ldmatrix_x4_trans(vb[u], v_t + (16 * ks + (lane & 15)) * SD +
                                         16 * (dp + u) + (lane >> 4) * 8);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            mma_bf16(o[2 * (dp + u)], ph, vb[u][0], vb[u][1]);
            mma_bf16(o[2 * (dp + u) + 1], ph, vb[u][2], vb[u][3]);
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            mma_bf16(o[2 * (dp + u)], pl, vb[u][0], vb[u][1]);
            mma_bf16(o[2 * (dp + u) + 1], pl, vb[u][2], vb[u][3]);
          }
        }
      }
    }
    __syncthreads();  // the stage (and the widened step) may be overwritten
  }
  cp_async_wait<0>();

  // merge the key parts of each row group through the ring, lane by lane
  // (the parts' fragments have one layout): part 1 writes m, l and O, part
  // 0 rescales both to the larger max and adds
  constexpr int NV = DTILES * 4 + 4;
  float* xch = reinterpret_cast<float*>(ring) + rg * NV * 32 + lane;
  __syncthreads();
  if (kp == 1) {
#pragma unroll
    for (int j = 0; j < DTILES; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) xch[(4 * j + e) * 32] = o[j][e];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      xch[(DTILES * 4 + i) * 32] = m[i];
      xch[(DTILES * 4 + 2 + i) * 32] = l[i];
    }
  }
  __syncthreads();
  if (kp == 1) return;
  float ca[2], cb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float mb = xch[(DTILES * 4 + i) * 32];
    const float m_new = fmaxf(m[i], mb);
    ca[i] = exp2f(m[i] - m_new);
    cb[i] = exp2f(mb - m_new);
    l[i] = ca[i] * l[i] + cb[i] * xch[(DTILES * 4 + 2 + i) * 32];
  }
#pragma unroll
  for (int j = 0; j < DTILES; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[j][e] = ca[e >> 1] * o[j][e] + cb[e >> 1] * xch[(4 * j + e) * 32];

  // out = O / l, rounded once; a row with no kept key has l == 0: zeros
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = r0 + rg * 16 + gid + 8 * i;
    if (r >= rows) continue;
    const int qi = r / G, g = r - qi * G;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    __nv_bfloat16* dst =
        out + (((size_t)b * Sq + qi) * Hq + h * G + g) * DH + 2 * tig;
#pragma unroll
    for (int j = 0; j < DTILES; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
  }
}

constexpr int MAX_DEVICES = 64;

// Lets the instantiation ask for its dynamic shared memory.  The attribute
// belongs to the current device, so it is set once per device, not per
// launch.
template <int DH, bool Q8>
int allow_mma_smem() {
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < MAX_DEVICES && done[dev]) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      sel_attn_paged_mma_kernel<DH, Q8>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, MmaSmem<DH, Q8>::BYTES);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return (int)err;
}

template <int DH, bool Q8>
int launch_mma(const void* q, const void* k_pool, const void* v_pool,
               const void* k_scale, const void* v_scale,
               const void* page_table, const void* q_pos, const void* lengths,
               void* out, int B, int Sq, int Hq, int Hkv, int ps, int mp,
               int window, void* stream) {
  using S = MmaSmem<DH, Q8>;
  auto kern = sel_attn_paged_mma_kernel<DH, Q8>;
  if (const int err = allow_mma_smem<DH, Q8>()) return err;
  const int rows = Sq * (Hq / Hkv);
  const dim3 grid((rows + MMA_ROWS - 1) / MMA_ROWS, Hkv, B);
  kern<<<grid, MMA_THREADS, S::BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const typename S::KV*>(k_pool),
      static_cast<const typename S::KV*>(v_pool),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(page_table), static_cast<const int*>(q_pos),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out), Sq,
      Hq, Hkv, ps, mp, window, 1.0f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

// fp32 q: the CUDA-core kernel, any head dim; bf16 q: the tensor-core
// kernel, head dim 64 or 128 (the wrapper refuses others)
template <typename T, bool Q8>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale, const void* page_table,
           const void* q_pos, const void* lengths, void* out, int B, int Sq,
           int Hq, int Hkv, int Dh, int ps, int mp, int window, void* stream) {
  if constexpr (std::is_same<T, float>::value) {
    return launch_f32<Q8>(q, k_pool, v_pool, k_scale, v_scale, page_table,
                          q_pos, lengths, out, B, Sq, Hq, Hkv, Dh, ps, mp,
                          window, stream);
  } else {
    switch (Dh) {
      case 64:
        return launch_mma<64, Q8>(q, k_pool, v_pool, k_scale, v_scale,
                                  page_table, q_pos, lengths, out, B, Sq, Hq,
                                  Hkv, ps, mp, window, stream);
      case 128:
        return launch_mma<128, Q8>(q, k_pool, v_pool, k_scale, v_scale,
                                   page_table, q_pos, lengths, out, B, Sq, Hq,
                                   Hkv, ps, mp, window, stream);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
}

// What the card says of the bf16 tensor-core instantiation for head dim
// `dh` (64 or 128): registers per thread, local memory per thread in bytes
// (spills and stack; 0 when nothing spills), static and dynamic shared
// memory per block in bytes, resident blocks per SM, threads per block.
template <int DH, bool Q8>
int mma_info(int* info) {
  auto kern = sel_attn_paged_mma_kernel<DH, Q8>;
  const int smem = MmaSmem<DH, Q8>::BYTES;
  if (const int err = allow_mma_smem<DH, Q8>()) return err;
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, kern);
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, MMA_THREADS,
                                                smem);
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)attr.sharedSizeBytes;
  info[3] = smem;
  info[4] = blocks;
  info[5] = MMA_THREADS;
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

extern "C" int sel_attn_paged_mma_info(int dh, int q8, int* info) {
  if (dh == 64) return q8 ? mma_info<64, true>(info) : mma_info<64, false>(info);
  if (dh == 128)
    return q8 ? mma_info<128, true>(info) : mma_info<128, false>(info);
  return (int)cudaErrorInvalidValue;
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
