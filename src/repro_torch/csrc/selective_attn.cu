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

#include "split_kv.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int KT = 32;    // keys per tile of the page loop
constexpr int ROWS = 16;  // (query, head) rows per block, at least `group`

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

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

// 2^x on the special-function unit, denormal results flushed to 0 (a
// probability below 2^-126 is far under any output's rounding); exp2f
// without fast math adds a denormal fix-up around the same instruction,
// which timed measurably slower in the tensor-core kernels on the card
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

// The block's ROWS (query, head) rows r = r0 .. r0 + ROWS - 1 of kv head h,
// r = qi * G + g over q (B, Sq, Hq, DH), into q_s (rows padded to DH + 8;
// zeros past the last row), and this thread's two rows (gid and gid + 8 of
// its warp's row group, warp % (ROWS / 16)): their query positions qp (-1
// for a row past the end, which sees no key) and the range [wmin, wmax] of
// the warp's valid rows (wmax = -1 when it has none).
template <int DH, int ROWS>
__device__ __forceinline__ void stage_rows(const __nv_bfloat16* __restrict__ q,
                                           const int* __restrict__ q_pos,
                                           __nv_bfloat16* q_s, int b, int Sq,
                                           int Hq, int h, int G, int r0,
                                           int rows, int (&qp)[2], int& wmin,
                                           int& wmax) {
  constexpr int SD = DH + 8;
  constexpr int QCH = DH / 8;  // 16-byte chunks of a bf16 row
  const int tid = threadIdx.x, lane = tid & 31;
  const int rg = (tid >> 5) % (ROWS / 16);
  for (int i = tid; i < ROWS * QCH; i += MMA_THREADS) {
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
  wmin = 0x7fffffff;
  wmax = -1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + rg * 16 + (lane >> 2) + 8 * i;
    qp[i] = r < rows ? q_pos[(size_t)b * Sq + r / G] : -1;
    if (qp[i] >= 0) {
      wmin = min(wmin, qp[i]);
      wmax = max(wmax, qp[i]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    wmin = min(wmin, __shfl_xor_sync(FULL, wmin, o));
    wmax = max(wmax, __shfl_xor_sync(FULL, wmax, o));
  }
}

// One warp's part of a key step on the tensor cores: MMA_KT keys, rows
// k_t[col] and v_t[col] of DH + 8 bf16; q_frag(kk, a) gives the A fragment
// of k-step kk.  S = Q.K^T in fp32; a logit is
// kept where keep(col, row) holds (row 0: the thread's row gid, 1: gid + 8)
// and multiplied by k_mul(col) (the softmax scale in log2 units, times the
// K scale on the int8 pool), else NEG_INF; the online softmax updates m
// (running max, log2 units) and l (this thread's part of each row's sum);
// the probabilities, times v_mul(col) (the V scale, or 1), split into
// hi = bf16(p) and lo = bf16(p - hi), are multiplied by the same V
// fragments (ldmatrix.trans) into o.
template <int DH, typename QFrag, typename Keep, typename KMul, typename VMul>
__device__ __forceinline__ void mma_key_step(
    const QFrag& q_frag, const __nv_bfloat16* k_t,
    const __nv_bfloat16* v_t, int lane, const Keep& keep, const KMul& k_mul,
    const VMul& v_mul, float (&o)[DH / 8][4], float (&m)[2], float (&l)[2]) {
  constexpr int SD = DH + 8;
  constexpr int KSTEPS = DH / 16;  // k-steps of Q.K^T
  constexpr int DTILES = DH / 8;   // n-tiles of P.V
  const int tig = lane & 3;
  // S = Q.K^T: 8 fragments of 8 keys; all 8 K fragments of a k-step pair
  // are loaded first, so the 16 products that follow are independent of
  // each other and of the loads
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; kk += 2) {
    uint32_t kb[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      ldmatrix_x4(kb[j],
                  k_t + (8 * j + (lane & 7)) * SD + kk * 16 + (lane >> 3) * 8);
    uint32_t a0[4], a1[4];
    q_frag(kk, a0);
    q_frag(kk + 1, a1);
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_bf16(s[j], a0, kb[j][0], kb[j][1]);
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_bf16(s[j], a1, kb[j][2], kb[j][3]);
  }
  // scale, mask, online softmax (rows gid and gid + 8)
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * tig + (e & 1);
      const int row = e >> 1;
      s[j][e] = keep(col, row) ? s[j][e] * k_mul(col) : NEG_INF;
      mx[row] = fmaxf(mx[row], s[j][e]);
    }
  }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
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
      const float p = s[j][e] <= NEG_INF ? 0.f : fast_exp2(s[j][e] - m[row]);
      l[row] += p;
      s[j][e] = p * v_mul(8 * j + 2 * tig + (e & 1));
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
  // time: their hi products, then their lo products, so no product waits
  // on the one before it
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

// After the key loop (every thread, no copy in flight), with the block's
// 8 warps as 8 / KP row groups (warp % (8 / KP)) of KP key parts: merge
// the two key parts of each row group through `xch` when KP is 2 (the
// ring, lane by lane: the parts' fragments have one layout; part 1 writes
// m, l and O, part 0 rescales both to the larger max and adds), then part
// 0 writes out = O / l, rounded once, for its rows r = r0 + 16 rg + gid
// (+ 8) below `rows` (out (B, Sq, Hq, DH), r = qi * G + g); a row with no
// kept key has l == 0: zeros.
template <int DH, int KP>
__device__ __forceinline__ void merge_parts_store(
    unsigned char* xch_raw, float (&o)[DH / 8][4], float (&m)[2],
    float (&l)[2], __nv_bfloat16* __restrict__ out, int b, int Sq, int Hq,
    int h, int G, int r0, int rows) {
  static_assert(KP == 1 || KP == 2, "one or two key parts");
  constexpr int DTILES = DH / 8;
  constexpr int NV = DTILES * 4 + 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp % (8 / KP), kp = warp / (8 / KP);
  const int gid = lane >> 2, tig = lane & 3;
  if constexpr (KP == 2) {
    float* xch = reinterpret_cast<float*>(xch_raw) + rg * NV * 32 + lane;
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
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
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
  constexpr int DTILES = DH / 8;   // n-tiles of P.V
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int G = Hq / Hkv;
  const int rows = Sq * G;
  const int r0 = blockIdx.x * MMA_ROWS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp & 3, kp = warp >> 2;
  const float scale2 = scale * LOG2E;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* ring = smem_raw + S::Q_BYTES;
  __nv_bfloat16* wide = reinterpret_cast<__nv_bfloat16*>(ring + S::RING);
  float* scales = reinterpret_cast<float*>(ring + S::RING + S::WIDE);
  __shared__ int range_s[2];

  int qp[2], wmin, wmax;
  stage_rows<DH, MMA_ROWS>(q, q_pos, q_s, b, Sq, Hq, h, G, r0, rows, qp, wmin,
                           wmax);
  if (tid == 0) {
    range_s[0] = 0x7fffffff;
    range_s[1] = -1;
  }
  __syncthreads();
  if (lane == 0 && kp == 0 && wmax >= 0) {
    atomicMin(&range_s[0], wmin);
    atomicMax(&range_s[1], wmax);
  }
  // q's A fragments, held in registers for the walk
  uint32_t qf[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
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
      const auto keep = [&](int col, int row) {
        const int idx = t0 + col;
        return idx < hi && idx <= qp[row] &&
               (window <= 0 || idx > qp[row] - window);
      };
      const auto k_mul = [&](int col) {
        return Q8 ? scale2 * ks_t[col] : scale2;
      };
      const auto v_mul = [&](int col) { return Q8 ? vs_t[col] : 1.f; };
      const auto q_frag = [&](int kk, uint32_t(&a)[4]) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      };
      mma_key_step<DH>(q_frag, k_t, v_t, lane, keep, k_mul, v_mul, o, m, l);
    }
    __syncthreads();  // the stage (and the widened step) may be overwritten
  }
  cp_async_wait<0>();
  merge_parts_store<DH, 2>(ring, o, m, l, out, b, Sq, Hq, h, G, r0, rows);
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
// Dense selective attention over an explicit kv_pos: three routes behind
// four C entries, chosen by the Python wrapper from host shapes alone
// (kernels/selective_attn/ops.py, `dense_route`).
//
// Replaces the Pallas TPU kernel `_sel_attn_kernel` of
// src/repro/kernels/selective_attn/selective_attn.py: every dense attention
// pass of the serving path (the media upload, the baselines' prefills,
// dense mpic/cacheblend and the dense-cache decode step).  Queries sit at
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
// What bounds it on an H100.  A kept (query, key) pair costs 4 Dh FLOPs
// (its logit and its share of P.V).  At the prefill shapes (an upload: 576
// queries over their own keys, causal; a full recompute: ~1.3k queries
// against a 2048-slot cache; dense mpic: ~200 selected queries) each K/V
// row that is loaded serves hundreds of queries, far above the card's ~295
// FLOP per byte: operations bound it, and only the tensor cores reach
// them.  The decode step (one query per sequence, ~1.3k kept keys each)
// does G FLOPs per byte of bf16 K/V (1 for MHA): bytes bound it, and the
// design's task is to keep enough of them moving.
//
// 1. bf16, many rows (`sel_attn_mma_kernel`, entry sel_attn_mma_bf16): the
//    paged prefill's tensor-core design, through the same helpers
//    (stage_rows, mma_key_step, merge_parts_store): S = Q.K^T and
//    O += P.V on `mma.sync.m16n8k16` with fp32 sums and P split into two
//    bf16 halves; 16-byte `cp.async` into a two-stage ring, rows padded by
//    16 bytes for `ldmatrix`.  What differs:
//    * 128 (query, head) rows of one kv head a block, 8 warps of 16 rows,
//      each over all 64 keys of a step, when that fills every SM at least
//      once (the uploads, a full recompute): a K/V byte copied into shared
//      memory serves twice the rows of the paged kernel's 64-row blocks,
//      which timed slower there.  Below a wave (dense mpic's ~200 rows)
//      the longest walk sets the time, and the paged kernel's layout (64
//      rows, two warps a row group over the two halves of a 128-key step,
//      merged at the end) timed faster: the launcher picks the layout from
//      the grid and the card's SM count;
//    * q stays in shared memory and its fragments are reloaded every
//      step: 32 registers a thread fewer, and faster on the card;
//    * the grid puts kv heads first and the row tiles in reverse, so the
//      tiles at the latest positions (with sorted queries, the ones that
//      see the most keys) start first, which shortens the last wave at
//      the causal shapes;
//    * slot t of sequence b is row (b Skv + t) Hkv + h, and the mask comes
//      from each key's own kv_pos, copied into shared memory beside its
//      step.  The slot order proves nothing, so the paged kernel's [first,
//      last visible key] range does not carry over; instead the block
//      first judges every 64-slot step by its kv positions and leaves out
//      a step with no key that a row of the block may see (no valid
//      position in (min q_pos - window, max q_pos]), then walks the others
//      in order with the next one's copies in flight.  A cache filled in
//      slot order (an upload, a full recompute) so skips the causal upper
//      triangle and the empty tail; any other order stays correct.  A warp
//      skips the products of a step that none of its rows sees.
//    At the served shapes the walk is bound by latency at one block (8
//    warps, 173 registers a thread) per SM, not by the tensor cores' rate.
//    Head dims 64 and 128.
// 2. bf16, few rows per (sequence, kv head) (`sel_attn_split_kernel` and
//    split_kv.cuh's merge kernel, entry sel_attn_split_bf16; the decode
//    step): the paged decode's split-key design.  Slots are cut into
//    chunks of CHUNK; n_splits = ceil(Skv / CHUNK) comes from the host's
//    shapes (a window bounds positions, not slots, so it narrows nothing).
//    A block of 4 warps takes one chunk for up to SPLIT_WIDE rows.  It
//    packs the chunk's slots that one of its rows may see, in slot order
//    (ballots over their kv_pos), so an empty slot costs neither bytes nor
//    work and a chunk with none writes an empty partial without touching
//    K/V (through the same end as the others: an early exit there made
//    ptxas spill); then each lane loads 16 bytes of a K and a V row at a
//    time and keeps the next stage in flight in registers, as
//    paged_attn.cu does.  One fp32 partial per (row, split) goes to a
//    workspace the wrapper allocates; the merge kernel rescales, divides
//    and rounds once.  Head dims 64 and 128.
// 3. fp32, or bf16 at another head dim (`sel_attn_kernel`, entries
//    sel_attn_f32 / sel_attn_bf16): the first port, on the CUDA cores:
//    * one block per (sequence, kv head, tile of queries) holds up to 16
//      (query, head) rows of one GQA group, so each K/V tile it loads
//      serves the whole group;
//    * a K/V tile is loaded only if one of its keys is visible to one of
//      the block's rows, judged from each key's own kv_pos;
//    * a logit is computed by a whole warp: each lane holds Dh/32 of the
//      row's q in registers and forms partial dots with 32 keys, and a
//      transposing butterfly (31 shuffles for 32 sums) leaves lane t with
//      the logit of key t, so the softmax statistics are warp reductions;
//    * P.V reads each V row once per warp from shared memory as a vector
//      and updates every row the warp owns.
//
// All four entries share one signature (the workspace and n_splits serve
// the split route only), and the wrapper counts each call as one launch of
// `sel_attn`, whichever route ran.

namespace {

constexpr int DENSE_ROWS = 16;                // (query, head) rows per block
constexpr int ROWS_PER_WARP = DENSE_ROWS / NWARPS;
constexpr int INVALID_POS = 0x7fffffff;
constexpr int SPLIT_STEPS = 2;  // warp steps per stage of the register ring
constexpr int SPLIT_WIDE = 4;   // rows a split block takes, beyond one

// Is a key at position p kept by a row at position qp?
__device__ __forceinline__ bool kept(int p, int qp, int window) {
  return p != INVALID_POS && p <= qp && (window <= 0 || p > qp - window);
}
// May a key at position p be kept by a row at a position in [qmin, qmax]?
// (Nothing when qmax < 0: no row.)
__device__ __forceinline__ bool maybe_kept(int p, int qmin, int qmax,
                                           int window) {
  return p != INVALID_POS && p <= qmax && (window <= 0 || p > qmin - window);
}

// 4 bytes global -> shared, asynchronously (cp.async.ca)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// -- route 1: tensor cores ---------------------------------------------------

// A block of the tensor-core route: 8 warps as RG row groups of 16
// (query, head) rows times KP = 8 / RG key parts of MMA_KT keys.  RG 8
// (128 rows, every warp over all 64 keys of a step) copies each K/V byte
// into shared memory for twice the rows of RG 4 (64 rows, two key halves
// of a 128-key step merged at the end, the paged kernel's layout), but
// makes half the blocks, each walking twice as many steps.
template <int DH, int RG>
struct DenseMma {
  static constexpr int KP = 8 / RG;
  static constexpr int ROWS = 16 * RG;
  static constexpr int KEYS = MMA_KT * KP;
  static constexpr int SD = DH + 8;              // padded bf16 row
  static constexpr int TILE = KEYS * SD * 2;     // one step's K (or V)
  static constexpr int RING = 2 * 2 * TILE;      // 2 stages of K and V
  static constexpr int POS = 2 * KEYS * 4;       // the stages' kv_pos
  static constexpr int Q_BYTES = ROWS * SD * 2;  // q, kept for the walk
  // fixed bytes; the list of steps to walk takes 4 more per step of Skv
  static constexpr int BYTES = RING + POS + Q_BYTES;
  static_assert(KP == 1 || RING >= 4 * 32 * (DH / 2 + 4) * (int)sizeof(float),
                "no room to merge the key parts");
  static int bytes(int skv) { return BYTES + 4 * ((skv + KEYS - 1) / KEYS); }
};

// grid (Hkv, ceil(Sq * G / ROWS), B), block MMA_THREADS: tile y takes the
// rows from (gridDim.y - 1 - y) ROWS on, so the blocks that start first
// hold the rows at the latest positions (with sorted queries, as every
// dense pass has them, the ones that see the most keys: the longest walks
// start first).  Warp w holds rows
// [16 (w % RG), 16 (w % RG) + 16) of the block over key part w / RG;
// fragments as in sel_attn_paged_mma_kernel.  Step n covers slots
// [KEYS st, KEYS st + KEYS) of the n-th step st that holds a key some row
// of the block may see.
template <int DH, int RG>
__global__ void __launch_bounds__(MMA_THREADS) sel_attn_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ kv_pos, __nv_bfloat16* __restrict__ out, int Sq,
    int Skv, int Hq, int Hkv, int window, float scale) {
  using S = DenseMma<DH, RG>;
  constexpr int SD = S::SD, KEYS = S::KEYS, ROWS = S::ROWS;
  constexpr int DTILES = DH / 8;
  const int b = blockIdx.z;
  const int h = blockIdx.x;
  const int G = Hq / Hkv;
  const int rows = Sq * G;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * ROWS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp % RG, kp = warp / RG;
  const float scale2 = scale * LOG2E;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw;
  int* pos_s = reinterpret_cast<int*>(smem_raw + S::RING);  // 2 stages
  __nv_bfloat16* q_s =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + S::RING + S::POS);
  // the steps to walk, in order
  int* steps_s = reinterpret_cast<int*>(smem_raw + S::RING + S::POS +
                                        S::Q_BYTES);
  __shared__ int range_s[2];
  __shared__ int nsteps_s;

  int qp[2], wmin, wmax;
  stage_rows<DH, ROWS>(q, q_pos, q_s, b, Sq, Hq, h, G, r0, rows, qp, wmin,
                       wmax);
  if (tid == 0) {
    range_s[0] = 0x7fffffff;
    range_s[1] = -1;
  }
  __syncthreads();
  if (lane == 0 && kp == 0 && wmax >= 0) {
    atomicMin(&range_s[0], wmin);
    atomicMax(&range_s[1], wmax);
  }
  __syncthreads();
  const int bq_min = range_s[0], bq_max = range_s[1];

  // the steps to walk: warp w judges steps w, w + 8, ... by their slots'
  // kv_pos (a flag each), then warp 0 packs the flagged ones in order
  const int* kvp = kv_pos + (size_t)b * Skv;
  const int n_all = (Skv + KEYS - 1) / KEYS;
  for (int st = warp; st < n_all; st += MMA_THREADS / 32) {
    bool vis = false;
#pragma unroll
    for (int i = 0; i < KEYS / 32; ++i) {
      const int idx = st * KEYS + 32 * i + lane;
      vis |= idx < Skv && maybe_kept(kvp[idx], bq_min, bq_max, window);
    }
    vis = __any_sync(FULL, vis);
    if (lane == 0) steps_s[st] = vis;
  }
  __syncthreads();
  if (warp == 0) {
    // in place: a step's flag is read before any lane writes at or past it
    int n = 0;
    for (int s0 = 0; s0 < n_all; s0 += 32) {
      const int st = s0 + lane;
      const bool vis = st < n_all && steps_s[st];
      const unsigned ball = __ballot_sync(FULL, vis);
      if (vis) steps_s[n + __popc(ball & ((1u << lane) - 1))] = st;
      n += __popc(ball);
    }
    if (lane == 0) nsteps_s = n;
  }
  __syncthreads();
  const int nsteps = nsteps_s;

  // step n -> ring stage n & 1: K and V rows (zeros past Skv) and their
  // kv_pos (INVALID_POS past Skv)
  auto load_step = [&](int n) {
    const int t0 = steps_s[n] * KEYS;
    unsigned char* kd = ring + (n & 1) * 2 * S::TILE;
    unsigned char* vd = kd + S::TILE;
    constexpr int CH = DH / 8;  // 16-byte chunks a row
    for (int i = tid; i < KEYS * CH; i += MMA_THREADS) {
      const int t = i / CH, c = i - t * CH;
      const int idx = t0 + t;
      const bool in = idx < Skv;
      const size_t off = in ? (((size_t)b * Skv + idx) * Hkv + h) * DH : 0;
      cp_async16(kd + t * SD * 2 + c * 16, k + off + c * 8, in);
      cp_async16(vd + t * SD * 2 + c * 16, v + off + c * 8, in);
    }
    if (tid < KEYS) {
      int* dst = pos_s + (n & 1) * KEYS + tid;
      if (t0 + tid < Skv)
        cp_async4(dst, kvp + t0 + tid);
      else
        *dst = INVALID_POS;
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
    const __nv_bfloat16* st =
        reinterpret_cast<const __nv_bfloat16*>(ring + (n & 1) * 2 * S::TILE);
    const __nv_bfloat16* k_t = st + kp * MMA_KT * SD;
    const __nv_bfloat16* v_t = st + (KEYS + kp * MMA_KT) * SD;
    const int* p_t = pos_s + (n & 1) * KEYS + kp * MMA_KT;
    // does any row of this warp see a key of its part of the step?
    const bool any = __any_sync(
        FULL, maybe_kept(p_t[lane], wmin, wmax, window) ||
                  maybe_kept(p_t[lane + 32], wmin, wmax, window));
    if (any) {
      const auto keep = [&](int col, int row) {
        return kept(p_t[col], qp[row], window);
      };
      const auto k_mul = [&](int) { return scale2; };
      const auto v_mul = [&](int) { return 1.f; };
      // q's A fragments from shared memory, step by step: holding all
      // of them in registers costs 32 a thread and timed slower
      const auto q_frag = [&](int kk, uint32_t(&a)[4]) {
        ldmatrix_x4(a, q_s + (rg * 16 + (lane & 15)) * SD + kk * 16 +
                           (lane >> 4) * 8);
      };
      mma_key_step<DH>(q_frag, k_t, v_t, lane, keep, k_mul, v_mul, o, m, l);
    }
    __syncthreads();  // the stage may be overwritten
  }
  cp_async_wait<0>();
  merge_parts_store<DH, S::KP>(ring, o, m, l, out, b, Sq, Hq, h, G, r0,
                               rows);
}

// -- route 2: split keys -------------------------------------------------------

// grid (n_splits, Hkv * n_tiles, B), block THREADS.  The rows of kv head h
// are r = qi * G + g (query qi, head h * G + g); tile `tile` takes rows
// [RT tile, RT tile + RT), and split s the slots [CHUNK s, CHUNK s + CHUNK).
// Lane geometry as in paged_attn.cu: E = 8 values (16 bytes) a lane, LPR
// lanes a key row, R keys a warp step.  Workspace rows are
// (b Sq + qi) Hq + h G + g.
template <int DH, int RT>
__global__ void __launch_bounds__(THREADS) sel_attn_split_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ kv_pos, float* __restrict__ ws, int Sq, int Skv,
    int Hq, int Hkv, int window, int n_splits, float scale_log2) {
  constexpr int E = 8, LPR = DH / E, R = 32 / LPR, BATCH = SPLIT_STEPS * R;
  static_assert(CHUNK == 2 * THREADS, "two slots a thread");
  const int s = blockIdx.x;
  const int n_tiles = gridDim.y / Hkv;
  const int h = blockIdx.y / n_tiles, tile = blockIdx.y % n_tiles;
  const int b = blockIdx.z, B = gridDim.z;
  const int G = Hq / Hkv;
  const int rt0 = tile * RT;                   // the tile's first row
  const int nr = min(RT, Sq * G - rt0);        // its rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int li = lane % LPR, rg = lane / LPR;  // lane in row, row group
  const Workspace w = workspace(ws, B * Sq, Hq, n_splits, DH);
  const auto row_of = [&](int i) {
    const int r = rt0 + i, qi = r / G;
    return w.row(b * Sq + qi, h * G + r - qi * G, Hq, n_splits, s);
  };

  int qp[RT];
  int qmin = 0x7fffffff, qmax = -1;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    qp[i] = i < nr ? q_pos[(size_t)b * Sq + (rt0 + i) / G] : -1;
    if (qp[i] >= 0) {
      qmin = min(qmin, qp[i]);
      qmax = max(qmax, qp[i]);
    }
  }

  // the chunk's slots that a row of the tile may see, packed in slot order
  __shared__ int slot_s[CHUNK], pos_s[CHUNK];
  __shared__ int count_s[2 * NWARPS];
  const int c0 = s * CHUNK;
  int pos[2];
  bool vis[2];
  unsigned ball[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = c0 + i * THREADS + tid;
    pos[i] = idx < Skv ? kv_pos[(size_t)b * Skv + idx] : INVALID_POS;
    vis[i] = maybe_kept(pos[i], qmin, qmax, window);
    ball[i] = __ballot_sync(FULL, vis[i]);
    if (lane == 0) count_s[i * NWARPS + warp] = __popc(ball[i]);
  }
  __syncthreads();
  int n = 0, base[2] = {0, 0};
#pragma unroll
  for (int j = 0; j < 2 * NWARPS; ++j) {
    const int c = count_s[j];
    base[0] += j < warp ? c : 0;
    base[1] += j < NWARPS + warp ? c : 0;
    n += c;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!vis[i]) continue;
    const int at = base[i] + __popc(ball[i] & ((1u << lane) - 1));
    slot_s[at] = c0 + i * THREADS + tid;
    pos_s[at] = pos[i];
  }

  float qf[RT][E], acc[RT][E], m[RT], l[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int e = 0; e < E; ++e) qf[i][e] = acc[i][e] = 0.f;
    if (i < nr) {
      const int r = rt0 + i, qi = r / G;
      load_f<__nv_bfloat16, E>(
          q + (((size_t)b * Sq + qi) * Hq + h * G + r - qi * G) * DH + li * E,
          qf[i]);
    }
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  __syncthreads();

  const int n_batches = (n + BATCH - 1) / BATCH;
  // one stage of the register ring: K and V of SPLIT_STEPS keys a row
  // group, and their positions (INVALID_POS: no key)
  struct Stage {
    uint4 k[SPLIT_STEPS], v[SPLIT_STEPS];
    int p[SPLIT_STEPS];
  };
  auto load = [&](Stage& st, int bi) {
#pragma unroll
    for (int j = 0; j < SPLIT_STEPS; ++j) {
      const int at = bi * BATCH + j * R + rg;
      if (bi < n_batches && at < n) {
        const size_t row =
            (((size_t)b * Skv + slot_s[at]) * Hkv + h) * DH + li * E;
        st.k[j] = __ldg(reinterpret_cast<const uint4*>(k + row));
        st.v[j] = __ldg(reinterpret_cast<const uint4*>(v + row));
        st.p[j] = pos_s[at];
      } else {
        st.k[j] = st.v[j] = make_uint4(0u, 0u, 0u, 0u);
        st.p[j] = INVALID_POS;
      }
    }
  };
  auto compute = [&](const Stage& st) {
    float x[RT][SPLIT_STEPS];  // logits in log2 units, NEG_INF: not kept
#pragma unroll
    for (int j = 0; j < SPLIT_STEPS; ++j) {
      float kf[E];
      Pack<__nv_bfloat16>::to_f(st.k[j], kf);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qf[i][e], kf[e], d);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          d += __shfl_xor_sync(FULL, d, o);
        x[i][j] = kept(st.p[j], qp[i], window) ? d * scale_log2 : NEG_INF;
      }
    }
    float p[RT][SPLIT_STEPS];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      if (i >= nr) continue;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < SPLIT_STEPS; ++j) mx = fmaxf(mx, x[i][j]);
      const float alpha = exp2f(m[i] - mx);
      m[i] = mx;
      l[i] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= alpha;
#pragma unroll
      for (int j = 0; j < SPLIT_STEPS; ++j) {
        p[i][j] = x[i][j] <= NEG_INF ? 0.f : exp2f(x[i][j] - mx);
        l[i] += p[i][j];
      }
    }
#pragma unroll
    for (int j = 0; j < SPLIT_STEPS; ++j) {
      float vf[E];
      Pack<__nv_bfloat16>::to_f(st.v[j], vf);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        if (i >= nr) continue;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] = fmaf(p[i][j], vf[e], acc[i][e]);
      }
    }
  };

  // warp `warp` takes stages warp, warp + NWARPS, ...; the next one's
  // loads are in flight while the current one is computed.  A chunk with
  // no slot to read has no stage: its partials stay (NEG_INF, 0, 0).
  Stage sa, sb;
  load(sa, warp);
  for (int bi = warp; bi < n_batches; bi += 2 * NWARPS) {
    load(sb, bi + NWARPS);
    compute(sa);
    load(sa, bi + 2 * NWARPS);
    if (bi + NWARPS < n_batches) compute(sb);
  }
  store_partials<DH, RT, E, LPR, NWARPS>(w, acc, m, l, nr, row_of);
}

// -- route 3: CUDA cores -------------------------------------------------------

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
    T* __restrict__ out, float* __restrict__ lse, int Sq, int Skv, int Hq,
    int Hkv, int window, int QT, int GB, float scale) {
  constexpr int Dh = DPL * 32;
  constexpr int VN = Pack<T>::N;
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
      Pack<T>::to_f(*reinterpret_cast<const uint4*>(k + g),
                    k_s + t * Dh + c * VN);
      Pack<T>::to_f(*reinterpret_cast<const uint4*>(v + g),
                    v_s + t * Dh + c * VN);
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
    // the row's log-sum-exp, natural log; -inf for a row with no kept key
    if (lse != nullptr && lane == 0)
      lse[((size_t)b * Sq + q0 + qi) * Hq + head0 + g] =
          l[i] == 0.f ? __int_as_float(0xff800000) : m[i] + logf(l[i]);
  }
}

template <typename T, int DPL>
int launch_dense(const void* q, const void* k, const void* v,
                 const void* q_pos, const void* kv_pos, void* out, void* lse,
                 int B, int Sq, int Skv, int Hq, int Hkv, int window,
                 void* stream) {
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
      static_cast<const int*>(kv_pos), static_cast<T*>(out),
      static_cast<float*>(lse), Sq, Skv, Hq, Hkv, window, QT, GB,
      1.0f / sqrtf((float)(DPL * 32)));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dense(const void* q, const void* k, const void* v,
                   const void* q_pos, const void* kv_pos, void* out,
                   void* lse, int B, int Sq, int Skv, int Hq, int Hkv, int Dh,
                   int window, void* stream) {
  switch (Dh) {
    case 32:
      return launch_dense<T, 1>(q, k, v, q_pos, kv_pos, out, lse, B, Sq, Skv,
                                Hq, Hkv, window, stream);
    case 64:
      return launch_dense<T, 2>(q, k, v, q_pos, kv_pos, out, lse, B, Sq, Skv,
                                Hq, Hkv, window, stream);
    case 128:
      return launch_dense<T, 4>(q, k, v, q_pos, kv_pos, out, lse, B, Sq, Skv,
                                Hq, Hkv, window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Lets a tensor-core instantiation ask for `bytes` of dynamic shared
// memory.  The attribute belongs to the current device, so it is raised
// only when a call needs more than the last value set there.
template <int DH, int RG>
int allow_dense_mma_smem(int bytes) {
  static int set[MAX_DEVICES] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < MAX_DEVICES && set[dev] >= bytes) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      sel_attn_mma_kernel<DH, RG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) set[dev] = bytes;
  return (int)err;
}

template <int DH, int RG>
int launch_dense_mma_rg(const void* q, const void* k, const void* v,
                        const void* q_pos, const void* kv_pos, void* out,
                        int B, int Sq, int Skv, int Hq, int Hkv, int window,
                        cudaStream_t stream) {
  using S = DenseMma<DH, RG>;
  const int smem = S::bytes(Skv);
  if (const int err = allow_dense_mma_smem<DH, RG>(smem)) return err;
  const int rows = Sq * (Hq / Hkv);
  const dim3 grid(Hkv, (rows + S::ROWS - 1) / S::ROWS, B);
  sel_attn_mma_kernel<DH, RG><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<__nv_bfloat16*>(out), Sq,
      Skv, Hq, Hkv, window, 1.0f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

// The streaming multiprocessors of the current device, asked once per
// device.
int sm_count() {
  static int count[MAX_DEVICES] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < MAX_DEVICES && count[dev]) return count[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev < MAX_DEVICES) count[dev] = n;
  return n;
}

// 128-row blocks when they fill every SM at least once, else 64-row
// blocks (twice the blocks, each walking half the steps): below a wave
// the longest walk, not the bytes copied, sets the time.
int dense_mma_rg(int B, int Sq, int Hq, int Hkv) {
  const int tiles = (Sq * (Hq / Hkv) + 127) / 128;
  return (long long)tiles * Hkv * B >= sm_count() ? 8 : 4;
}

template <int DH>
int launch_dense_mma(const void* q, const void* k, const void* v,
                     const void* q_pos, const void* kv_pos, void* out, int B,
                     int Sq, int Skv, int Hq, int Hkv, int window,
                     cudaStream_t stream) {
  return dense_mma_rg(B, Sq, Hq, Hkv) == 8
             ? launch_dense_mma_rg<DH, 8>(q, k, v, q_pos, kv_pos, out, B, Sq,
                                          Skv, Hq, Hkv, window, stream)
             : launch_dense_mma_rg<DH, 4>(q, k, v, q_pos, kv_pos, out, B, Sq,
                                          Skv, Hq, Hkv, window, stream);
}

template <int DH, int RT>
int launch_dense_split(const void* q, const void* k, const void* v,
                       const void* q_pos, const void* kv_pos, void* ws,
                       void* out, void* lse, int B, int Sq, int Skv, int Hq,
                       int Hkv, int window, int n_splits,
                       cudaStream_t stream) {
  const int n_tiles = (Sq * (Hq / Hkv) + RT - 1) / RT;
  const dim3 grid(n_splits, Hkv * n_tiles, B);
  sel_attn_split_kernel<DH, RT><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(kv_pos), static_cast<float*>(ws), Sq, Skv, Hq,
      Hkv, window, n_splits, LOG2E / sqrtf((float)DH));
  if (const cudaError_t err = cudaGetLastError()) return (int)err;
  return launch_merge<__nv_bfloat16, DH>(
      static_cast<float*>(ws), static_cast<__nv_bfloat16*>(out), B * Sq, Hq,
      n_splits, stream, static_cast<float*>(lse));
}

// Calls `fn.template run<DH, RT>()` for the split instantiation that
// serves head dim `dh` and `rows` rows per (sequence, kv head): one row a
// block, or SPLIT_WIDE.
template <typename F>
int split_dispatch(int dh, int rows, const F& fn) {
  if (dh == 64)
    return rows == 1 ? fn.template run<64, 1>()
                     : fn.template run<64, SPLIT_WIDE>();
  if (dh == 128)
    return rows == 1 ? fn.template run<128, 1>()
                     : fn.template run<128, SPLIT_WIDE>();
  return (int)cudaErrorInvalidValue;
}

struct SplitLaunch {
  const void *q, *k, *v, *q_pos, *kv_pos;
  void *ws, *out, *lse;
  int B, Sq, Skv, Hq, Hkv, window, n_splits;
  cudaStream_t stream;
  template <int DH, int RT>
  int run() const {
    return launch_dense_split<DH, RT>(q, k, v, q_pos, kv_pos, ws, out, lse, B,
                                      Sq, Skv, Hq, Hkv, window, n_splits,
                                      stream);
  }
};

// registers, local memory per thread (spills and stack; 0 when nothing
// spills), static and dynamic shared memory per block, resident blocks per
// SM, threads per block and rows per block of one instantiation
template <typename K>
int kernel_info(K kern, int threads, int smem, int rows, int* info) {
  cudaFuncAttributes attr;
  if (const cudaError_t err = cudaFuncGetAttributes(&attr, kern))
    return (int)err;
  int blocks = 0;
  if (const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kern, threads, smem))
    return (int)err;
  const int vals[7] = {attr.numRegs, (int)attr.localSizeBytes,
                       (int)attr.sharedSizeBytes, smem, blocks, threads, rows};
  for (int i = 0; i < 7; ++i) info[i] = vals[i];
  return 0;
}

struct SplitInfo {
  int* info;
  template <int DH, int RT>
  int run() const {
    return kernel_info(sel_attn_split_kernel<DH, RT>, THREADS, 0, RT, info);
  }
};

template <int DH, int RG>
int dense_mma_info(int skv, int* info) {
  const int smem = DenseMma<DH, RG>::bytes(skv);
  if (const int err = allow_dense_mma_smem<DH, RG>(smem)) return err;
  return kernel_info(sel_attn_mma_kernel<DH, RG>, MMA_THREADS, smem,
                     DenseMma<DH, RG>::ROWS, info);
}

enum class Route { CORES, MMA, SPLIT };

// One signature for every route (ws and n_splits serve the split route;
// lse, when not null, takes each row's log-sum-exp on the split and
// CUDA-core routes, and the tensor-core route refuses it).
template <Route ROUTE, typename T>
int dense_entry(const void* q, const void* k, const void* v,
                const void* q_pos, const void* kv_pos, void* ws, void* out,
                void* lse, int B, int Sq, int Skv, int Hq, int Hkv, int Dh,
                int window, int n_splits, void* stream) {
  if (Hkv < 1 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (ROUTE == Route::CORES) {
    return dispatch_dense<T>(q, k, v, q_pos, kv_pos, out, lse, B, Sq, Skv, Hq,
                             Hkv, Dh, window, stream);
  } else if constexpr (ROUTE == Route::MMA) {
    if (lse != nullptr) return (int)cudaErrorInvalidValue;
    if (Dh == 64)
      return launch_dense_mma<64>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, Hq,
                                  Hkv, window, st);
    if (Dh == 128)
      return launch_dense_mma<128>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv,
                                   Hq, Hkv, window, st);
    return (int)cudaErrorInvalidValue;
  } else {
    if (n_splits < 1) return (int)cudaErrorInvalidValue;
    return split_dispatch(Dh, Sq * (Hq / Hkv),
                          SplitLaunch{q, k, v, q_pos, kv_pos, ws, out, lse, B,
                                      Sq, Skv, Hq, Hkv, window, n_splits,
                                      st});
  }
}

}  // namespace

#define SEL_ATTN_DENSE_ENTRY(NAME, ROUTE, T)                                 \
  extern "C" int NAME(const void* q, const void* k, const void* v,           \
                      const void* q_pos, const void* kv_pos, void* ws,       \
                      void* out, void* lse, int B, int Sq, int Skv, int Hq,  \
                      int Hkv, int Dh, int window, int n_splits,             \
                      void* stream) {                                        \
    return dense_entry<ROUTE, T>(q, k, v, q_pos, kv_pos, ws, out, lse, B,    \
                                 Sq, Skv, Hq, Hkv, Dh, window, n_splits,     \
                                 stream);                                    \
  }

SEL_ATTN_DENSE_ENTRY(sel_attn_f32, Route::CORES, float)
SEL_ATTN_DENSE_ENTRY(sel_attn_bf16, Route::CORES, __nv_bfloat16)
SEL_ATTN_DENSE_ENTRY(sel_attn_mma_bf16, Route::MMA, __nv_bfloat16)
SEL_ATTN_DENSE_ENTRY(sel_attn_split_bf16, Route::SPLIT, __nv_bfloat16)

// What the card says of a dense bf16 instantiation (7 ints, see
// kernel_info): routes 0 and 2 the tensor-core kernel with 128- and
// 64-row blocks for head dim `dh` with `arg` = Skv (its dynamic shared
// memory grows with it), route 1 the split kernel for `arg` rows per
// (sequence, kv head).
extern "C" int sel_attn_dense_info(int route, int dh, int arg, int* info) {
  if (route == 0 || route == 2) {
    const bool wide = route == 0;
    if (dh == 64)
      return wide ? dense_mma_info<64, 8>(arg, info)
                  : dense_mma_info<64, 4>(arg, info);
    if (dh == 128)
      return wide ? dense_mma_info<128, 8>(arg, info)
                  : dense_mma_info<128, 4>(arg, info);
    return (int)cudaErrorInvalidValue;
  }
  if (route == 1) return split_dispatch(dh, arg, SplitInfo{info});
  return (int)cudaErrorInvalidValue;
}
