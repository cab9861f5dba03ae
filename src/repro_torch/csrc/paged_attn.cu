// Paged decode attention for Hopper (sm_90a): split-key (flash-decoding)
// kernels, one source for the 16-bit, fp32 and int8 pools.
//
// Replaces the Pallas TPU kernels `_paged_attn_kernel` (16-bit pool) and
// `_paged_attn_q8_kernel` (int8 pool) of
// src/repro/kernels/paged_attn/paged_attn.py.  What it computes is theirs:
// one query per sequence, the GQA group of query heads per kv head, keys
// read through the page table, a softmax over the keys
// `lo <= idx < hi` with `lo = max(0, length - window)` (0 without a
// window) and `hi = min(length, mp * ps)`.  On the int8 pool the K scale of
// a key's page multiplies its logit and the V scale multiplies its
// probability before it meets V (not the normaliser).  A row with no valid
// key (an idle slot, `length == 0`) gives zeros, as Pallas does.
//
// What bounds it on an H100: bytes.  A key costs 4·Dh·G FLOPs (the logit
// and P·V for the G query heads of its kv head) over 4·Dh bytes of bf16 K
// and V: G FLOP per byte, 1 for llava (MHA), at most 8 for the GQA groups
// the repo's configurations have.  The card needs ~295 FLOP per byte
// before its tensor cores, not its memory, limit, so tensor cores (wgmma,
// mma.sync) would buy nothing: the design only keeps enough bytes moving.
//
// What held the first kernel (one block per sequence and kv head) back,
// and what this one does about each:
//   1. Too few bytes in flight (128 blocks, one 2-byte load per lane per
//      key behind a dependent page-table load).  Here every lane loads 16
//      bytes of a key row at a time (a bf16 row of Dh 128 is 16 lanes, a
//      warp takes two keys a step; int8 8 lanes, fp32 32), the chunk's
//      page indices (and int8 scales) are loaded once per page into shared
//      memory before the loop, and each warp keeps the K and V of its
//      next stage (STEPS = 2 steps) in flight in registers while it
//      computes on the current one: a register double buffer, loads issued
//      a stage ahead.  In flight per warp: 2 steps x 32 lanes x 32 bytes
//      = 2 KB for the next stage, up to 4 KB while the current one still
//      lands.  At the main path's shape (bf16, Dh 128, G 1: 72 registers)
//      7 blocks of 4 warps fit an SM (int8: 94 registers, 5 blocks), so
//      56-112 KB per SM, against the ~20 KB an SM's share of HBM bandwidth
//      needs (25 B/ns at ~0.8 us of loaded latency, an estimate).  Deeper
//      stages (4, 8 steps) were no faster on the card and spilled at 8.
//   2. Serial reductions and idle warps.  A key's logit is a 4-step
//      shuffle within its row's 16 lanes (bf16, Dh 128), once per query
//      head; every warp walks keys; there is no barrier in the key loop.
//   3. Scalar P·V from shared memory.  V is read with K's lane layout, so
//      P·V accumulates in each lane's registers.
//   4. No split over keys.  The grid is (n_splits, Hkv x G-tiles, B): the
//      key range of a row is cut into chunks of CHUNK keys counted from
//      `lo`, so a window costs only the chunks it covers, four sequences
//      of 2k keys give ~1k blocks and one sequence still spreads over the
//      card.  `n_splits` comes from the page table's width (the host never
//      reads `lengths`); a block whose chunk starts past its row's range
//      writes an empty partial and exits.
//
// Each block merges its warps' (m, l, acc) through shared memory and
// writes one fp32 partial per (b, query head, split) to a workspace the
// wrapper allocates; a second, small kernel, launched by the same C entry
// on the same stream, merges the splits of each (b, query head): rescale
// by exp(m_s - m_max), divide by the merged l, zeros where it is 0.  Empty
// partials carry the finite NEG_INF, so an all-empty row merges to
// exp(0)·0 = 0 (a true -inf would give exp(-inf + inf) = NaN).  Masks
// select before the exponent.  Softmax statistics are in log2 units.  The
// partials' layout, the merge kernel and the 16-byte unpacking live in
// split_kv.cuh, shared with the dense decode route of selective_attn.cu.
//
// Query heads: a block takes GT of its kv head's G query heads (each
// lane keeps its slice of q and of the accumulator for each in
// registers); G = 1 runs the GT = 1 instantiation, larger groups
// GT = min(4, 32 / values per lane) in ceil(G / GT) tiles, whose blocks
// read the same K/V rows (the later ones mostly from L2).  Head dims 64
// and 128, G up to 8; the wrapper refuses others.
//
// Launches: one C entry launches the two kernels; the Python wrapper
// counts it as one launch of `paged_attn` / `paged_attn_q8`.  No dynamic
// shared memory, so no attribute to set.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "split_kv.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int STEPS = 2;    // warp steps per stage of the register ring
constexpr int MAX_GROUP = 8;

// Lane geometry of a key row: E values (16 bytes) per lane, LPR lanes per
// row, R rows per warp step, BATCH keys per warp per stage.
template <typename KV, int DH>
struct Rows {
  static constexpr int E = 16 / sizeof(KV);
  static constexpr int LPR = DH / E;
  static constexpr int R = 32 / LPR;
  static constexpr int BATCH = STEPS * R;
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "row fits a warp");
};

// query heads a block takes when the group is larger than one: at most 4,
// and at most 32 accumulator values per lane (16 / sizeof(KV) a head)
template <typename KV>
constexpr int WIDE_TILE = 2 * sizeof(KV) < 4 ? 2 * (int)sizeof(KV) : 4;

// One stage of the register ring: K and V of STEPS keys per row group, and
// each key's page in the block's page list (-1: no key).
struct Stage {
  uint4 k[STEPS], v[STEPS];
  int jp[STEPS];
};

// grid (n_splits, Hkv * n_tiles, B), block THREADS.
template <typename T, typename KV, int DH, int GT, bool Q8>
__global__ void __launch_bounds__(THREADS) paged_decode_split_kernel(
    const T* __restrict__ q, const KV* __restrict__ k_pool,
    const KV* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ page_table,
    const int* __restrict__ lengths, float* __restrict__ ws, int Hq, int Hkv,
    int ps, int mp, int window, int n_splits, float scale_log2) {
  using L = Rows<KV, DH>;
  constexpr int E = L::E, LPR = L::LPR, R = L::R;
  const int s = blockIdx.x;
  const int n_tiles = gridDim.y / Hkv;
  const int h = blockIdx.y / n_tiles, tile = blockIdx.y % n_tiles;
  const int b = blockIdx.z, B = gridDim.z;
  const int G = Hq / Hkv;
  const int hq0 = h * G + tile * GT;               // first query head
  const int ng = min(GT, G - tile * GT);           // query heads here
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int li = lane % LPR, rg = lane / LPR;      // lane in row, row group
  const Workspace w = workspace(ws, B, Hq, n_splits, DH);

  const int length = lengths[b];
  const int lo = window > 0 ? max(0, length - window) : 0;
  const int hi = min(length, mp * ps);
  const int c0 = lo + s * CHUNK;
  const int c1 = min(c0 + CHUNK, hi);
  const auto row_of = [&](int g) {
    return w.row(b, hq0 + g, Hq, n_splits, s);
  };
  if (c0 >= c1) {  // nothing here: an empty partial
    for (int i = tid; i < ng * DH; i += THREADS)
      w.acc[row_of(i / DH) * DH + i % DH] = 0.f;
    if (tid < ng) {
      const size_t r = row_of(tid);
      w.ml[2 * r] = NEG_INF;
      w.ml[2 * r + 1] = 0.f;
    }
    return;
  }

  // the chunk's pages (and int8 scales), once per page
  __shared__ int pg_s[CHUNK];
  __shared__ float sc_s[Q8 ? 2 * CHUNK : 1];
  const int* pt = page_table + (size_t)b * mp;
  const int p0 = c0 / ps;
  const int np = (c1 - 1) / ps - p0 + 1;
  for (int i = tid; i < np; i += THREADS) {
    const int page = pt[p0 + i];
    pg_s[i] = page;
    if constexpr (Q8) {
      sc_s[i] = k_scale[(size_t)page * Hkv + h] * scale_log2;
      sc_s[CHUNK + i] = v_scale[(size_t)page * Hkv + h];
    }
  }

  float qf[GT][E], acc[GT][E], m[GT], l[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int e = 0; e < E; ++e) qf[g][e] = acc[g][e] = 0.f;
    if (g < ng)
      load_f<T, E>(q + ((size_t)b * Hq + hq0 + g) * DH + li * E, qf[g]);
    m[g] = NEG_INF;
    l[g] = 0.f;
  }
  __syncthreads();

  const int n_batches = (c1 - c0 + L::BATCH - 1) / L::BATCH;
  const size_t head_off = (size_t)h * DH + li * E;

  auto load = [&](Stage& st, int bi) {
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      const int idx = c0 + bi * L::BATCH + j * R + rg;
      if (bi < n_batches && idx < c1) {
        const int jp = idx / ps - p0;
        const size_t row =
            ((size_t)pg_s[jp] * ps + (idx - (p0 + jp) * ps)) * Hkv * DH +
            head_off;
        st.k[j] = __ldg(reinterpret_cast<const uint4*>(k_pool + row));
        st.v[j] = __ldg(reinterpret_cast<const uint4*>(v_pool + row));
        st.jp[j] = jp;
      } else {
        st.k[j] = st.v[j] = make_uint4(0u, 0u, 0u, 0u);
        st.jp[j] = -1;
      }
    }
  };

  // what a key's dot product and its probability are multiplied by
  auto k_mul = [&](int jp) {
    if constexpr (Q8) return sc_s[jp];
    else return scale_log2;
  };
  auto v_mul = [&](int jp) {
    if constexpr (Q8) return sc_s[CHUNK + jp];
    else return 1.f;
  };

  auto compute = [&](const Stage& st) {
    float x[GT][STEPS];  // logits in log2 units, NEG_INF where no key
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      float kf[E];
      Pack<KV>::to_f(st.k[j], kf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qf[g][e], kf[e], d);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          d += __shfl_xor_sync(FULL, d, o);
        x[g][j] = st.jp[j] >= 0 ? d * k_mul(st.jp[j]) : NEG_INF;
      }
    }
    float p[GT][STEPS];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g >= ng) continue;
      float mx = m[g];
#pragma unroll
      for (int j = 0; j < STEPS; ++j) mx = fmaxf(mx, x[g][j]);
      const float alpha = exp2f(m[g] - mx);
      m[g] = mx;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int j = 0; j < STEPS; ++j) {
        p[g][j] = st.jp[j] >= 0 ? exp2f(x[g][j] - mx) : 0.f;
        l[g] += p[g][j];
      }
    }
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      float vf[E];
      Pack<KV>::to_f(st.v[j], vf);
      const float vsc = st.jp[j] >= 0 ? v_mul(st.jp[j]) : 0.f;
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        if (g >= ng) continue;
        const float pv = p[g][j] * vsc;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pv, vf[e], acc[g][e]);
      }
    }
  };

  // warp `warp` takes stages warp, warp + NWARPS, ...; the next one's
  // loads are in flight while the current one is computed
  Stage sa, sb;
  load(sa, warp);
  for (int bi = warp; bi < n_batches; bi += 2 * NWARPS) {
    load(sb, bi + NWARPS);
    compute(sa);
    load(sa, bi + 2 * NWARPS);
    if (bi + NWARPS < n_batches) compute(sb);
  }

  // the warp's row groups, then the block's warps, into one partial per
  // query head
  store_partials<DH, GT, E, LPR, NWARPS>(w, acc, m, l, ng, row_of);
}

template <typename T, typename KV, int DH, int GT>
constexpr auto split_kernel() {
  return paged_decode_split_kernel<T, KV, DH, GT,
                                   std::is_same<KV, int8_t>::value>;
}

// Calls `fn.template run<DH, GT>()` for the instantiation that serves head
// dim `dh` and group `group`; cudaErrorInvalidValue for any other.
template <typename KV, typename F>
int dispatch(int dh, int group, const F& fn) {
  if (group < 1 || group > MAX_GROUP) return (int)cudaErrorInvalidValue;
  constexpr int WIDE = WIDE_TILE<KV>;
  if (dh == 64)
    return group == 1 ? fn.template run<64, 1>()
                      : fn.template run<64, WIDE>();
  if (dh == 128)
    return group == 1 ? fn.template run<128, 1>()
                      : fn.template run<128, WIDE>();
  return (int)cudaErrorInvalidValue;
}

// One call: both kernels on `stream`, each launch checked.
template <typename T, typename KV>
struct Launch {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *page_table,
      *lengths;
  void *ws, *out;
  int B, Hq, Hkv, ps, mp, window, n_splits;
  cudaStream_t stream;

  template <int DH, int GT>
  int run() const {
    const int n_tiles = (Hq / Hkv + GT - 1) / GT;
    const dim3 grid(n_splits, Hkv * n_tiles, B);
    split_kernel<T, KV, DH, GT>()<<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const KV*>(k_pool),
        static_cast<const KV*>(v_pool), static_cast<const float*>(k_scale),
        static_cast<const float*>(v_scale),
        static_cast<const int*>(page_table), static_cast<const int*>(lengths),
        static_cast<float*>(ws), Hq, Hkv, ps, mp, window, n_splits,
        LOG2E / sqrtf((float)DH));
    if (const cudaError_t err = cudaGetLastError()) return (int)err;
    return launch_merge<T, DH>(static_cast<float*>(ws), static_cast<T*>(out),
                               B, Hq, n_splits, stream);
  }
};

// What the card says of the split kernel that serves (T, KV, dh, group):
// registers per thread, local memory per thread in bytes (spills and
// stack; 0 when nothing spills), static and dynamic shared memory per block
// in bytes, resident blocks per SM, threads per block, query heads per
// block (GT).
template <typename T, typename KV>
struct Info {
  int* out;

  template <int DH, int GT>
  int run() const {
    auto kern = split_kernel<T, KV, DH, GT>();
    cudaFuncAttributes attr;
    if (const cudaError_t err = cudaFuncGetAttributes(&attr, kern))
      return (int)err;
    int blocks = 0;
    if (const cudaError_t err =
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                          THREADS, 0))
      return (int)err;
    const int vals[7] = {attr.numRegs, (int)attr.localSizeBytes,
                         (int)attr.sharedSizeBytes, 0, blocks, THREADS, GT};
    for (int i = 0; i < 7; ++i) out[i] = vals[i];
    return 0;
  }
};

template <typename T, typename KV>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale, const void* page_table,
           const void* lengths, void* ws, void* out, int B, int Hq, int Hkv,
           int Dh, int ps, int mp, int window, int n_splits, void* stream) {
  if (Hkv < 1 || Hq % Hkv != 0 || n_splits < 1)
    return (int)cudaErrorInvalidValue;
  const Launch<T, KV> call{q,   k_pool, v_pool, k_scale, v_scale,
                           page_table, lengths, ws, out, B, Hq, Hkv, ps,
                           mp,  window, n_splits,
                           static_cast<cudaStream_t>(stream)};
  return dispatch<KV>(Dh, Hq / Hkv, call);
}

}  // namespace

#define PAGED_ATTN_ENTRY(NAME, T, KV)                                          \
  extern "C" int NAME(const void* q, const void* k_pool, const void* v_pool,   \
                      const void* k_scale, const void* v_scale,                \
                      const void* page_table, const void* lengths, void* ws,   \
                      void* out, int B, int Hq, int Hkv, int Dh, int ps,       \
                      int mp, int window, int n_splits, void* stream) {        \
    return launch<T, KV>(q, k_pool, v_pool, k_scale, v_scale, page_table,      \
                         lengths, ws, out, B, Hq, Hkv, Dh, ps, mp, window,     \
                         n_splits, stream);                                    \
  }

PAGED_ATTN_ENTRY(paged_attn_f32, float, float)
PAGED_ATTN_ENTRY(paged_attn_bf16, __nv_bfloat16, __nv_bfloat16)
PAGED_ATTN_ENTRY(paged_attn_q8_f32, float, int8_t)
PAGED_ATTN_ENTRY(paged_attn_q8_bf16, __nv_bfloat16, int8_t)

// pool: 0 the q-typed pool, 1 int8; bf16: q is bf16 (else fp32)
extern "C" int paged_attn_info(int pool, int bf16, int dh, int group,
                               int* out) {
  if (pool)
    return bf16 ? dispatch<int8_t>(dh, group, Info<__nv_bfloat16, int8_t>{out})
                : dispatch<int8_t>(dh, group, Info<float, int8_t>{out});
  return bf16 ? dispatch<__nv_bfloat16>(
                    dh, group, Info<__nv_bfloat16, __nv_bfloat16>{out})
              : dispatch<float>(dh, group, Info<float, float>{out});
}
