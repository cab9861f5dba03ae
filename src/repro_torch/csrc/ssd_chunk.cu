// SSD intra-chunk kernels (Mamba2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ssd_chunk_kernel` of
// src/repro/kernels/ssd_chunk/ssd_chunk.py: the intra-chunk step of the
// chunked SSD scan, launched once per layer of every SSM prefill.  Per
// (batch, chunk, head), with the chunk's x (Q, hd), B and C (Q, ds, shared
// by the heads), la and dt (Q,), all fp32:
//   cum        = cumsum(la),  total = cum[Q-1]
//   y_intra[q] = sum_{k<=q} (C_q . B_k) exp(cum_q - cum_k) dt_k x_k
//   s_c        = sum_q exp(total - cum_q) dt_q B_q (outer) x_q     (ds, hd)
//   a_c        = exp(total)
// The entries k > q are selected away, never multiplied by a zero mask:
// there exp(cum_q - cum_k) overflows for a large dt, and inf * 0 is NaN (the
// JAX oracle's tril product has that fault; the Pallas kernel selects).
//
// Layouts are the contract's, (B, NC, H, Q, .), read through strides: the
// model holds x as (B, NC, Q, H, hd) and la/dt as (B, NC, Q, H), and the
// wrapper passes permuted views of them, read in place.  Only the last dim
// of x, bm and cm must have unit stride.  Outputs are contiguous: y (B, NC,
// H, Q, hd), s (B, NC, H, ds, hd), a (B, NC, H).
//
// What bounds it on an H100: at mamba2-130m's live shape (21 chunks x 24
// heads, Q 64, hd 64, ds 128) a call must move 34.7 MB (s_c alone 16.5 MB
// written, y_intra and x 8.3 MB each), 0.0103 ms at 3.35 TB/s.  Its 0.68
// GFLOP of fp32 work take 0.0101 ms at the CUDA cores' 67 TFLOP/s, so on
// the CUDA cores the kernel is bound by both about equally; on the tensor
// cores (495 TFLOP/s in TF32) even three products per fp32 product take
// ~0.004 ms, and the bytes are the bound.
//
// Two routes, one C entry each, picked by the wrapper from host shapes
// (ssd_chunk/ops.py, ssd_route):
//
// Tensor cores (`ssd_chunk_mma_f32`; Q 32, 64 or 128, hd 64, ds 128, the
// shapes of every mamba2 size):
//   * all three products -- C.B^T (Q x Q, depth ds), S.X (Q x hd, depth Q)
//     and (B w)^T.X (ds x hd, depth Q) -- run on mma.sync m16n8k8 in TF32,
//     three passes each: an fp32 operand splits into hi = tf32(a) and lo =
//     tf32(a - hi), both rounded to nearest (raw fp32 bits in a .tf32
//     operand would be truncated), and a product sums hi.hi in one
//     accumulator and hi.lo + lo.hi in another, added last.  One pass
//     misses the fp32 limit ~45x, three stay at ~0.04 of it
//     (tests/test_torch_check.py).  S and B are split after their decay and
//     dt factors are applied;
//   * a block owns one chunk and G of its heads (G from the host's shapes,
//     ssd_chunk/ops.py plan_head_groups, so that the grid fills the card
//     once): it computes C.B^T once, over the causal 16x8 tiles only, and
//     keeps it in shared memory, in the mma A-fragment order (one 16-byte
//     load a lane a fragment), for all G heads;
//   * B and C are loaded once per block; the next head's x, la and dt are
//     copied with cp.async into a two-stage ring while the current head
//     computes (x read in place through the model layout's row stride);
//   * no padding: tiles stop at Q, key steps wholly above the diagonal are
//     skipped in C.B^T and in S.X, the state runs over the Q real steps;
//   * a lane swaps half of its accumulator fragment with its neighbour, so
//     that each lane stores four consecutive columns: y_intra and s_c leave
//     as 16-byte stores;
//   * the cumsum is one warp's scan; a_c = exp(total); the k > q entries are
//     selected before the exponent.
// What holds it above its bound: one 256-thread block an SM (148 registers,
// 99 KB of shared memory at Q 64) issues each head's ~2,000 mma.sync and
// the ~50k TF32 splits of their operands itself, and the block's first
// head waits for B, C and C.B^T.  `wgmma` with TMA is later work.
//
// CUDA cores (`ssd_chunk_f32`; any Q <= 128, ds <= 128, hd <= 128: the JAX
// package's small test shapes): the first port, one block per (chunk,
// head), fp32 FMAs on register tiles, C.B^T recomputed by every head.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int RT = 32;                  // score rows per tile
constexpr int MAX_Q = 128;
constexpr int MAX_DS = 128;
constexpr int MAX_HD = 128;
constexpr int US = MAX_DS / NWARPS;     // chunk-state rows per thread
constexpr int UR = RT / NWARPS;         // score / y rows per thread
constexpr int UK = MAX_Q / 32;          // score columns (keys) per lane

// grid (B * NC * H), block THREADS.  UV: output columns per lane, hd <= 32*UV.
template <int UV>
__global__ void __launch_bounds__(THREADS) ssd_chunk_kernel(
    const float* __restrict__ x, long long sxb, long long sxn, long long sxh,
    long long sxq, const float* __restrict__ bm, long long sbb, long long sbn,
    long long sbq, const float* __restrict__ cm, long long scb, long long scn,
    long long scq, const float* __restrict__ la, long long slb, long long sln,
    long long slh, long long slq, const float* __restrict__ dt, long long sdb,
    long long sdn, long long sdh, long long sdq, float* __restrict__ y,
    float* __restrict__ s, float* __restrict__ a, int NC, int H, int Q,
    int hd, int ds) {
  extern __shared__ float smem[];
  const int ldb = ds | 1;
  float* sB = smem;               // Q x ldb
  float* sX = sB + Q * ldb;       // Q x hd
  float* sC = sX + Q * hd;        // RT x ds: rows r0.. of C
  float* sS = sC + RT * ds;       // RT x Q: the scores of those rows
  float* sCum = sS + RT * Q;      // Q
  float* sDt = sCum + Q;          // Q
  float* sW = sDt + Q;            // Q: exp(total - cum_q) * dt_q

  const long long bid = blockIdx.x;
  const int h = (int)(bid % H);
  const int n = (int)((bid / H) % NC);
  const long long b = bid / ((long long)H * NC);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const float* xb = x + b * sxb + n * sxn + h * sxh;
  const float* bb = bm + b * sbb + n * sbn;
  const float* cb = cm + b * scb + n * scn;
  const float* lab = la + b * slb + n * sln + h * slh;
  const float* dtb = dt + b * sdb + n * sdn + h * sdh;

  for (int i = tid; i < Q * ds; i += THREADS) {
    const int r = i / ds, c = i - r * ds;
    sB[r * ldb + c] = bb[r * sbq + c];
  }
  for (int i = tid; i < Q * hd; i += THREADS) {
    const int r = i / hd, c = i - r * hd;
    sX[r * hd + c] = xb[r * sxq + c];
  }
  for (int i = tid; i < Q; i += THREADS) {
    sCum[i] = lab[i * slq];
    sDt[i] = dtb[i * sdq];
  }
  __syncthreads();

  // cumsum(la), by warp 0: lane l sums its E consecutive entries in order,
  // then adds the totals of the lanes before it (an inclusive shuffle scan)
  if (warp == 0) {
    const int E = (Q + 31) / 32;
    const int lo = lane * E;
    float part[MAX_Q / 32];
    float run = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_Q / 32; ++j) {
      if (j < E && lo + j < Q) run += sCum[lo + j];
      part[j] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    const float before = incl - run;
#pragma unroll
    for (int j = 0; j < MAX_Q / 32; ++j)
      if (j < E && lo + j < Q) sCum[lo + j] = part[j] + before;
  }
  __syncthreads();
  const float total = sCum[Q - 1];
  for (int i = tid; i < Q; i += THREADS)
    sW[i] = expf(total - sCum[i]) * sDt[i];
  if (tid == 0) a[bid] = expf(total);
  __syncthreads();

  // chunk state s[i][d] = sum_q B[q][i] * (w_q x[q][d]):
  // rows i = warp + NWARPS*u, columns d = lane + 32*v
  {
    float acc[US][UV];
#pragma unroll
    for (int u = 0; u < US; ++u)
#pragma unroll
      for (int v = 0; v < UV; ++v) acc[u][v] = 0.f;
    for (int q = 0; q < Q; ++q) {
      const float w = sW[q];
      float xv[UV];
#pragma unroll
      for (int v = 0; v < UV; ++v) {
        const int d = lane + 32 * v;
        xv[v] = d < hd ? w * sX[q * hd + d] : 0.f;
      }
      const float* brow = sB + q * ldb;
#pragma unroll
      for (int u = 0; u < US; ++u) {
        const int i = warp + NWARPS * u;
        if (i < ds) {
          const float bv = brow[i];
#pragma unroll
          for (int v = 0; v < UV; ++v) acc[u][v] = fmaf(bv, xv[v], acc[u][v]);
        }
      }
    }
    float* sout = s + bid * ds * hd;
#pragma unroll
    for (int u = 0; u < US; ++u) {
      const int i = warp + NWARPS * u;
#pragma unroll
      for (int v = 0; v < UV; ++v) {
        const int d = lane + 32 * v;
        if (i < ds && d < hd) sout[i * hd + d] = acc[u][v];
      }
    }
  }

  float* yout = y + bid * Q * hd;
  for (int r0 = 0; r0 < Q; r0 += RT) {
    const int rows = min(RT, Q - r0);
    const int kmax = r0 + rows;     // keys any row of the tile can see
    for (int i = tid; i < rows * ds; i += THREADS) {
      const int r = i / ds, c = i - r * ds;
      sC[r * ds + c] = cb[(long long)(r0 + r) * scq + c];
    }
    __syncthreads();

    // scores S[r][k] = (C_r . B_k) exp(cum_r - cum_k) dt_k for k <= r, else
    // 0 (selected, the exponent never taken): rows r0 + warp + NWARPS*u,
    // keys k = lane + 32*j
    {
      float acc[UR][UK];
#pragma unroll
      for (int u = 0; u < UR; ++u)
#pragma unroll
        for (int j = 0; j < UK; ++j) acc[u][j] = 0.f;
      for (int c = 0; c < ds; ++c) {
        float bv[UK];
#pragma unroll
        for (int j = 0; j < UK; ++j) {
          const int k = lane + 32 * j;
          bv[j] = k < kmax ? sB[k * ldb + c] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < UR; ++u) {
          const int rl = warp + NWARPS * u;
          const float cv = rl < rows ? sC[rl * ds + c] : 0.f;
#pragma unroll
          for (int j = 0; j < UK; ++j) acc[u][j] = fmaf(cv, bv[j], acc[u][j]);
        }
      }
#pragma unroll
      for (int u = 0; u < UR; ++u) {
        const int rl = warp + NWARPS * u;
        const int r = r0 + rl;
#pragma unroll
        for (int j = 0; j < UK; ++j) {
          const int k = lane + 32 * j;
          if (rl < rows && k < kmax)
            sS[rl * Q + k] =
                k <= r ? acc[u][j] * expf(sCum[r] - sCum[k]) * sDt[k] : 0.f;
        }
      }
    }
    __syncthreads();

    // y[r][d] = sum_{k < kmax} S[r][k] x[k][d]: rows as above, d = lane+32*v
    {
      float acc[UR][UV];
#pragma unroll
      for (int u = 0; u < UR; ++u)
#pragma unroll
        for (int v = 0; v < UV; ++v) acc[u][v] = 0.f;
      for (int k = 0; k < kmax; ++k) {
        float xv[UV];
#pragma unroll
        for (int v = 0; v < UV; ++v) {
          const int d = lane + 32 * v;
          xv[v] = d < hd ? sX[k * hd + d] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < UR; ++u) {
          const int rl = warp + NWARPS * u;
          const float sv = rl < rows ? sS[rl * Q + k] : 0.f;
#pragma unroll
          for (int v = 0; v < UV; ++v) acc[u][v] = fmaf(sv, xv[v], acc[u][v]);
        }
      }
#pragma unroll
      for (int u = 0; u < UR; ++u) {
        const int rl = warp + NWARPS * u;
#pragma unroll
        for (int v = 0; v < UV; ++v) {
          const int d = lane + 32 * v;
          if (rl < rows && d < hd) yout[(r0 + rl) * hd + d] = acc[u][v];
        }
      }
    }
    __syncthreads();    // sC and sS are refilled by the next tile
  }
}

size_t cores_smem(int Q, int hd, int ds) {
  return sizeof(float) * ((size_t)Q * (ds | 1) + (size_t)Q * hd +
                          (size_t)RT * ds + (size_t)RT * Q + 3 * (size_t)Q);
}

template <int UV>
int launch_cores(const void* x, const long long* sx, const void* bm,
                 const long long* sb, const void* cm, const long long* sc,
                 const void* la, const long long* sl, const void* dt,
                 const long long* sd, void* y, void* s, void* a, int B,
                 int NC, int H, int Q, int hd, int ds, cudaStream_t stream) {
  const size_t smem = cores_smem(Q, hd, ds);
  auto kern = ssd_chunk_kernel<UV>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)B * NC * H;
  kern<<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const float*>(x), sx[0], sx[1], sx[2], sx[3],
      static_cast<const float*>(bm), sb[0], sb[1], sb[2],
      static_cast<const float*>(cm), sc[0], sc[1], sc[2],
      static_cast<const float*>(la), sl[0], sl[1], sl[2], sl[3],
      static_cast<const float*>(dt), sd[0], sd[1], sd[2], sd[3],
      static_cast<float*>(y), static_cast<float*>(s), static_cast<float*>(a),
      NC, H, Q, hd, ds);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core route

constexpr int MMA_THREADS = 256;
constexpr int MMA_WARPS = MMA_THREADS / 32;
constexpr int MAX_SMEM = 232448;        // a block's shared memory on sm_90
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v rounded to TF32 (10 mantissa bits; to nearest, ties away from zero),
// the rounding cvt.rna.tf32.f32 does, in two integer operations on the
// bits: the conversion unit issues a quarter as many a clock as the
// integer pipes, and the kernel splits ~50k operands a head
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo, each a TF32 value, together ~21 significant bits of v's 24
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

// d += a (16x8, row) . b (8x8, col), TF32 in, fp32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The three TF32 products of one fp32 product: big += hi.hi, small += hi.lo
// + lo.hi (the small terms in their own sums, added to big last)
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(big, ahi, bh0, bh1);
  mma_tf32(small, ahi, bl0, bl1);
  mma_tf32(small, alo, bh0, bh1);
}

// Stores the 16x8 tile big + small (the mma's C fragment: this lane holds
// rows gid and gid + 8, columns 2 tig and 2 tig + 1) at out (row stride
// ld): neighbouring lanes swap half their values, so that an even lane holds
// row gid's four columns 4 (tig / 2) .. + 3 and an odd lane row gid + 8's,
// and each lane stores them as one 16-byte vector.
__device__ __forceinline__ void store_tile(float* out, int ld,
                                           const float (&big)[4],
                                           const float (&small)[4], int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  const bool odd = tig & 1;
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = big[e] + small[e];
  const float r0 = __shfl_xor_sync(FULL, odd ? v[0] : v[2], 1);
  const float r1 = __shfl_xor_sync(FULL, odd ? v[1] : v[3], 1);
  const float4 o = odd ? make_float4(r0, r1, v[2], v[3])
                       : make_float4(v[0], v[1], r0, r1);
  *reinterpret_cast<float4*>(out + (gid + (odd ? 8 : 0)) * ld +
                             4 * (tig >> 1)) = o;
}

// The row tile i and key step j of causal fragment f = i (i + 1) + j: row
// tile i (rows 16 i .. 16 i + 15) sees keys below 16 (i + 1), 2 (i + 1) key
// steps of 8
__device__ __forceinline__ void fragment_tile(int f, int& i, int& j) {
  i = 0;
  while ((i + 1) * (i + 2) <= f) ++i;
  j = f - i * (i + 1);
}

// Shared-memory plan (floats) of the tensor-core kernel for chunk length Q.
// Row strides keep a warp's fragment reads on 32 banks: LDB = 8 mod 32 for
// B read by column (the state's A operand), LDC = 4 mod 32 for C read by
// row, LDX = 8 mod 32 for x (every B operand).  C is read only to build
// C.B^T, before the second head's x lands and the first S is written: it
// lies over x's second stage and S (padded where they are shorter).
template <int Q_>
struct MmaPlan {
  static constexpr int Q = Q_, HD = 64, DS = 128;
  static constexpr int R = Q / 16;          // 16-row tiles of the chunk
  static constexpr int NF = R * (R + 1);    // causal 16x8 fragments
  static constexpr int NP = R / 2;          // pairs of row tiles (S.X)
  static constexpr int LDB = DS + 8, LDC = DS + 4, LDX = HD + 8;
  static constexpr int B_OFF = 0;
  static constexpr int CB_OFF = B_OFF + Q * LDB;     // C.B^T, A order
  static constexpr int V_OFF = CB_OFF + NF * 128;    // la, dt: 2 stages
  static constexpr int CUM_OFF = V_OFF + 4 * Q;
  static constexpr int W_OFF = CUM_OFF + Q;          // exp(total-cum) dt
  static constexpr int X_OFF = W_OFF + Q;            // x ring: 2 stages
  static constexpr int S_OFF = X_OFF + 2 * Q * LDX;  // one head's S
  static constexpr int C_OFF = X_OFF + Q * LDX;      // over stage 1 and S
  static constexpr int FLOATS = C_OFF + Q * LDC > S_OFF + NF * 128
                                    ? C_OFF + Q * LDC
                                    : S_OFF + NF * 128;
  static constexpr int BYTES = 4 * FLOATS;
  static_assert(Q == 32 || Q == 64 || Q == 128, "Q 32, 64 or 128");
  static_assert(BYTES <= MAX_SMEM, "shared memory");
};

// grid (B * NC * ceil(H / G)), block MMA_THREADS: block (b, n, g) computes
// heads g G .. min(g G + G, H) - 1 of chunk n.
template <int Q>
__global__ void __launch_bounds__(MMA_THREADS, 1) ssd_chunk_mma_kernel(
    const float* __restrict__ x, long long sxb, long long sxn, long long sxh,
    long long sxq, const float* __restrict__ bm, long long sbb, long long sbn,
    long long sbq, const float* __restrict__ cm, long long scb, long long scn,
    long long scq, const float* __restrict__ la, long long slb, long long sln,
    long long slh, long long slq, const float* __restrict__ dt, long long sdb,
    long long sdn, long long sdh, long long sdq, float* __restrict__ y,
    float* __restrict__ s, float* __restrict__ a, int NC, int H, int G) {
  using P = MmaPlan<Q>;
  constexpr int HD = P::HD, DS = P::DS, R = P::R, NF = P::NF, NP = P::NP;
  constexpr int LDB = P::LDB, LDC = P::LDC, LDX = P::LDX;
  extern __shared__ __align__(16) float smem[];
  float* sB = smem + P::B_OFF;
  float* sCB = smem + P::CB_OFF;
  float* sS = smem + P::S_OFF;
  float* sX = smem + P::X_OFF;
  float* sV = smem + P::V_OFF;
  float* sCum = smem + P::CUM_OFF;
  float* sW = smem + P::W_OFF;
  float* sC = smem + P::C_OFF;

  const int groups = (H + G - 1) / G;
  const long long bn = blockIdx.x / groups;          // b * NC + n
  const int h0 = (int)(blockIdx.x % groups) * G;
  const int nh = min(G, H - h0);
  const int n = (int)(bn % NC);
  const long long b = bn / NC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;

  // x (Q rows of hd), la and dt of head h0 + g into ring stage `stage`
  auto load_head = [&](int g, int stage) {
    const long long h = h0 + g;
    const float* xh = x + b * sxb + n * sxn + h * sxh;
    float* dx = sX + stage * Q * LDX;
    for (int i = tid; i < Q * (HD / 4); i += MMA_THREADS) {
      const int r = i / (HD / 4), c = 4 * (i % (HD / 4));
      cp_async16(dx + r * LDX + c, xh + r * sxq + c);
    }
    float* dv = sV + stage * 2 * Q;
    if (tid < Q)
      cp_async4(dv + tid, la + b * slb + n * sln + h * slh + tid * slq);
    else if (tid < 2 * Q)
      cp_async4(dv + tid, dt + b * sdb + n * sdn + h * sdh + (tid - Q) * sdq);
  };

  {
    const float* bb = bm + b * sbb + n * sbn;
    const float* cb = cm + b * scb + n * scn;
    for (int i = tid; i < Q * (DS / 4); i += MMA_THREADS) {
      const int r = i / (DS / 4), c = 4 * (i % (DS / 4));
      cp_async16(sB + r * LDB + c, bb + r * sbq + c);
      cp_async16(sC + r * LDC + c, cb + r * scq + c);
    }
    load_head(0, 0);        // stage 0: C lies over stage 1
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  // C.B^T over the causal fragments, fragment f by warp f % MMA_WARPS,
  // stored in the A-fragment order: lane l's four values at f 128 + 4 l
  for (int f = warp; f < NF; f += MMA_WARPS) {
    int i, j;
    fragment_tile(f, i, j);
    float big[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
    const float* cr = sC + (16 * i + gid) * LDC + tig;
    const float* br = sB + (8 * j + gid) * LDB + tig;
#pragma unroll 4
    for (int k0 = 0; k0 < DS; k0 += 8) {
      uint32_t ahi[4], alo[4], bh0, bh1, bl0, bl1;
      split(cr[k0], ahi[0], alo[0]);
      split(cr[k0 + 8 * LDC], ahi[1], alo[1]);
      split(cr[k0 + 4], ahi[2], alo[2]);
      split(cr[k0 + 8 * LDC + 4], ahi[3], alo[3]);
      split(br[k0], bh0, bl0);
      split(br[k0 + 4], bh1, bl1);
      mma3(big, small, ahi, alo, bh0, bh1, bl0, bl1);
    }
    // C element e at (gid + 8 (e / 2), 2 tig + e % 2) -> A order
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = gid + 8 * (e >> 1), c = 2 * tig + (e & 1);
      sCB[f * 128 + ((r & 7) * 4 + (c & 3)) * 4 + (r >> 3) + 2 * (c >> 2)] =
          big[e] + small[e];
    }
  }
  __syncthreads();          // C is read: stage 1 and S are free

  for (int g = 0; g < nh; ++g) {
    const int stage = g & 1;
    if (g + 1 < nh) {       // the next head's copies stay in flight
      load_head(g + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xs = sX + stage * Q * LDX;
    const float* las = sV + stage * 2 * Q;
    const float* dts = las + Q;
    const long long bh = bn * H + h0 + g;       // (b, n, h) in the outputs

    // cumsum(la), by warp 0: lane l sums its E consecutive entries in order,
    // then adds the totals of the lanes before it
    if (warp == 0) {
      constexpr int E = Q / 32;
      float part[E];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        run += las[lane * E + e];
        part[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += t;
      }
      float before = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) before = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) sCum[lane * E + e] = part[e] + before;
    }
    __syncthreads();
    const float total = sCum[Q - 1];
    if (tid < Q) sW[tid] = expf(total - sCum[tid]) * dts[tid];
    if (tid == 0) a[bh] = expf(total);
    // S = (C.B^T) exp(cum_q - cum_k) dt_k on the causal fragments, k > q
    // selected to 0 before any exponent
    for (int f = warp; f < NF; f += MMA_WARPS) {
      int i, j;
      fragment_tile(f, i, j);
      const float4 c4 = reinterpret_cast<const float4*>(sCB + f * 128)[lane];
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
      float sv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = 16 * i + gid + 8 * (e & 1);
        const int k = 8 * j + tig + 4 * (e >> 1);
        sv[e] = k <= q ? cv[e] * expf(sCum[q] - sCum[k]) * dts[k] : 0.f;
      }
      reinterpret_cast<float4*>(sS + f * 128)[lane] =
          make_float4(sv[0], sv[1], sv[2], sv[3]);
    }
    __syncthreads();

    // y_intra = S.X: warp w takes row tiles p and R - 1 - p (p = w % NP,
    // equal causal work) and the NP column tiles from NP (w / NP)
    {
      const int p = warp % NP, nb = NP * (warp / NP);
      float big[2][NP][4], small[2][NP][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int u = 0; u < NP; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) big[t][u][e] = small[t][u][e] = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int i = t == 0 ? p : R - 1 - p;
        for (int j = 0; j < 2 * (i + 1); ++j) {
          const float4 s4 =
              reinterpret_cast<const float4*>(sS + (i * (i + 1) + j) * 128)[lane];
          uint32_t ahi[4], alo[4];
          split(s4.x, ahi[0], alo[0]);
          split(s4.y, ahi[1], alo[1]);
          split(s4.z, ahi[2], alo[2]);
          split(s4.w, ahi[3], alo[3]);
          const float* xr = xs + (8 * j + tig) * LDX + 8 * nb + gid;
#pragma unroll
          for (int u = 0; u < NP; ++u) {
            uint32_t bh0, bh1, bl0, bl1;
            split(xr[8 * u], bh0, bl0);
            split(xr[4 * LDX + 8 * u], bh1, bl1);
            mma3(big[t][u], small[t][u], ahi, alo, bh0, bh1, bl0, bl1);
          }
        }
      }
      float* yo = y + bh * Q * HD;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int i = t == 0 ? p : R - 1 - p;
#pragma unroll
        for (int u = 0; u < NP; ++u)
          store_tile(yo + 16 * i * HD + 8 * (nb + u), HD, big[t][u],
                     small[t][u], lane);
      }
    }

    // s_c = (B w)^T.X: warp w takes state rows 32 (w / 2) .. + 31 (two row
    // tiles) and columns 32 (w % 2) .. + 31 (four column tiles)
    {
      const int rt = 2 * (warp >> 1), nb = 4 * (warp & 1);
      float big[2][4][4], small[2][4][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) big[t][u][e] = small[t][u][e] = 0.f;
#pragma unroll 2
      for (int k0 = 0; k0 < Q; k0 += 8) {
        const float w0 = sW[k0 + tig], w1 = sW[k0 + tig + 4];
        const float* b0 = sB + (k0 + tig) * LDB + 16 * rt + gid;
        const float* b1 = b0 + 4 * LDB;
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t) {     // A[i][q] = B[q][i] w_q
          split(b0[16 * t] * w0, ahi[t][0], alo[t][0]);
          split(b0[16 * t + 8] * w0, ahi[t][1], alo[t][1]);
          split(b1[16 * t] * w1, ahi[t][2], alo[t][2]);
          split(b1[16 * t + 8] * w1, ahi[t][3], alo[t][3]);
        }
        const float* xr = xs + (k0 + tig) * LDX + 8 * nb + gid;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          uint32_t bh0, bh1, bl0, bl1;
          split(xr[8 * u], bh0, bl0);
          split(xr[4 * LDX + 8 * u], bh1, bl1);
#pragma unroll
          for (int t = 0; t < 2; ++t)
            mma3(big[t][u], small[t][u], ahi[t], alo[t], bh0, bh1, bl0, bl1);
        }
      }
      float* so = s + bh * DS * HD;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          store_tile(so + 16 * (rt + t) * HD + 8 * (nb + u), HD, big[t][u],
                     small[t][u], lane);
    }
    __syncthreads();        // sS, sCum, sW and this stage are refilled next
  }
}

template <int Q>
cudaError_t allow_mma_smem() {
  return cudaFuncSetAttribute(ssd_chunk_mma_kernel<Q>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              MmaPlan<Q>::BYTES);
}

template <int Q>
int launch_mma(const void* x, const long long* sx, const void* bm,
               const long long* sb, const void* cm, const long long* sc,
               const void* la, const long long* sl, const void* dt,
               const long long* sd, void* y, void* s, void* a, int B, int NC,
               int H, int G, cudaStream_t stream) {
  if (const cudaError_t err = allow_mma_smem<Q>()) return (int)err;
  const long long blocks = (long long)B * NC * ((H + G - 1) / G);
  ssd_chunk_mma_kernel<Q><<<(unsigned)blocks, MMA_THREADS,
                            MmaPlan<Q>::BYTES, stream>>>(
      static_cast<const float*>(x), sx[0], sx[1], sx[2], sx[3],
      static_cast<const float*>(bm), sb[0], sb[1], sb[2],
      static_cast<const float*>(cm), sc[0], sc[1], sc[2],
      static_cast<const float*>(la), sl[0], sl[1], sl[2], sl[3],
      static_cast<const float*>(dt), sd[0], sd[1], sd[2], sd[3],
      static_cast<float*>(y), static_cast<float*>(s), static_cast<float*>(a),
      NC, H, G);
  return (int)cudaGetLastError();
}

// registers, local memory per thread (spills and stack; 0 when nothing
// spills), static and dynamic shared memory per block, resident blocks per
// SM and threads per block of one instantiation
template <typename K>
int kernel_info(K kern, int threads, int smem, int* info) {
  cudaFuncAttributes attr;
  if (const cudaError_t err = cudaFuncGetAttributes(&attr, kern))
    return (int)err;
  int blocks = 0;
  if (const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kern, threads, smem))
    return (int)err;
  const int vals[6] = {attr.numRegs, (int)attr.localSizeBytes,
                       (int)attr.sharedSizeBytes, smem, blocks, threads};
  for (int i = 0; i < 6; ++i) info[i] = vals[i];
  return 0;
}

template <int Q>
int mma_info(int* info) {
  if (const cudaError_t err = allow_mma_smem<Q>()) return (int)err;
  return kernel_info(ssd_chunk_mma_kernel<Q>, MMA_THREADS, MmaPlan<Q>::BYTES,
                     info);
}

template <int UV>
int cores_info(int Q, int hd, int ds, int* info) {
  const int smem = (int)cores_smem(Q, hd, ds);
  if (smem > 48 * 1024) {
    if (const cudaError_t err = cudaFuncSetAttribute(
            ssd_chunk_kernel<UV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem))
      return (int)err;
  }
  return kernel_info(ssd_chunk_kernel<UV>, THREADS, smem, info);
}

bool shape_ok(int B, int NC, int H, int Q, int hd, int ds) {
  return B >= 1 && NC >= 1 && H >= 1 && Q >= 1 && Q <= MAX_Q && ds >= 1 &&
         ds <= MAX_DS && hd >= 1 && hd <= MAX_HD;
}

}  // namespace

// Strides are in elements: x and la/dt (b, n, h, q), bm and cm (b, n, q).
// Both entries take one signature; G (heads per block) serves the
// tensor-core route.
#define SSD_CHUNK_ARGS                                                        \
  const void *x, long long sxb, long long sxn, long long sxh, long long sxq,  \
      const void *bm, long long sbb, long long sbn, long long sbq,            \
      const void *cm, long long scb, long long scn, long long scq,            \
      const void *la, long long slb, long long sln, long long slh,            \
      long long slq, const void *dt, long long sdb, long long sdn,            \
      long long sdh, long long sdq, void *y, void *s, void *a, int B, int NC, \
      int H, int Q, int hd, int ds, int G, void *stream

// CUDA cores: any Q <= 128, ds <= 128, hd <= 128
extern "C" int ssd_chunk_f32(SSD_CHUNK_ARGS) {
  if (!shape_ok(B, NC, H, Q, hd, ds)) return (int)cudaErrorInvalidValue;
  const long long sx[4] = {sxb, sxn, sxh, sxq};
  const long long sb[3] = {sbb, sbn, sbq};
  const long long sc[3] = {scb, scn, scq};
  const long long sl[4] = {slb, sln, slh, slq};
  const long long sd[4] = {sdb, sdn, sdh, sdq};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 32)
    return launch_cores<1>(x, sx, bm, sb, cm, sc, la, sl, dt, sd, y, s, a, B,
                           NC, H, Q, hd, ds, st);
  if (hd <= 64)
    return launch_cores<2>(x, sx, bm, sb, cm, sc, la, sl, dt, sd, y, s, a, B,
                           NC, H, Q, hd, ds, st);
  return launch_cores<4>(x, sx, bm, sb, cm, sc, la, sl, dt, sd, y, s, a, B,
                         NC, H, Q, hd, ds, st);
}

// Tensor cores: Q 32, 64 or 128, hd 64, ds 128, 1 <= G <= H; x, bm and cm
// 16-byte aligned with strides of whole 16-byte vectors (copied 16 bytes a
// thread)
extern "C" int ssd_chunk_mma_f32(SSD_CHUNK_ARGS) {
  const uintptr_t vec = reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(bm) |
                        reinterpret_cast<uintptr_t>(cm);
  const long long rows = sxb | sxn | sxh | sxq | sbb | sbn | sbq | scb | scn |
                         scq;
  if (!shape_ok(B, NC, H, Q, hd, ds) || hd != 64 || ds != 128 || G < 1 ||
      G > H || (vec & 15) != 0 || (rows & 3) != 0)
    return (int)cudaErrorInvalidValue;
  const long long sx[4] = {sxb, sxn, sxh, sxq};
  const long long sb[3] = {sbb, sbn, sbq};
  const long long sc[3] = {scb, scn, scq};
  const long long sl[4] = {slb, sln, slh, slq};
  const long long sd[4] = {sdb, sdn, sdh, sdq};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Q) {
    case 32:
      return launch_mma<32>(x, sx, bm, sb, cm, sc, la, sl, dt, sd, y, s, a, B,
                            NC, H, G, st);
    case 64:
      return launch_mma<64>(x, sx, bm, sb, cm, sc, la, sl, dt, sd, y, s, a, B,
                            NC, H, G, st);
    case 128:
      return launch_mma<128>(x, sx, bm, sb, cm, sc, la, sl, dt, sd, y, s, a,
                             B, NC, H, G, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// What the card says of one instantiation (6 ints, see kernel_info): route
// 0 the tensor-core kernel for chunk length q (hd 64, ds 128), route 1 the
// CUDA-core kernel for (q, hd, ds), whose shared memory grows with them.
extern "C" int ssd_chunk_info(int route, int q, int hd, int ds, int* info) {
  if (route == 0) {
    if (q == 32) return mma_info<32>(info);
    if (q == 64) return mma_info<64>(info);
    if (q == 128) return mma_info<128>(info);
    return (int)cudaErrorInvalidValue;
  }
  if (route != 1 || !shape_ok(1, 1, 1, q, hd, ds))
    return (int)cudaErrorInvalidValue;
  if (hd <= 32) return cores_info<1>(q, hd, ds, info);
  if (hd <= 64) return cores_info<2>(q, hd, ds, info);
  return cores_info<4>(q, hd, ds, info);
}
