// SSD intra-chunk kernel (Mamba2) for Hopper (sm_90a).
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
// What bounds it on an H100: at mamba2-130m's shape (Q 64, hd 64, ds 128)
// the function needs ~20 fp32 operations per byte it must move, the card's
// own balance (67 TFLOP/s on the CUDA cores over 3.35 TB/s), so a kernel at
// its limit is bound by both about equally.  The chunk state s_c alone is
// half of the bytes (written) and more than half of the operations.  What
// the design does:
//   * one block per (batch, chunk, head), 256 threads; the chunk's B and x
//     stay in shared memory for all three products (B with an odd row
//     stride, so a warp reading one column of 32 rows hits 32 banks);
//   * the (Q, Q) score matrix is built RT = 32 rows at a time beside the
//     same rows of C, so the working set is ~75 KB at Q 64 and ~133 KB at
//     Q = ds = 128 (dynamic shared memory) instead of ~224 KB whole;
//   * C.B^T does not depend on the head; like the Pallas kernel, each block
//     recomputes it for its own head (about a third of the kernel's
//     operations at the live shape); sharing it across a chunk's heads is
//     later work;
//   * every product accumulates a register tile per thread (rows by warp,
//     columns by lane), so each shared-memory read feeds several FMAs;
//   * the cumsum is one warp's scan: a serial sum per lane, then shuffles.
// All fp32 on the CUDA cores: TF32 tensor cores would not hold the
// reference's fp32 tolerance.  `wgmma` and TMA are later work.
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

template <int UV>
int launch(const void* x, const long long* sx, const void* bm,
           const long long* sb, const void* cm, const long long* sc,
           const void* la, const long long* sl, const void* dt,
           const long long* sd, void* y, void* s, void* a, int B, int NC,
           int H, int Q, int hd, int ds, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)Q * (ds | 1) + (size_t)Q * hd +
                       (size_t)RT * ds + (size_t)RT * Q + 3 * (size_t)Q);
  auto kern = ssd_chunk_kernel<UV>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)B * NC * H;
  kern<<<(unsigned)blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), sx[0], sx[1], sx[2], sx[3],
      static_cast<const float*>(bm), sb[0], sb[1], sb[2],
      static_cast<const float*>(cm), sc[0], sc[1], sc[2],
      static_cast<const float*>(la), sl[0], sl[1], sl[2], sl[3],
      static_cast<const float*>(dt), sd[0], sd[1], sd[2], sd[3],
      static_cast<float*>(y), static_cast<float*>(s), static_cast<float*>(a),
      NC, H, Q, hd, ds);
  return (int)cudaGetLastError();
}

}  // namespace

// Strides are in elements: x and la/dt (b, n, h, q), bm and cm (b, n, q).
extern "C" int ssd_chunk_f32(
    const void* x, long long sxb, long long sxn, long long sxh, long long sxq,
    const void* bm, long long sbb, long long sbn, long long sbq,
    const void* cm, long long scb, long long scn, long long scq,
    const void* la, long long slb, long long sln, long long slh, long long slq,
    const void* dt, long long sdb, long long sdn, long long sdh, long long sdq,
    void* y, void* s, void* a, int B, int NC, int H, int Q, int hd, int ds,
    void* stream) {
  if (B < 1 || NC < 1 || H < 1 || Q < 1 || Q > MAX_Q || ds < 1 ||
      ds > MAX_DS || hd < 1 || hd > MAX_HD)
    return (int)cudaErrorInvalidValue;
  const long long sx[4] = {sxb, sxn, sxh, sxq};
  const long long sb[3] = {sbb, sbn, sbq};
  const long long sc[3] = {scb, scn, scq};
  const long long sl[4] = {slb, sln, slh, slq};
  const long long sd[4] = {sdb, sdn, sdh, sdq};
  if (hd <= 32)
    return launch<1>(x, sx, bm, sb, cm, sc, la, sl, dt, sd, y, s, a, B, NC, H,
                     Q, hd, ds, stream);
  if (hd <= 64)
    return launch<2>(x, sx, bm, sb, cm, sc, la, sl, dt, sd, y, s, a, B, NC, H,
                     Q, hd, ds, stream);
  return launch<4>(x, sx, bm, sb, cm, sc, la, sl, dt, sd, y, s, a, B, NC, H, Q,
                   hd, ds, stream);
}
