// Pieces shared by the two split-key (flash-decoding) attention kernels,
// the paged decode (paged_attn.cu) and the dense decode route of the
// selective attention (selective_attn.cu): 16-byte vectors as floats, the
// fp32 workspace of per-split partials, and the kernel that merges them.
//
// A split-key kernel cuts each row's keys into chunks of CHUNK keys and
// writes one partial (m, l, acc[Dh]) per (row, split) in log2 units; an
// empty split writes (NEG_INF, 0, 0).  The merge rescales each partial by
// exp2(m_s - m_max), divides by the merged l and rounds once; a row whose
// splits are all empty merges to exp2(0) * 0 = 0 (a true -inf would give
// exp(-inf + inf) = NaN).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int CHUNK = 256;  // keys per split (kernels/paged_attn/ops.py)
constexpr int MERGE_THREADS = 128;

// How 16 bytes of a type become floats.
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ static void to_f(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void to_f(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
// int8: 0x4B000000 | (b ^ 0x80) is the float 2^23 + b + 128, exactly, so
// subtracting 2^23 + 128 leaves the signed byte b: a byte permute and an
// add per value instead of a quarter-rate integer-to-float conversion.
template <>
struct Pack<int8_t> {
  static constexpr int N = 16;
  __device__ static void to_f(const uint4& u, float* f) {
    const unsigned w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u,
                           u.z ^ 0x80808080u, u.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[4 * i + j] =
            __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7650 + j)) -
            8388736.f;
  }
};

// `E` values of type T at `p` (16-byte aligned) as floats.
template <typename T, int E>
__device__ __forceinline__ void load_f(const T* p, float (&f)[E]) {
  static_assert(E % Pack<T>::N == 0, "a lane's slice is whole 16-byte words");
#pragma unroll
  for (int i = 0; i < E / Pack<T>::N; ++i)
    Pack<T>::to_f(__ldg(reinterpret_cast<const uint4*>(p) + i),
                  f + i * Pack<T>::N);
}

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

// partial (m, l, acc) of one (row, split) in the workspace; rows are
// (b, query head) of the paged decode and (b, query, query head) of the
// dense one, numbered b * Hq + hq with b running over the leading dims
struct Workspace {
  float* acc;  // (B, Hq, S, DH)
  float* ml;   // (B, Hq, S, 2)
  __device__ size_t row(int b, int hq, int Hq, int n_splits, int s) const {
    return ((size_t)b * Hq + hq) * n_splits + s;
  }
};

__device__ __forceinline__ Workspace workspace(float* ws, int B, int Hq,
                                               int n_splits, int dh) {
  return {ws, ws + (size_t)B * Hq * n_splits * dh};
}

// The end of a split block of NW warps (every thread calls it).  Lane
// li + LPR * rg of a warp holds values [li * E, li * E + E) of its row
// group rg's (m, l, acc) for each of GT rows: merge a warp's row groups by
// shuffles, then the warps through shared memory, and write one partial
// per row g < n to workspace row row_of(g).
template <int DH, int GT, int E, int LPR, int NW, typename RowOf>
__device__ __forceinline__ void store_partials(const Workspace& w,
                                               float (&acc)[GT][E],
                                               float (&m)[GT], float (&l)[GT],
                                               int n, const RowOf& row_of) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int li = lane % LPR, rg = lane / LPR;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    float mw = m[g];
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1)
      mw = fmaxf(mw, __shfl_xor_sync(FULL, mw, o));
    const float f = exp2f(m[g] - mw);
    l[g] *= f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] *= f;
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) {
      l[g] += __shfl_xor_sync(FULL, l[g], o);
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[g][e] += __shfl_xor_sync(FULL, acc[g][e], o);
    }
    m[g] = mw;
  }

  __shared__ float acc_s[NW][GT][DH];
  __shared__ float m_s[NW][GT], l_s[NW][GT];
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
#pragma unroll
      for (int e = 0; e < E; ++e) acc_s[warp][g][li * E + e] = acc[g][e];
      if (li == 0) {
        m_s[warp][g] = m[g];
        l_s[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < n * DH; i += NW * 32) {
    const int g = i / DH, d = i % DH;
    float mx = NEG_INF;
#pragma unroll
    for (int v = 0; v < NW; ++v) mx = fmaxf(mx, m_s[v][g]);
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int v = 0; v < NW; ++v) {
      const float f = exp2f(m_s[v][g] - mx);
      a = fmaf(acc_s[v][g][d], f, a);
      lsum = fmaf(l_s[v][g], f, lsum);
    }
    const size_t r = row_of(g);
    w.acc[r * DH + d] = a;
    if (d == 0) {
      w.ml[2 * r] = mx;
      w.ml[2 * r + 1] = lsum;
    }
  }
}

// grid ceil(B * Hq / warps), block MERGE_THREADS: one warp per row, lanes
// over the head dim.  With `lse` (else nullptr) lane 0 also writes the
// row's log-sum-exp of its kept scaled logits, natural log (the partials
// hold log2 maxima), -inf for a row with no kept key.
template <typename T, int DH>
__global__ void __launch_bounds__(MERGE_THREADS) split_merge_kernel(
    float* __restrict__ ws, T* __restrict__ out, float* __restrict__ lse,
    int B, int Hq, int n_splits) {
  constexpr int PER = DH / 32;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (MERGE_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= B * Hq) return;
  const Workspace w = workspace(ws, B, Hq, n_splits, DH);
  const float* ml = w.ml + (size_t)row * n_splits * 2;
  const float* acc = w.acc + (size_t)row * n_splits * DH;
  float mx = NEG_INF;
  for (int s = lane; s < n_splits; s += 32) mx = fmaxf(mx, ml[2 * s]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
  float o_[PER] = {}, lsum = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float f = exp2f(ml[2 * s] - mx);
    lsum = fmaf(ml[2 * s + 1], f, lsum);
#pragma unroll
    for (int i = 0; i < PER; ++i)
      o_[i] = fmaf(acc[(size_t)s * DH + lane + 32 * i], f, o_[i]);
  }
#pragma unroll
  for (int i = 0; i < PER; ++i)
    out[(size_t)row * DH + lane + 32 * i] =
        from_f<T>(lsum == 0.f ? 0.f : o_[i] / lsum);
  if (lse != nullptr && lane == 0)
    lse[row] = lsum == 0.f ? __int_as_float(0xff800000)
                           : (mx + log2f(lsum)) * 0.6931471805599453f;
}

// The merge on `stream` for B * Hq rows of head dim DH (and their
// log-sum-exp into `lse`, when given).
template <typename T, int DH>
int launch_merge(float* ws, T* out, int B, int Hq, int n_splits,
                 cudaStream_t stream, float* lse = nullptr) {
  const int warps = MERGE_THREADS / 32;
  split_merge_kernel<T, DH><<<(B * Hq + warps - 1) / warps, MERGE_THREADS, 0,
                              stream>>>(ws, out, lse, B, Hq, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace
