// Determinant calculus shared by the Slater value/gradient/Hessian kernels
// (slater_vgh.cu: static occupations; slater_vgh_ms.cu: per-walker ones).
//
// With A = D^{-1}, B[a][i][k] = sum_j D1a[i][j] A[j][k] and
// C[i][a][b] = sum_j A[j][i] D2ab[i][j]:
//   y = 2 log|det D|, g_(i,a) = 2 B[a][i][i],
//   H_(i,a),(k,b) = 2 (delta_ik C[i][a][b] - B[b][k][i] B[a][i][k]).
// Every Slater entry is a product of 1D factors, D[i][j] = v(i,0,j) v(i,1,j),
// and its derivatives replace one factor by its first or second derivative.
//
// A group of G = kVghLanes lanes of one warp works on one walker; a block
// holds kVghWalkers = 32 walkers.  Lane l owns the Slater rows (particles)
// l, l + G, ... (slot s holds row l + s G): their coordinates, 1D factors,
// rows of the Gauss-Jordan and of B, and C.  A lane whose slot lies past
// the last row computes on a copy of row N - 1 and stores nothing.  Each
// dot product runs on one lane in one thread's j order, so the arithmetic
// is that of one thread doing the whole walker.  Per walker, A, B and C
// live in shared memory (an odd stride of floats per walker); y, g and the
// packed H go to a staging area [row][walker] from which the block writes
// each output row as 32 contiguous floats.  Every lane of the warp runs
// every shuffle and ballot (full mask, width G), and every thread of the
// block reaches the barrier before the store: ragged batches clamp the
// walker index instead of returning early.
#pragma once

#include "common.cuh"

namespace {

constexpr float kPref4 = 0.75112554446494251f;  // pi^{-1/4}
constexpr unsigned kVghMask = 0xffffffffu;
// Lanes per walker (ops/slater_vgh.py: LANES).  Tests build the sources at
// 4 as well, where every output must come out bitwise the same.
#ifndef FF_VGH_LANES
#define FF_VGH_LANES 8
#endif
constexpr int kVghLanes = FF_VGH_LANES;
constexpr int kVghWalkers = 32;  // walkers per block
constexpr int kVghThreads = kVghWalkers * kVghLanes;
// Resident blocks per SM the kernels are built for: 16 warps, <= 128
// registers.  Without it ptxas spilled around the division's slow path.
constexpr int kVghMinBlocks = 512 / kVghThreads;
// Staging row stride: with 8 lanes per walker, the 32 lanes of a warp
// writing H entries r G + l of walkers 4w..4w+3 hit 32 distinct banks.
constexpr int kStageStride = kVghWalkers + 4;

// Blocks of a VGH grid over B walkers, and the warps they hold.
inline int vgh_blocks(int B) { return (B + kVghWalkers - 1) / kVghWalkers; }
inline int vgh_grid_warps(int B) { return vgh_blocks(B) * (kVghThreads / 32); }

template <int N, int G>
struct VghPlan {
  static_assert(32 % G == 0, "a lane group divides a warp");
  static constexpr int S = (N + G - 1) / G;   // row slots per lane
  static constexpr int D = 2 * N;
  static constexpr int NUT = D * (D + 1) / 2;  // packed H entries
  static constexpr int ROWS = 1 + D + NUT;     // output rows: y, g, H
  // Per-walker scratch: A [k][j], B [a][i][k], C [i][xx, xy, yy].
  static constexpr int A0 = 0, B0 = N * N, C0 = 3 * N * N;
  static constexpr int WS = (3 * N * N + 3 * N) | 1;
  static constexpr size_t smem_bytes =
      sizeof(float) * (kVghWalkers * WS + ROWS * kStageStride);
};

// psi, psi', psi'' of the normalized 1D oscillator orders 0..K-1 at c, from
// the Hermite ladder of depth K + 1: psi_m' = sqrt(m/2) psi_{m-1} -
// sqrt((m+1)/2) psi_{m+1}, psi_m'' = (c^2 - 2m - 1) psi_m.
template <int K>
__device__ __forceinline__ void ho_factors(float c, float (&psi)[K], float (&dpsi)[K],
                                           float (&d2psi)[K]) {
  float h[K + 1];
  hermite<K + 1>(c, h);
  const float g = kPref4 * expf(-0.5f * c * c);
#pragma unroll
  for (int m = 0; m < K; ++m) {
    psi[m] = g * h[m];
    float dm = -sqrtf((m + 1) / 2.f) * g * h[m + 1];
    if (m > 0) dm += sqrtf(m / 2.f) * g * h[m - 1];
    dpsi[m] = dm;
    d2psi[m] = (c * c - (float)(2 * m + 1)) * g * h[m];
  }
}

// The lane's row in slot s, clamped to a real one.
template <int N, int G>
__device__ __forceinline__ int vgh_row(int lane, int s) {
  return min(lane + s * G, N - 1);
}

// One walker's y, g and packed H from its rows' 1D factors.  fv, f1, f2
// hold, for the lane's slot s, column j and axis a, psi, psi' and psi'' of
// column j's orbital along axis a at the row's coordinate.  Rows and
// columns [0, nup) form one spin sector, the rest the other; entries across
// sectors are zero.  ws is the walker's scratch, st its staging column
// (row r at st[r * kStageStride]); outputs are scaled by `two` (2, or NaN
// to mark a walker whose inputs the kernel could not take).  The
// Gauss-Jordan inverts [D | I] without row swaps, the pivot of column k
// being the first unused row with the largest |entry| (floored at 1e-30),
// as the TPU kernel's _gj_inverse.
template <int N, int G>
__device__ __forceinline__ void vgh_group(
    const float (&fv)[VghPlan<N, G>::S][N][2], const float (&f1)[VghPlan<N, G>::S][N][2],
    const float (&f2)[VghPlan<N, G>::S][N][2], int nup, int lane, float* __restrict__ ws,
    float* __restrict__ st, float two) {
  using P = VghPlan<N, G>;
  constexpr int S = P::S;
  constexpr unsigned group_bits = G == 32 ? kVghMask : (1u << G) - 1u;
  const int base = (int)(threadIdx.x & 31) & ~(G - 1);
  int row[S];
  bool real[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    real[s] = lane + s * G < N;
    row[s] = vgh_row<N, G>(lane, s);
  }
  auto same = [&](int s, int j) { return (row[s] < nup) == (j < nup); };

  // Gauss-Jordan on the group's rows of [D | I].
  float M[S][2 * N];
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      M[s][j] = same(s, j) ? fv[s][j][0] * fv[s][j][1] : 0.f;
      M[s][N + j] = (row[s] == j) ? 1.f : 0.f;
    }
  }
  bool used[S];
  int pk[S];  // the column whose pivot the slot's row became
#pragma unroll
  for (int s = 0; s < S; ++s) {
    used[s] = false;
    pk[s] = 0;
  }
  float logabs = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    // Each lane offers its first unused row with the largest |entry| (used
    // rows offer -1, absent ones nothing); an xor-shuffle max gives the
    // value, a ballot per slot the first lane, lowest slot first: the first
    // such row in row order.
    float best = -2.f;
    int bs = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float cand = !real[s] ? -3.f : used[s] ? -1.f : fabsf(M[s][k]);
      if (cand > best) { best = cand; bs = s; }
    }
    float m = best;
#pragma unroll
    for (int o = 1; o < G; o <<= 1) m = fmaxf(m, __shfl_xor_sync(kVghMask, m, o, G));
    int pl = 0, ps = 0;
    bool found = false;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const unsigned tie =
          (__ballot_sync(kVghMask, best == m && bs == s) >> base) & group_bits;
      pl = (!found && tie) ? __ffs(tie) - 1 : pl;
      ps = (!found && tie) ? s : ps;
      found = found || tie;
    }
    float prow[2 * N];
#pragma unroll
    for (int j = k; j < 2 * N; ++j) {
      float v = M[0][j];
#pragma unroll
      for (int s = 1; s < S; ++s) v = (ps == s) ? M[s][j] : v;
      prow[j] = __shfl_sync(kVghMask, v, pl, G);
    }
    const float pv = prow[k];
    logabs += logf(fmaxf(fabsf(pv), 1e-30f));
    const float inv_p = 1.f / (fabsf(pv) > 1e-30f ? pv : 1.f);
#pragma unroll
    for (int j = k; j < 2 * N; ++j) prow[j] *= inv_p;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool isp = lane == pl && s == ps;
      const float mult = isp ? 0.f : M[s][k];
#pragma unroll
      for (int j = k + 1; j < 2 * N; ++j) M[s][j] = isp ? prow[j] : M[s][j] - mult * prow[j];
      pk[s] = isp ? k : pk[s];
      used[s] = used[s] || isp;
    }
  }
  // The right half of the row that pivoted column k is row k of A.
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (real[s]) {
#pragma unroll
      for (int j = 0; j < N; ++j) ws[P::A0 + pk[s] * N + j] = M[s][N + j];
    }
  }
  if (lane == 0) st[0] = two * logabs;
  __syncwarp();

  // The lane's rows of B, g, and C.
#pragma unroll
  for (int s = 0; s < S; ++s) {
    float d1x[N], d1y[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const bool sm = same(s, j);
      d1x[j] = sm ? f1[s][j][0] * fv[s][j][1] : 0.f;
      d1y[j] = sm ? fv[s][j][0] * f1[s][j][1] : 0.f;
    }
    float gx = 0.f, gy = 0.f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float bx = 0.f, by = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float ajk = ws[P::A0 + j * N + k];
        bx += d1x[j] * ajk;
        by += d1y[j] * ajk;
      }
      if (real[s]) {
        ws[P::B0 + row[s] * N + k] = bx;
        ws[P::B0 + (N + row[s]) * N + k] = by;
      }
      gx = (k == row[s]) ? bx : gx;
      gy = (k == row[s]) ? by : gy;
    }
    float cxx = 0.f, cxy = 0.f, cyy = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (!same(s, j)) continue;
      const float aji = ws[P::A0 + j * N + row[s]];
      const float xx = f2[s][j][0] * fv[s][j][1];
      const float yy = fv[s][j][0] * f2[s][j][1];
      const float xy = f1[s][j][0] * f1[s][j][1];
      cxx += aji * xx;
      cxy += aji * xy;
      cyy += aji * yy;
    }
    if (real[s]) {
      st[(1 + 2 * row[s]) * kStageStride] = two * gx;
      st[(2 + 2 * row[s]) * kStageStride] = two * gy;
      ws[P::C0 + 3 * row[s]] = cxx;
      ws[P::C0 + 3 * row[s] + 1] = cxy;
      ws[P::C0 + 3 * row[s] + 2] = cyy;
    }
  }
  __syncwarp();

  // Packed H entries e = r G + lane: row p = 2i + a <= column q = 2k + b
  // (np.triu_indices order).
#pragma unroll
  for (int r = 0; r < (P::NUT + G - 1) / G; ++r) {
    const int e = r * G + lane;
    if (e < P::NUT) {
      int p = 0;
#pragma unroll
      for (int t = 1; t < P::D; ++t) p += e >= ut_index(t, t, P::D) ? 1 : 0;
      const int q = e - ut_index(p, p, P::D) + p;
      const int i = p >> 1, a = p & 1, k = q >> 1, b = q & 1;
      const float bki = ws[P::B0 + (b * N + k) * N + i];
      const float bik = ws[P::B0 + (a * N + i) * N + k];
      const float c = (i == k) ? ws[P::C0 + 3 * i + a + b] : 0.f;
      st[(1 + P::D + e) * kStageStride] = two * fmaf(-bki, bik, c);
    }
  }
}

// The block's staged outputs, each row written as 32 contiguous floats:
// y (B,), g (d, B), h (d(d+1)/2, B).  Every thread of the block calls it.
template <int N, int G>
__device__ __forceinline__ void vgh_store_block(const float* __restrict__ stage, int B,
                                                float* __restrict__ y_out,
                                                float* __restrict__ g_out,
                                                float* __restrict__ h_out) {
  using P = VghPlan<N, G>;
  __syncthreads();
  const size_t Bs = (size_t)B;
  const int w0 = blockIdx.x * kVghWalkers;
  for (int idx = threadIdx.x; idx < P::ROWS * kVghWalkers; idx += kVghThreads) {
    const int r = idx / kVghWalkers, wl = idx % kVghWalkers, w = w0 + wl;
    if (w < B) {
      float* dst = r == 0 ? y_out
                   : r <= P::D ? g_out + (size_t)(r - 1) * Bs
                               : h_out + (size_t)(r - 1 - P::D) * Bs;
      dst[w] = stage[r * kStageStride + wl];
    }
  }
}

}  // namespace
