// Determinant calculus shared by the Slater value/gradient/Hessian kernels
// (slater_vgh.cu: static occupations; slater_vgh_ms.cu: per-walker ones).
//
// With A = D^{-1}, B[a][i][k] = sum_j D1a[i][j] A[j][k] and
// C[i][a][b] = sum_j A[j][i] D2ab[i][j]:
//   y = 2 log|det D|, g_(i,a) = 2 B[a][i][i],
//   H_(i,a),(k,b) = 2 (delta_ik C[i][a][b] - B[b][k][i] B[a][i][k]).
// Every Slater entry is a product of 1D factors, D[i][j] = v(i,0,j) v(i,1,j),
// and its derivatives replace one factor by its first or second derivative.
#pragma once

#include "common.cuh"

namespace {

constexpr float kPref4 = 0.75112554446494251f;  // pi^{-1/4}
constexpr int BW = 32;                           // walkers per block

// F supplies, for row (particle) i, axis a and column (orbital) j:
//   f.v(i, a, j), f.d1(i, a, j), f.d2(i, a, j): psi, psi', psi'' of column
//   j's 1D orbital along axis a at particle i's coordinate;
//   f.same(i, j): row i and column j lie in one spin sector.
// A and Bm are shared-memory scratch whose column t belongs to this thread.
// Outputs are written for walker w of a batch of Bs, scaled by `two` (2, or
// NaN to mark a walker whose inputs the kernel could not take).  The
// Gauss-Jordan runs in registers (N x 2N, fully unrolled, swap-free
// pivoting resolved by selects, as the TPU kernel's _gj_inverse); H is
// written in packed np.triu_indices order.
template <int N, class F>
__device__ __forceinline__ void vgh_from_factors(
    const F& f, float (&A)[N][N][BW], float (&Bm)[2][N][N][BW], int t, int w,
    size_t Bs, float two, float* __restrict__ y_out, float* __restrict__ g_out,
    float* __restrict__ h_out) {
  constexpr int D = 2 * N;

  // Gauss-Jordan on [D | I] in registers.
  float M[N][2 * N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      M[i][j] = f.same(i, j) ? f.v(i, 0, j) * f.v(i, 1, j) : 0.f;
      M[i][N + j] = (i == j) ? 1.f : 0.f;
    }
  }
  bool used[N];
  int piv[N];
#pragma unroll
  for (int i = 0; i < N; ++i) used[i] = false;
  float logabs = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float best = -2.f;
    int bi = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float cand = used[i] ? -1.f : fabsf(M[i][k]);
      if (cand > best) { best = cand; bi = i; }
    }
    piv[k] = bi;
    float pv = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) pv = (bi == i) ? M[i][k] : pv;
    logabs += logf(fmaxf(fabsf(pv), 1e-30f));
    const float inv_p = 1.f / (fabsf(pv) > 1e-30f ? pv : 1.f);
    float prow[2 * N];
#pragma unroll
    for (int j = 0; j < 2 * N; ++j) prow[j] = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = k; j < 2 * N; ++j) prow[j] = (bi == i) ? M[i][j] : prow[j];
    }
#pragma unroll
    for (int j = k; j < 2 * N; ++j) prow[j] *= inv_p;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const bool isp = (bi == i);
      const float mult = isp ? 0.f : M[i][k];
#pragma unroll
      for (int j = k + 1; j < 2 * N; ++j) M[i][j] = isp ? prow[j] : M[i][j] - mult * prow[j];
      M[i][k] = isp ? 1.f : 0.f;
      used[i] = used[i] || isp;
    }
  }
  // Row piv[k] of the right half is row k of the inverse.
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) v = (piv[k] == i) ? M[i][N + j] : v;
      A[k][j][t] = v;
    }
  }

  // B[a][i][k] = sum_j D1a[i][j] A[j][k]; g = 2 B[a][i][i].
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float d1x[N], d1y[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const bool s = f.same(i, j);
      d1x[j] = s ? f.d1(i, 0, j) * f.v(i, 1, j) : 0.f;
      d1y[j] = s ? f.v(i, 0, j) * f.d1(i, 1, j) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float bx = 0.f, by = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float ajk = A[j][k][t];
        bx += d1x[j] * ajk;
        by += d1y[j] * ajk;
      }
      Bm[0][i][k][t] = bx;
      Bm[1][i][k][t] = by;
    }
    g_out[(2 * i) * Bs + w] = two * Bm[0][i][i][t];
    g_out[(2 * i + 1) * Bs + w] = two * Bm[1][i][i][t];
  }
  y_out[w] = two * logabs;

  // Packed H rows: p = 2i+a <= q = 2k+b.
  int row = 0;
#pragma unroll
  for (int p = 0; p < D; ++p) {
    const int i = p / 2, a = p % 2;
    // C[i][a][b] for b = 0, 1 (only needed on the diagonal particle block).
    float c_ab[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (!f.same(i, j)) continue;
      const float aji = A[j][i][t];
      const float xx = f.d2(i, 0, j) * f.v(i, 1, j);
      const float yy = f.v(i, 0, j) * f.d2(i, 1, j);
      const float xy = f.d1(i, 0, j) * f.d1(i, 1, j);
      c_ab[0] += aji * (a == 0 ? xx : xy);
      c_ab[1] += aji * (a == 0 ? xy : yy);
    }
#pragma unroll
    for (int q = p; q < D; ++q) {
      const int k = q / 2, b = q % 2;
      float v = -Bm[b][k][i][t] * Bm[a][i][k][t];
      if (i == k) v += c_ab[b];
      h_out[(size_t)row * Bs + w] = two * v;
      ++row;
    }
  }
}

}  // namespace
