// Slater base log-density with its gradient and packed Hessian.
//
// Replaces: fermiflow_tpu/ops/pallas_slater_vgh.py
//   slater_vgh_pallas (kernel _slater_vgh_kernel).
//
// Computes per walker y = 2 sum_sectors log|det D|, g = grad y and
// H = grad^2 y (upper triangle in np.triu_indices order) by determinant
// calculus: with A = D^{-1}, B[a][i][k] = sum_j D1a[i][j] A[j][k] and
// C[i][a][b] = sum_j A[j][i] D2ab[i][j],
//   g_(i,a) = 2 B[a][i][i],
//   H_(i,a),(k,b) = 2 (delta_ik C[i][a][b] - B[b][k][i] B[a][i][k]).
// Orbital derivatives come from the Hermite ladder identities
// psi_m' = sqrt(m/2) psi_{m-1} - sqrt((m+1)/2) psi_{m+1} and
// psi_m'' = (u^2 - 2m - 1) psi_m.
//
// What bounds it on the H100: at N=6 it writes 91 floats per walker and
// reads 12 (~3.4 MB at B=8192, ~1 us at 3.35 TB/s) against ~10 kflop of
// arithmetic per walker (~1.3 us at 67 TFLOP/s FP32): arithmetic and
// latency, close to balanced.
//
// Design: one thread per walker.  The per-walker factor tables (psi, psi',
// psi'' per particle and axis) and the inverse A and contractions B live in
// shared memory as [entry][walker] columns private to each thread, so no
// barrier is needed and a warp's accesses hit 32 distinct banks; the
// Gauss-Jordan inverse itself runs in registers (N x 2N, fully unrolled,
// swap-free pivoting resolved by selects, as the TPU kernel's _gj_inverse).
// Sectors: one N x N matrix with zero cross-sector entries, whose inverse
// and contractions are block-diagonal, so the cross-sector H blocks come
// out exactly zero.
#include "common.cuh"

namespace {

constexpr float kPref4 = 0.75112554446494251f;  // pi^{-1/4}
constexpr int BW = 32;                           // walkers per block
constexpr int KO = FF_KMAX;                      // orders with derivatives

template <int N>
struct Smem {
  float psi[N][2][KO + 1][BW];
  float dpsi[N][2][KO][BW];
  float d2psi[N][2][KO][BW];
  float A[N][N][BW];
  float Bm[2][N][N][BW];
};

template <int N>
__global__ void __launch_bounds__(BW) slater_vgh_kernel(
    const float* __restrict__ x, float* __restrict__ y_out,
    float* __restrict__ g_out, float* __restrict__ h_out, int B, Occ occ) {
  constexpr int D = 2 * N;
  __shared__ Smem<N> sm;
  const int t = threadIdx.x;
  const int w = blockIdx.x * BW + t;
  if (w >= B) return;  // no barrier below: every column is thread-private
  const size_t Bs = (size_t)B;

  // 1D factor tables, one order higher for the ladder derivative.
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float c = x[(2 * i + a) * Bs + w];
      float h[KO + 1];
      hermite<KO + 1>(c, h);
      const float g = kPref4 * expf(-0.5f * c * c);
#pragma unroll
      for (int m = 0; m <= KO; ++m) sm.psi[i][a][m][t] = g * h[m];
#pragma unroll
      for (int m = 0; m < KO; ++m) {
        float dm = -sqrtf((m + 1) / 2.f) * g * h[m + 1];
        if (m > 0) dm += sqrtf(m / 2.f) * g * h[m - 1];
        sm.dpsi[i][a][m][t] = dm;
        sm.d2psi[i][a][m][t] = (c * c - (float)(2 * m + 1)) * g * h[m];
      }
    }
  }

  auto same = [&](int i, int j) { return (i < occ.nup) == (j < occ.nup); };

  // Gauss-Jordan on [D | I] in registers.
  float M[N][2 * N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      M[i][j] = same(i, j) ? sm.psi[i][0][occ.nx[j]][t] * sm.psi[i][1][occ.ny[j]][t] : 0.f;
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
      sm.A[k][j][t] = v;
    }
  }

  // B[a][i][k] = sum_j D1a[i][j] A[j][k]; g = 2 B[a][i][i].
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float d1x[N], d1y[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const bool s = same(i, j);
      const int ox = occ.nx[j], oy = occ.ny[j];
      d1x[j] = s ? sm.dpsi[i][0][ox][t] * sm.psi[i][1][oy][t] : 0.f;
      d1y[j] = s ? sm.psi[i][0][ox][t] * sm.dpsi[i][1][oy][t] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float bx = 0.f, by = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float ajk = sm.A[j][k][t];
        bx += d1x[j] * ajk;
        by += d1y[j] * ajk;
      }
      sm.Bm[0][i][k][t] = bx;
      sm.Bm[1][i][k][t] = by;
    }
    g_out[(2 * i) * Bs + w] = 2.f * sm.Bm[0][i][i][t];
    g_out[(2 * i + 1) * Bs + w] = 2.f * sm.Bm[1][i][i][t];
  }
  y_out[w] = 2.f * logabs;

  // Packed H rows: p = 2i+a <= q = 2k+b.
  int row = 0;
#pragma unroll
  for (int p = 0; p < D; ++p) {
    const int i = p / 2, a = p % 2;
    // C[i][a][b] for b = 0, 1 (only needed on the diagonal particle block).
    float c_ab[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (!same(i, j)) continue;
      const int ox = occ.nx[j], oy = occ.ny[j];
      const float aji = sm.A[j][i][t];
      const float xx = sm.d2psi[i][0][ox][t] * sm.psi[i][1][oy][t];
      const float yy = sm.psi[i][0][ox][t] * sm.d2psi[i][1][oy][t];
      const float xy = sm.dpsi[i][0][ox][t] * sm.dpsi[i][1][oy][t];
      c_ab[0] += aji * (a == 0 ? xx : xy);
      c_ab[1] += aji * (a == 0 ? xy : yy);
    }
#pragma unroll
    for (int q = p; q < D; ++q) {
      const int k = q / 2, b = q % 2;
      float v = -sm.Bm[b][k][i][t] * sm.Bm[a][i][k][t];
      if (i == k) v += c_ab[b];
      h_out[(size_t)row * Bs + w] = 2.f * v;
      ++row;
    }
  }
}

template <int N>
cudaError_t launch(const float* x, float* y, float* g, float* h, int B, Occ occ,
                   cudaStream_t stream) {
  const int blocks = (B + BW - 1) / BW;
  slater_vgh_kernel<N><<<blocks, BW, 0, stream>>>(x, y, g, h, B, occ);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ff_slater_vgh(const float* x, float* y, float* g, float* h, int B,
                             int n, int nup, const int* nx, const int* ny,
                             void* stream) {
  const Occ occ = make_occ(nx, ny, n, nup);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (n) {
    case 2: err = launch<2>(x, y, g, h, B, occ, st); break;
    case 3: err = launch<3>(x, y, g, h, B, occ, st); break;
    case 4: err = launch<4>(x, y, g, h, B, occ, st); break;
    case 5: err = launch<5>(x, y, g, h, B, occ, st); break;
    case 6: err = launch<6>(x, y, g, h, B, occ, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
