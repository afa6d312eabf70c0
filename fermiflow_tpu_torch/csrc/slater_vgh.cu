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
// psi'' per particle and axis; the determinant calculus is vgh.cuh's, shared
// with the mixed-state kernel) and the inverse A and contractions B live in
// shared memory as [entry][walker] columns private to each thread, so no
// barrier is needed and a warp's accesses hit 32 distinct banks; the
// Gauss-Jordan inverse itself runs in registers (N x 2N, fully unrolled,
// swap-free pivoting resolved by selects, as the TPU kernel's _gj_inverse).
// Sectors: one N x N matrix with zero cross-sector entries, whose inverse
// and contractions are block-diagonal, so the cross-sector H blocks come
// out exactly zero.
#include "vgh.cuh"

namespace {

constexpr int KO = FF_KMAX;  // orders with derivatives

template <int N>
struct Smem {
  float psi[N][2][KO + 1][BW];
  float dpsi[N][2][KO][BW];
  float d2psi[N][2][KO][BW];
  float A[N][N][BW];
  float Bm[2][N][N][BW];
};

// 1D factors of entry (i, j) from the per-particle tables; the occupation is
// the same for every walker, so the table index is uniform across a warp.
template <int N>
struct StaticFactors {
  const Smem<N>& sm;
  Occ occ;
  int t;
  __device__ __forceinline__ int q(int a, int j) const {
    return a == 0 ? occ.nx[j] : occ.ny[j];
  }
  __device__ __forceinline__ float v(int i, int a, int j) const {
    return sm.psi[i][a][q(a, j)][t];
  }
  __device__ __forceinline__ float d1(int i, int a, int j) const {
    return sm.dpsi[i][a][q(a, j)][t];
  }
  __device__ __forceinline__ float d2(int i, int a, int j) const {
    return sm.d2psi[i][a][q(a, j)][t];
  }
  __device__ __forceinline__ bool same(int i, int j) const {
    return (i < occ.nup) == (j < occ.nup);
  }
};

template <int N>
__global__ void __launch_bounds__(BW) slater_vgh_kernel(
    const float* __restrict__ x, float* __restrict__ y_out,
    float* __restrict__ g_out, float* __restrict__ h_out, int B, Occ occ) {
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
  vgh_from_factors<N>(StaticFactors<N>{sm, occ, t}, sm.A, sm.Bm, t, w, Bs,
                      2.f, y_out, g_out, h_out);
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
