// Mixed-state Slater base log-density with its gradient and packed Hessian.
//
// Replaces: fermiflow_tpu/ops/pallas_slater_vgh.py
//   slater_vgh_ms_pallas (kernel _slater_vgh_ms_kernel, _multistate_vgh).
//
// Computes per walker, in that walker's own Slater state (one spin sector,
// quantum numbers nx, ny (n, B)), y = 2 log|det D|, g = grad y and
// H = grad^2 y in packed np.triu_indices order: the ground-state kernel's
// outputs and layout (slater_vgh.cu) with per-walker occupations.
//
// What bounds it on the H100: at N=6 it writes 91 floats per walker and
// reads 12 floats and 12 int32 quantum numbers (~3.8 MB at B=8192, ~1.1 us at
// 3.35 TB/s) against ~12 kflop of arithmetic per walker at K=5 (~1.5 us at
// 67 TFLOP/s FP32): arithmetic and latency, close to balanced.
//
// Design: one thread per walker, as the ground-state kernel, whose
// determinant calculus it shares (vgh.cuh).  The occupation differs from
// walker to walker, so there are no static factor tables: each thread runs
// the Hermite recurrence of depth K+1 (K a template parameter) for each of
// its particles' coordinates in registers, derives psi, psi', psi'' by the
// ladder identities, and picks its own orbitals' factors by unrolled
// compare-selects (no register array indexed by a per-walker number).  The
// picked 1D factors of every Slater entry, 6 N^2 floats, go to shared memory
// as thread-private [entry][walker] columns (27.6 KB per 32 walkers at N=6,
// 41.5 KB with the inverse and contractions).  A quantum number outside
// [0, K) turns the walker's outputs into NaN.
#include "vgh.cuh"

namespace {

template <int N>
struct SmemMS {
  float fac[N][N][2][3][BW];  // [particle][orbital][axis][psi, psi', psi'']
  float A[N][N][BW];
  float Bm[2][N][N][BW];
};

template <int N>
struct WalkerFactors {
  const SmemMS<N>& sm;
  int t;
  __device__ __forceinline__ float v(int i, int a, int j) const { return sm.fac[i][j][a][0][t]; }
  __device__ __forceinline__ float d1(int i, int a, int j) const { return sm.fac[i][j][a][1][t]; }
  __device__ __forceinline__ float d2(int i, int a, int j) const { return sm.fac[i][j][a][2][t]; }
  __device__ __forceinline__ bool same(int, int) const { return true; }
};

template <int N, int K>
__global__ void __launch_bounds__(BW) slater_vgh_ms_kernel(
    const float* __restrict__ x, const int* __restrict__ nx,
    const int* __restrict__ ny, float* __restrict__ y_out,
    float* __restrict__ g_out, float* __restrict__ h_out, int B) {
  __shared__ SmemMS<N> sm;
  const int t = threadIdx.x;
  const int w = blockIdx.x * BW + t;
  if (w >= B) return;  // no barrier below: every column is thread-private
  const size_t Bs = (size_t)B;

  int q[2][N];
  bool ok = true;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    q[0][j] = nx[j * Bs + w];
    q[1][j] = ny[j * Bs + w];
    ok = ok && q[0][j] >= 0 && q[0][j] < K && q[1][j] >= 0 && q[1][j] < K;
  }

#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float c = x[(2 * i + a) * Bs + w];
      float h[K + 1];
      hermite<K + 1>(c, h);
      const float g = kPref4 * expf(-0.5f * c * c);
      float psi[K], dpsi[K], d2psi[K];
#pragma unroll
      for (int m = 0; m < K; ++m) {
        psi[m] = g * h[m];
        float dm = -sqrtf((m + 1) / 2.f) * g * h[m + 1];
        if (m > 0) dm += sqrtf(m / 2.f) * g * h[m - 1];
        dpsi[m] = dm;
        d2psi[m] = (c * c - (float)(2 * m + 1)) * g * h[m];
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        sm.fac[i][j][a][0][t] = select_order<K>(psi, q[a][j]);
        sm.fac[i][j][a][1][t] = select_order<K>(dpsi, q[a][j]);
        sm.fac[i][j][a][2][t] = select_order<K>(d2psi, q[a][j]);
      }
    }
  }
  const float two = ok ? 2.f : __int_as_float(0x7fc00000);
  vgh_from_factors<N>(WalkerFactors<N>{sm, t}, sm.A, sm.Bm, t, w, Bs, two,
                      y_out, g_out, h_out);
}

template <int N, int K>
cudaError_t launch(const float* x, const int* nx, const int* ny, float* y,
                   float* g, float* h, int B, cudaStream_t stream) {
  const int blocks = (B + BW - 1) / BW;
  slater_vgh_ms_kernel<N, K><<<blocks, BW, 0, stream>>>(x, nx, ny, y, g, h, B);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_k(int kdepth, const float* x, const int* nx, const int* ny,
                     float* y, float* g, float* h, int B, cudaStream_t st) {
  switch (kdepth) {
    case 4: return launch<N, 4>(x, nx, ny, y, g, h, B, st);
    case 5: return launch<N, 5>(x, nx, ny, y, g, h, B, st);
    case 6: return launch<N, 6>(x, nx, ny, y, g, h, B, st);
    case 8: return launch<N, 8>(x, nx, ny, y, g, h, B, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (d, B), nx/ny (n, B) int32 -> y (B,), g (d, B), h (d(d+1)/2, B).
// kdepth is the compiled Hermite depth (4, 5, 6 or 8).
extern "C" int ff_slater_vgh_ms(const float* x, const int* nx, const int* ny,
                                float* y, float* g, float* h, int B, int n,
                                int kdepth, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (n) {
    case 2: err = launch_k<2>(kdepth, x, nx, ny, y, g, h, B, st); break;
    case 3: err = launch_k<3>(kdepth, x, nx, ny, y, g, h, B, st); break;
    case 4: err = launch_k<4>(kdepth, x, nx, ny, y, g, h, B, st); break;
    case 5: err = launch_k<5>(kdepth, x, nx, ny, y, g, h, B, st); break;
    case 6: err = launch_k<6>(kdepth, x, nx, ny, y, g, h, B, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
