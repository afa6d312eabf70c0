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
// reads 12 floats and 12 int32 quantum numbers (~3.8 MB at B=8192, ~1.1 us
// at 3.35 TB/s) against ~4 kflop of arithmetic per walker at K=5: bytes,
// behind the same chain of dependent steps as the ground-state kernel.
//
// Design: the ground-state kernel's lane groups and determinant calculus
// (vgh.cuh), 8 lanes per walker.  The occupation differs from walker to
// walker, so each lane reads the walker's 2N quantum numbers, runs the
// Hermite recurrence of depth K+1 (K a template parameter) for its own
// particles' coordinates in registers, and picks only its own rows' factors
// by unrolled compare-selects (no register array indexed by a per-walker
// number).  A quantum number outside [0, K) turns the walker's outputs into
// NaN.
#include "vgh.cuh"

namespace {

template <int N, int K>
__global__ void __launch_bounds__(kVghThreads, kVghMinBlocks) slater_vgh_ms_kernel(
    const float* __restrict__ x, const int* __restrict__ nx,
    const int* __restrict__ ny, float* __restrict__ y_out,
    float* __restrict__ g_out, float* __restrict__ h_out, int B) {
  constexpr int G = kVghLanes;
  using P = VghPlan<N, G>;
  extern __shared__ float smem[];
  const int lane = threadIdx.x % G, wb = threadIdx.x / G;
  const int w = min((int)blockIdx.x * kVghWalkers + wb, B - 1);
  const size_t Bs = (size_t)B;

  int q[2][N];
  bool ok = true;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    q[0][j] = nx[j * Bs + w];
    q[1][j] = ny[j * Bs + w];
    ok = ok && q[0][j] >= 0 && q[0][j] < K && q[1][j] >= 0 && q[1][j] < K;
  }

  float fv[P::S][N][2], f1[P::S][N][2], f2[P::S][N][2];
#pragma unroll
  for (int s = 0; s < P::S; ++s) {
    const int i = vgh_row<N, G>(lane, s);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float psi[K], dpsi[K], d2psi[K];
      ho_factors<K>(x[(2 * i + a) * Bs + w], psi, dpsi, d2psi);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        fv[s][j][a] = select_order<K>(psi, q[a][j]);
        f1[s][j][a] = select_order<K>(dpsi, q[a][j]);
        f2[s][j][a] = select_order<K>(d2psi, q[a][j]);
      }
    }
  }
  const float two = ok ? 2.f : __int_as_float(0x7fc00000);
  float* stage = smem + kVghWalkers * P::WS;
  vgh_group<N, G>(fv, f1, f2, N, lane, smem + wb * P::WS, stage + wb, two);
  vgh_store_block<N, G>(stage, B, y_out, g_out, h_out);
}

template <int N, int K>
cudaError_t launch(const float* x, const int* nx, const int* ny, float* y,
                   float* g, float* h, int B, cudaStream_t stream) {
  slater_vgh_ms_kernel<N, K><<<vgh_blocks(B), kVghThreads,
                               VghPlan<N, kVghLanes>::smem_bytes, stream>>>(
      x, nx, ny, y, g, h, B);
  return cudaGetLastError();
}

template <int N, int K>
cudaError_t occupancy(int* warps) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, slater_vgh_ms_kernel<N, K>, kVghThreads,
      VghPlan<N, kVghLanes>::smem_bytes);
  *warps = blocks * (kVghThreads / 32);
  return err;
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

template <int N>
cudaError_t occupancy_k(int kdepth, int* warps) {
  switch (kdepth) {
    case 4: return occupancy<N, 4>(warps);
    case 5: return occupancy<N, 5>(warps);
    case 6: return occupancy<N, 6>(warps);
    case 8: return occupancy<N, 8>(warps);
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

// The kernel's launch for n particles at Hermite depth kdepth over B
// walkers: resident warps per SM, the warps of the grid the launcher makes,
// and lanes per walker.
extern "C" int ff_slater_vgh_ms_occupancy(int n, int kdepth, int B,
                                          int* warps_per_sm, int* grid_warps,
                                          int* lanes) {
  *grid_warps = vgh_grid_warps(B);
  *lanes = kVghLanes;
  switch (n) {
    case 2: return (int)occupancy_k<2>(kdepth, warps_per_sm);
    case 3: return (int)occupancy_k<3>(kdepth, warps_per_sm);
    case 4: return (int)occupancy_k<4>(kdepth, warps_per_sm);
    case 5: return (int)occupancy_k<5>(kdepth, warps_per_sm);
    case 6: return (int)occupancy_k<6>(kdepth, warps_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}
