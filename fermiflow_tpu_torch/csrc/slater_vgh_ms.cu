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
// behind the same chain of dependent steps as the ground-state kernel.  At
// N=10, K=8 it moves 271 words per walker against ~15 kflop: bytes still.
//
// Design: the ground-state kernel's lane groups and determinant calculus
// (vgh.cuh), 8 lanes per walker.  The occupation differs from walker to
// walker, so each lane reads the walker's 2N quantum numbers (WalkerQnums,
// common.cuh), runs the Hermite recurrence of depth K+1 (K a template
// parameter) for its own particles' coordinates in registers, and picks only
// its own rows' factors by unrolled compare-selects (no register array
// indexed by a per-walker number).  A quantum number outside [0, K) turns
// the walker's outputs into NaN.
//
// From N = 7 (to N = 10, at every depth) it takes the static kernel's N >= 7
// plan (slater_vgh.cu): lanes 0..N-9 own two rows, each lane keeps its
// rows' coordinates and evaluates the K-order tables where it needs them
// (vgh_group_tables; two rows' precomputed factors would be 120 floats),
// and the block's 75.6 KB of scratch and staging at N = 10 takes the
// shared-memory opt-in (prepare).  Each axis's quantum numbers are
// packed into one word.  N <= 6 keeps the precomputed factor tables.
// From N = 9 the per-walker occupation and the depth-K tables do not fit
// the 128 registers of two resident blocks (ptxas spilled), so from N = 7
// the kernel is built for one resident block per SM (8 warps; 146 to 181
// registers at N = 10): the finite-T path's batch of 2048 walkers makes 64
// blocks, one per SM whatever the bound.
#include "vgh.cuh"

namespace {

// Resident blocks per SM each instantiation is built for (kVghMinBlocks to
// N = 6, one from N = 7).
constexpr int ms_vgh_min_blocks(int n) { return n <= 6 ? kVghMinBlocks : 1; }

template <int N, int K>
__global__ void __launch_bounds__(kVghThreads, ms_vgh_min_blocks(N)) slater_vgh_ms_kernel(
    const float* __restrict__ x, const int* __restrict__ nx,
    const int* __restrict__ ny, float* __restrict__ y_out,
    float* __restrict__ g_out, float* __restrict__ h_out, int B) {
  constexpr int G = kVghLanes;
  using P = VghPlan<N, G>;
  extern __shared__ float smem[];
  const int lane = threadIdx.x % G, wb = threadIdx.x / G;
  const int w = min((int)blockIdx.x * kVghWalkers + wb, B - 1);
  const size_t Bs = (size_t)B;
  float* stage = smem + kVghWalkers * P::WS;

  WalkerQnums<N, K> q;
  const bool ok = q.load(nx, ny, Bs, w);
  if constexpr (N <= 6) {
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
          fv[s][j][a] = select_order<K>(psi, q(j, a));
          f1[s][j][a] = select_order<K>(dpsi, q(j, a));
          f2[s][j][a] = select_order<K>(d2psi, q(j, a));
        }
      }
    }
    const float two = ok ? 2.f : __int_as_float(0x7fc00000);
    vgh_group<N, G>(fv, f1, f2, N, lane, smem + wb * P::WS, stage + wb, two);
  } else {
    float xc[P::S][2];
#pragma unroll
    for (int s = 0; s < P::S; ++s)
#pragma unroll
      for (int a = 0; a < 2; ++a) xc[s][a] = x[(2 * vgh_row<N, G>(lane, s) + a) * Bs + w];
    const float two = ok ? 2.f : __int_as_float(0x7fc00000);
    vgh_group_tables<N, G, K>(xc, q, N, lane, smem + wb * P::WS, stage + wb, two);
  }
  vgh_store_block<N, G>(stage, B, y_out, g_out, h_out);
}

// Once per instantiation and process: allow the dynamic shared memory of
// the instantiations past the default 48 KB (N >= 8).
template <int N, int K>
cudaError_t prepare() {
  constexpr size_t bytes = VghPlan<N, kVghLanes>::smem_bytes;
  if constexpr (bytes <= 48 * 1024) {
    return cudaSuccess;
  } else {
    static const cudaError_t err = cudaFuncSetAttribute(
        slater_vgh_ms_kernel<N, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    return err;
  }
}

template <int N, int K>
cudaError_t launch(const float* x, const int* nx, const int* ny, float* y,
                   float* g, float* h, int B, cudaStream_t stream) {
  const cudaError_t err = prepare<N, K>();
  if (err != cudaSuccess) return err;
  slater_vgh_ms_kernel<N, K><<<vgh_blocks(B), kVghThreads,
                               VghPlan<N, kVghLanes>::smem_bytes, stream>>>(
      x, nx, ny, y, g, h, B);
  return cudaGetLastError();
}

template <int N, int K>
cudaError_t occupancy(int* warps) {
  int blocks = 0;
  cudaError_t err = prepare<N, K>();
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
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

// x (d, B), nx/ny (n, B) int32 -> y (B,), g (d, B), h (d(d+1)/2, B), for
// 2 <= n <= 10.  kdepth is the compiled Hermite depth (4, 5, 6 or 8).
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
    case 7: err = launch_k<7>(kdepth, x, nx, ny, y, g, h, B, st); break;
    case 8: err = launch_k<8>(kdepth, x, nx, ny, y, g, h, B, st); break;
    case 9: err = launch_k<9>(kdepth, x, nx, ny, y, g, h, B, st); break;
    case 10: err = launch_k<10>(kdepth, x, nx, ny, y, g, h, B, st); break;
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
    case 7: return (int)occupancy_k<7>(kdepth, warps_per_sm);
    case 8: return (int)occupancy_k<8>(kdepth, warps_per_sm);
    case 9: return (int)occupancy_k<9>(kdepth, warps_per_sm);
    case 10: return (int)occupancy_k<10>(kdepth, warps_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}
