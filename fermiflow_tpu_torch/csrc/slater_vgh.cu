// Slater base log-density with its gradient and packed Hessian.
//
// Replaces: fermiflow_tpu/ops/pallas_slater_vgh.py
//   slater_vgh_pallas (kernel _slater_vgh_kernel).
//
// Computes per walker y = 2 sum_sectors log|det D|, g = grad y and
// H = grad^2 y (upper triangle in np.triu_indices order) by determinant
// calculus (vgh.cuh).  Orbital derivatives come from the Hermite ladder
// identities psi_m' = sqrt(m/2) psi_{m-1} - sqrt((m+1)/2) psi_{m+1} and
// psi_m'' = (u^2 - 2m - 1) psi_m.
//
// What bounds it on the H100: at N=6 it writes 91 floats per walker and
// reads 12 (~3.4 MB at B=8192, ~1 us at 3.35 TB/s) against ~4 kflop of
// arithmetic per walker (~0.5 us at 67 TFLOP/s FP32): bytes, but a walker's
// work is a chain of dependent steps (the elimination's columns, its
// shuffles), so latency sets the time unless many walkers interleave.
//
// Design: a group of kVghLanes = 8 lanes per walker, 32 walkers per
// 256-thread block, so B = 8192 walkers make 2048 warps (vgh.cuh: lane l
// owns rows l, l + 8, ...).  Each lane builds its particles' 1D factor
// tables in registers and picks its rows' entries by unrolled selects (the
// occupation is the same for every walker); the group eliminates its rows
// together, then each lane forms its rows of B and C, and the lanes deal
// out the packed H entries.  Sectors: one N x N matrix with zero
// cross-sector entries, whose inverse and contractions are block-diagonal,
// so the cross-sector H blocks come out exactly zero.
//
// From N = 7 the orbitals reach order 3 (K = gs_orders(N) = 4), lanes
// 0..N-9 own two rows (three at 4 lanes), and the three factor tables of
// two rows (120 floats at N = 10) would not fit in registers beside the
// elimination: each lane keeps its rows' coordinates and evaluates the
// tables where it needs them (vgh_group_tables).  The block's scratch and
// staging grow to 75.6 KB at N = 10, past the default 48 KB (prepare);
// shared memory would hold 3 blocks, the registers (128) hold 2.
#include "vgh.cuh"

namespace {

template <int N>
__global__ void __launch_bounds__(kVghThreads, kVghMinBlocks) slater_vgh_kernel(
    const float* __restrict__ x, float* __restrict__ y_out,
    float* __restrict__ g_out, float* __restrict__ h_out, int B, Occ occ) {
  constexpr int G = kVghLanes;
  constexpr int KO = gs_orders(N);  // orders with derivatives
  using P = VghPlan<N, G>;
  extern __shared__ float smem[];
  const int lane = threadIdx.x % G, wb = threadIdx.x / G;
  const int w = min((int)blockIdx.x * kVghWalkers + wb, B - 1);
  const size_t Bs = (size_t)B;
  float* stage = smem + kVghWalkers * P::WS;

  if constexpr (N <= 6) {
    float fv[P::S][N][2], f1[P::S][N][2], f2[P::S][N][2];
#pragma unroll
    for (int s = 0; s < P::S; ++s) {
      const int i = vgh_row<N, G>(lane, s);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        float psi[KO], dpsi[KO], d2psi[KO];
        ho_factors<KO>(x[(2 * i + a) * Bs + w], psi, dpsi, d2psi);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const int q = a == 0 ? occ.nx[j] : occ.ny[j];
          fv[s][j][a] = select_order<KO>(psi, q);
          f1[s][j][a] = select_order<KO>(dpsi, q);
          f2[s][j][a] = select_order<KO>(d2psi, q);
        }
      }
    }
    vgh_group<N, G>(fv, f1, f2, occ.nup, lane, smem + wb * P::WS, stage + wb, 2.f);
  } else {
    float xc[P::S][2];
#pragma unroll
    for (int s = 0; s < P::S; ++s)
#pragma unroll
      for (int a = 0; a < 2; ++a) xc[s][a] = x[(2 * vgh_row<N, G>(lane, s) + a) * Bs + w];
    vgh_group_tables<N, G, KO>(
        xc, [&](int j, int a) { return a == 0 ? occ.nx[j] : occ.ny[j]; }, occ.nup, lane,
        smem + wb * P::WS, stage + wb, 2.f);
  }
  vgh_store_block<N, G>(stage, B, y_out, g_out, h_out);
}

// Once per instantiation and process: allow the dynamic shared memory of
// the instantiations past the default 48 KB (N >= 8).
template <int N>
cudaError_t prepare() {
  constexpr size_t bytes = VghPlan<N, kVghLanes>::smem_bytes;
  if constexpr (bytes <= 48 * 1024) {
    return cudaSuccess;
  } else {
    static const cudaError_t err = cudaFuncSetAttribute(
        slater_vgh_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    return err;
  }
}

template <int N>
cudaError_t launch(const float* x, float* y, float* g, float* h, int B, Occ occ,
                   cudaStream_t stream) {
  const cudaError_t err = prepare<N>();
  if (err != cudaSuccess) return err;
  slater_vgh_kernel<N><<<vgh_blocks(B), kVghThreads, VghPlan<N, kVghLanes>::smem_bytes,
                         stream>>>(x, y, g, h, B, occ);
  return cudaGetLastError();
}

template <int N>
cudaError_t occupancy(int* warps) {
  int blocks = 0;
  cudaError_t err = prepare<N>();
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, slater_vgh_kernel<N>, kVghThreads, VghPlan<N, kVghLanes>::smem_bytes);
  *warps = blocks * (kVghThreads / 32);
  return err;
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
    case 7: err = launch<7>(x, y, g, h, B, occ, st); break;
    case 8: err = launch<8>(x, y, g, h, B, occ, st); break;
    case 9: err = launch<9>(x, y, g, h, B, occ, st); break;
    case 10: err = launch<10>(x, y, g, h, B, occ, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

// The kernel's launch for n particles over B walkers: resident warps per
// SM, the warps of the grid the launcher makes, and lanes per walker.
extern "C" int ff_slater_vgh_occupancy(int n, int B, int* warps_per_sm,
                                       int* grid_warps, int* lanes) {
  *grid_warps = vgh_grid_warps(B);
  *lanes = kVghLanes;
  switch (n) {
    case 2: return (int)occupancy<2>(warps_per_sm);
    case 3: return (int)occupancy<3>(warps_per_sm);
    case 4: return (int)occupancy<4>(warps_per_sm);
    case 5: return (int)occupancy<5>(warps_per_sm);
    case 6: return (int)occupancy<6>(warps_per_sm);
    case 7: return (int)occupancy<7>(warps_per_sm);
    case 8: return (int)occupancy<8>(warps_per_sm);
    case 9: return (int)occupancy<9>(warps_per_sm);
    case 10: return (int)occupancy<10>(warps_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}
