// Mixed-state Metropolis sampler of the free-fermion |det|^2 density.
//
// Replaces: fermiflow_tpu/ops/pallas_metropolis.py
//   metropolis_free_fermion_multistate (kernel _metropolis_multistate_kernel,
//   log density _slater_logp_multistate).
//
// Computes `steps` fixed-tau Metropolis steps per walker on the density
// |det D|^2 of that walker's own Slater state (one spin sector), with
// D[i][j] = pi^{-1/2} exp(-r_i^2/2) h_{nx[j]}(x_i) h_{ny[j]}(y_i).
//
// What bounds it on the H100: arithmetic, as for the ground-state sampler.
// Per walker-step it draws d Box-Muller normals, runs 2N Hermite
// recurrences of depth K and an N x N pivoted elimination (~1000
// flop-equivalents at N=6, K=5); device memory sees the walker state, tau
// and 2N int32 quantum numbers read once and x, logp, acc written once per
// launch.  As there, the chain's serial steps make latency the limit unless
// many chains interleave.
//
// Design: the ground-state sampler's (metropolis.cu), whose device code it
// shares (sampler.cuh): a group of G = kSamplerLanes lanes walks one chain,
// lane l owning particles l, l + G, ...; Philox4x32-10 keyed by
// (seed, walker) with counter (draw, step, 0).  Every lane of the group
// reads the walker's N (nx, ny) pairs once before the chain and keeps them
// in registers (the counterpart of the TPU kernel's one-hot masks hoisted
// out of its loop).  Orbital values are picked from the Hermite table by
// unrolled compare-selects, never by indexing a register array with a
// per-walker number, which would send the array to local memory.  The
// Hermite depth K is a template parameter.  A quantum number outside
// [0, K) turns the walker's outputs into NaN rather than a wrong chain.
#include "sampler.cuh"

namespace {

template <int N, int K, int G>
__device__ __forceinline__ float slater_logp_ms(const float (&x)[Group<N, G>::S][2],
                                                const int (&qx)[N],
                                                const int (&qy)[N], int lane) {
  float D[Group<N, G>::S][N];
#pragma unroll
  for (int s = 0; s < Group<N, G>::S; ++s) {
    const float xi = x[s][0], yi = x[s][1];
    const float g = kPref * expf(-0.5f * (xi * xi + yi * yi));
    float hx[K], hy[K];
    hermite<K>(xi, hx);
    hermite<K>(yi, hy);
#pragma unroll
    for (int j = 0; j < N; ++j)
      D[s][j] = g * select_order<K>(hx, qx[j]) * select_order<K>(hy, qy[j]);
  }
  return group_logabsdet2<N, G>(D, lane);
}

template <int N, int K>
__global__ void __launch_bounds__(kSamplerThreads, kSamplerMinBlocks) metropolis_ms_kernel(
    const float* __restrict__ x0, const float* __restrict__ tau0,
    const int* __restrict__ nx, const int* __restrict__ ny,
    float* __restrict__ x_out, float* __restrict__ logp_out,
    float* __restrict__ acc_out, const float* __restrict__ normals,
    const float* __restrict__ uniforms, int B, uint32_t seed, int steps) {
  constexpr int G = kSamplerLanes;
  using L = Group<N, G>;
  constexpr int D = L::D;
  const int lane = threadIdx.x % G;
  const int wr = blockIdx.x * kSamplerWalkers + threadIdx.x / G;
  const bool live = wr < B;
  const int w = min(wr, B - 1);
  const size_t Bs = (size_t)B;

  int qx[N], qy[N];
  bool ok = true;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    qx[j] = nx[j * Bs + w];
    qy[j] = ny[j * Bs + w];
    ok = ok && qx[j] >= 0 && qx[j] < K && qy[j] >= 0 && qy[j] < K;
  }
  float x[L::S][2];
#pragma unroll
  for (int s = 0; s < L::S; ++s)
#pragma unroll
    for (int a = 0; a < 2; ++a)
      x[s][a] = x0[(2 * slot_particle<N, G>(lane, s) + a) * Bs + w];
  const float tau = tau0[w];
  float logp = slater_logp_ms<N, K, G>(x, qx, qy, lane);

  float acc = 0.f;
  for (int t = 0; t < steps; ++t) {
    float z[L::S][2];
    float ua;
    if (normals) {
#pragma unroll
      for (int s = 0; s < L::S; ++s)
#pragma unroll
        for (int a = 0; a < 2; ++a)
          z[s][a] = normals[((size_t)t * D + 2 * slot_particle<N, G>(lane, s) + a) * Bs + w];
      ua = uniforms[(size_t)t * Bs + w];
    } else {
      draw_step<N, G>(seed, (uint32_t)w, (uint32_t)t, 0u, lane, z, ua);
    }
    float xn[L::S][2];
#pragma unroll
    for (int s = 0; s < L::S; ++s)
#pragma unroll
      for (int a = 0; a < 2; ++a) xn[s][a] = __fadd_rn(x[s][a], __fmul_rn(tau, z[s][a]));
    const float lpn = slater_logp_ms<N, K, G>(xn, qx, qy, lane);
    const bool accept = ua < expf(fminf(lpn - logp, 0.f));
#pragma unroll
    for (int s = 0; s < L::S; ++s)
#pragma unroll
      for (int a = 0; a < 2; ++a) x[s][a] = accept ? xn[s][a] : x[s][a];
    logp = accept ? lpn : logp;
    acc += accept ? 1.f : 0.f;
  }
  if (!live) return;  // after the group's last shuffle
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int s = 0; s < L::S; ++s)
    if (lane + s * G < N)
#pragma unroll
      for (int a = 0; a < 2; ++a)
        x_out[(2 * (lane + s * G) + a) * Bs + w] = ok ? x[s][a] : nan;
  if (lane == 0) {
    logp_out[w] = ok ? logp : nan;
    acc_out[w] = ok ? acc / (float)(steps > 1 ? steps : 1) : nan;
  }
}

template <int N, int K>
cudaError_t launch(const float* x0, const float* tau, const int* nx,
                   const int* ny, float* x, float* logp, float* acc,
                   const float* normals, const float* uniforms, int B,
                   uint32_t seed, int steps, cudaStream_t stream) {
  metropolis_ms_kernel<N, K><<<sampler_blocks(B), kSamplerThreads, 0, stream>>>(
      x0, tau, nx, ny, x, logp, acc, normals, uniforms, B, seed, steps);
  return cudaGetLastError();
}

template <int N, int K>
cudaError_t occupancy(int* warps) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, metropolis_ms_kernel<N, K>, kSamplerThreads, 0);
  *warps = blocks * (kSamplerThreads / 32);
  return err;
}

// One launcher per N over the compiled Hermite depths; `warps` asks for the
// occupancy of that instantiation (into *warps) instead of a launch.
template <int N>
cudaError_t dispatch_k(int kdepth, const float* x0, const float* tau,
                       const int* nx, const int* ny, float* x, float* logp,
                       float* acc, const float* normals, const float* uniforms,
                       int B, uint32_t seed, int steps, cudaStream_t st,
                       int* warps) {
  switch (kdepth) {
#define FF_MS_DEPTH(KD)                                                           \
  case KD:                                                                        \
    return warps ? occupancy<N, KD>(warps)                                        \
                 : launch<N, KD>(x0, tau, nx, ny, x, logp, acc, normals, uniforms, \
                                 B, seed, steps, st);
    FF_MS_DEPTH(4)
    FF_MS_DEPTH(5)
    FF_MS_DEPTH(6)
    FF_MS_DEPTH(8)
#undef FF_MS_DEPTH
    default: return cudaErrorInvalidValue;
  }
}

int dispatch(int n, int kdepth, const float* x0, const float* tau,
             const int* nx, const int* ny, float* x, float* logp, float* acc,
             const float* normals, const float* uniforms, int B, uint32_t seed,
             int steps, cudaStream_t st, int* warps) {
  switch (n) {
    case 2: return (int)dispatch_k<2>(kdepth, x0, tau, nx, ny, x, logp, acc, normals, uniforms, B, seed, steps, st, warps);
    case 3: return (int)dispatch_k<3>(kdepth, x0, tau, nx, ny, x, logp, acc, normals, uniforms, B, seed, steps, st, warps);
    case 4: return (int)dispatch_k<4>(kdepth, x0, tau, nx, ny, x, logp, acc, normals, uniforms, B, seed, steps, st, warps);
    case 5: return (int)dispatch_k<5>(kdepth, x0, tau, nx, ny, x, logp, acc, normals, uniforms, B, seed, steps, st, warps);
    case 6: return (int)dispatch_k<6>(kdepth, x0, tau, nx, ny, x, logp, acc, normals, uniforms, B, seed, steps, st, warps);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x0 (d, B), tau (B,), nx/ny (n, B) int32 -> x (d, B), logp (B,), acc (B,).
// kdepth is the compiled Hermite depth (4, 5, 6 or 8).  Injected noise,
// when given, is normals (steps, d, B) and uniforms (steps, B).
extern "C" int ff_metropolis_multistate(
    const float* x0, const float* tau, const int* nx, const int* ny, float* x,
    float* logp, float* acc, const float* normals, const float* uniforms,
    int B, int n, int kdepth, unsigned int seed, int steps, void* stream) {
  return dispatch(n, kdepth, x0, tau, nx, ny, x, logp, acc, normals, uniforms,
                  B, seed, steps, (cudaStream_t)stream, nullptr);
}

// The kernel's launch for (n, kdepth) over B walkers: resident warps per
// SM, the warps of the grid the launcher makes, and lanes per chain.
extern "C" int ff_metropolis_ms_occupancy(int n, int kdepth, int B,
                                          int* warps_per_sm, int* grid_warps,
                                          int* lanes) {
  *grid_warps = sampler_grid_warps(B);
  *lanes = kSamplerLanes;
  return dispatch(n, kdepth, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, nullptr, 0, 0u, 0, nullptr,
                  warps_per_sm);
}
