// Multi-segment Metropolis sampler of the free-fermion |det|^2 density.
//
// Replaces: fermiflow_tpu/ops/pallas_metropolis.py
//   metropolis_free_fermion_chains (kernel _metropolis_multichain_kernel),
//   through the entry ff_metropolis_chains; and
//   metropolis_free_fermion (kernel _metropolis_kernel), through the entry
//   ff_metropolis_free_fermion.  The single-segment, fixed-tau chain shares
//   this file's device code: one segment with reinit off takes the same steps
//   on the same Philox stream, and tau_out is not written.  Its bound is the
//   same arithmetic bound as below at segments = 1.
//
// What bounds it on the H100: arithmetic.  Per walker-step it evaluates d
// Box-Muller normals, the Hermite tables and an N x N pivoted Gaussian
// elimination (~900 flop-equivalents at N=6, bench.py's _sampler_flops),
// while device memory sees one read of the walker state per launch and one
// write per segment snapshot.  A chain's steps are serial, so the latency of
// each step's dependent work (Philox rounds, log/sincos/exp, the
// elimination's divisions) is the limit unless many chains interleave.
//
// Design: a group of G = kSamplerLanes = 8 lanes walks one chain, 16
// walkers per 128-thread block, so B = 8192 walkers make 2048 warps, all
// resident at <= 128 registers (sampler.cuh: lane l owns particles l,
// l + G, ...).  Each step the group draws its uniforms
// (Philox call q on lane q) and normals (Box-Muller pair k on lane k % G),
// builds its rows of the Slater matrix and eliminates them together; every
// lane then holds the same log p and accept uniform, so all decide alike.
// The arithmetic and the Philox stream are one thread's: counter (draw,
// step, segment) keyed by (seed, walker0 + walker), so no generator state
// is kept.  The seed is read from one word of device memory at the
// kernel's start, not passed by value: a captured CUDA graph replays the
// launch with the word its host side rewrote, and so draws a new stream
// each replay.  walker0 is the launch's first global walker: a rank of a
// multi-process run launching on its rows (walker0 = its first row) walks
// exactly the chains of those rows in a one-process launch, whatever the
// process count (walker0 = 0 gives the one-process stream).
// Optional pre-drawn normal/uniform buffers replace the generator (null in
// production) so the kernel and its plain PyTorch version can be compared
// on one random stream.  Between segments tau adapts per walker,
// tau *= exp(gain * (rate - target)); with reinit each segment restarts from
// fresh Gaussians at fixed tau.  Walkers past B walk a copy of walker B - 1
// and store nothing.
//
// From N = 7 the orbitals reach order 3, so the Hermite tables hold
// K = gs_orders(N) = 4 orders; lanes 0..N-9 own two particles, and a step
// draws 2N + 1 = 21 uniforms at N = 10, Philox calls 0..5 on lanes 0..5.
#include "sampler.cuh"

namespace {

// log p(x) = 2 sum_sectors log|det|: one N x N matrix whose cross-sector
// entries are zero (det of a block-diagonal matrix = product of the blocks).
template <int N, int G>
__device__ __forceinline__ float slater_logp(const float (&x)[Group<N, G>::S][2],
                                             const Occ& occ, int lane) {
  constexpr int K = gs_orders(N);
  float D[Group<N, G>::S][N];
#pragma unroll
  for (int s = 0; s < Group<N, G>::S; ++s) {
    const float xi = x[s][0], yi = x[s][1];
    const float g = kPref * expf(-0.5f * (xi * xi + yi * yi));
    float hx[K], hy[K];
    hermite<K>(xi, hx);
    hermite<K>(yi, hy);
    const bool up_i = slot_particle<N, G>(lane, s) < occ.nup;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const bool same = up_i == (j < occ.nup);
      D[s][j] = same ? g * select_order<K>(hx, occ.nx[j]) *
                           select_order<K>(hy, occ.ny[j])
                     : 0.f;
    }
  }
  return group_logabsdet2<N, G>(D, lane);
}

template <int N>
__global__ void __launch_bounds__(kSamplerThreads, kSamplerMinBlocks) metropolis_chains_kernel(
    const float* __restrict__ x0, const float* __restrict__ tau0,
    float* __restrict__ xs, float* __restrict__ logps, float* __restrict__ rates,
    float* __restrict__ tau_out, const float* __restrict__ normals,
    const float* __restrict__ uniforms, int B, Occ occ, const uint32_t* __restrict__ seed_word,
    uint32_t walker0, int steps, int segments, float target, float gain, int reinit) {
  constexpr int G = kSamplerLanes;
  using L = Group<N, G>;
  constexpr int D = L::D;
  const int lane = threadIdx.x % G;
  const int wr = blockIdx.x * kSamplerWalkers + threadIdx.x / G;
  const bool live = wr < B;
  const int w = min(wr, B - 1);
  const size_t Bs = (size_t)B;
  const uint32_t seed = *seed_word;

  float x[L::S][2];
#pragma unroll
  for (int s = 0; s < L::S; ++s)
#pragma unroll
    for (int a = 0; a < 2; ++a)
      x[s][a] = x0[(2 * slot_particle<N, G>(lane, s) + a) * Bs + w];
  float tau = tau0[w];
  float logp = slater_logp<N, G>(x, occ, lane);

  for (int seg = 0; seg < segments; ++seg) {
    if (reinit && seg > 0) {
      if (normals) {
#pragma unroll
        for (int s = 0; s < L::S; ++s)
#pragma unroll
          for (int a = 0; a < 2; ++a)
            x[s][a] = normals[(((size_t)seg * (steps + 1) + steps) * D +
                               2 * slot_particle<N, G>(lane, s) + a) * Bs + w];
      } else {
        float ua;
        draw_step<N, G>(seed, walker0 + (uint32_t)w, (uint32_t)steps, (uint32_t)seg, lane, x, ua);
      }
      logp = slater_logp<N, G>(x, occ, lane);
    }
    float acc = 0.f;
    for (int t = 0; t < steps; ++t) {
      float z[L::S][2];
      float ua;
      if (normals) {
#pragma unroll
        for (int s = 0; s < L::S; ++s)
#pragma unroll
          for (int a = 0; a < 2; ++a)
            z[s][a] = normals[(((size_t)seg * (steps + 1) + t) * D +
                               2 * slot_particle<N, G>(lane, s) + a) * Bs + w];
        ua = uniforms[((size_t)seg * steps + t) * Bs + w];
      } else {
        draw_step<N, G>(seed, walker0 + (uint32_t)w, (uint32_t)t, (uint32_t)seg, lane, z, ua);
      }
      float xn[L::S][2];
#pragma unroll
      for (int s = 0; s < L::S; ++s)
#pragma unroll
        for (int a = 0; a < 2; ++a) xn[s][a] = __fadd_rn(x[s][a], __fmul_rn(tau, z[s][a]));
      const float lpn = slater_logp<N, G>(xn, occ, lane);
      const bool accept = ua < expf(fminf(lpn - logp, 0.f));
#pragma unroll
      for (int s = 0; s < L::S; ++s)
#pragma unroll
        for (int a = 0; a < 2; ++a) x[s][a] = accept ? xn[s][a] : x[s][a];
      logp = accept ? lpn : logp;
      acc += accept ? 1.f : 0.f;
    }
    const float rate = acc / (float)(steps > 1 ? steps : 1);
    if (live) {
#pragma unroll
      for (int s = 0; s < L::S; ++s)
        if (lane + s * G < N)
#pragma unroll
          for (int a = 0; a < 2; ++a)
            xs[((size_t)seg * D + 2 * (lane + s * G) + a) * Bs + w] = x[s][a];
      if (lane == 0) {
        logps[(size_t)seg * Bs + w] = logp;
        rates[(size_t)seg * Bs + w] = rate;
      }
    }
    if (!reinit) tau = tau * expf(gain * (rate - target));
  }
  if (tau_out && live && lane == 0) tau_out[w] = tau;
}

template <int N>
cudaError_t launch(const float* x0, const float* tau0, float* xs, float* logps,
                   float* rates, float* tau_out, const float* normals,
                   const float* uniforms, int B, Occ occ, const uint32_t* seed,
                   uint32_t walker0, int steps,
                   int segments, float target, float gain, int reinit,
                   cudaStream_t stream) {
  metropolis_chains_kernel<N><<<sampler_blocks(B), kSamplerThreads, 0, stream>>>(
      x0, tau0, xs, logps, rates, tau_out, normals, uniforms, B, occ, seed,
      walker0, steps, segments, target, gain, reinit);
  return cudaGetLastError();
}

template <int N>
cudaError_t occupancy(int* warps) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, metropolis_chains_kernel<N>, kSamplerThreads, 0);
  *warps = blocks * (kSamplerThreads / 32);
  return err;
}

}  // namespace

// x0 (d, B), tau0 (B,) -> xs (segments, d, B), logps and rates
// (segments, B), tau_out (B,) when not null.  seed points at one word of
// device memory.  Injected noise, when given,
// is normals (segments, steps + 1, d, B) and uniforms (segments, steps, B).
extern "C" int ff_metropolis_chains(
    const float* x0, const float* tau0, float* xs, float* logps, float* rates,
    float* tau_out, const float* normals, const float* uniforms, int B, int n,
    int nup, const int* nx, const int* ny, const unsigned int* seed,
    unsigned int walker0, int steps, int segments, float target, float gain,
    int reinit, void* stream) {
  const Occ occ = make_occ(nx, ny, n, nup);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (n) {
    case 2: err = launch<2>(x0, tau0, xs, logps, rates, tau_out, normals, uniforms, B, occ, seed, walker0, steps, segments, target, gain, reinit, st); break;
    case 3: err = launch<3>(x0, tau0, xs, logps, rates, tau_out, normals, uniforms, B, occ, seed, walker0, steps, segments, target, gain, reinit, st); break;
    case 4: err = launch<4>(x0, tau0, xs, logps, rates, tau_out, normals, uniforms, B, occ, seed, walker0, steps, segments, target, gain, reinit, st); break;
    case 5: err = launch<5>(x0, tau0, xs, logps, rates, tau_out, normals, uniforms, B, occ, seed, walker0, steps, segments, target, gain, reinit, st); break;
    case 6: err = launch<6>(x0, tau0, xs, logps, rates, tau_out, normals, uniforms, B, occ, seed, walker0, steps, segments, target, gain, reinit, st); break;
    case 7: err = launch<7>(x0, tau0, xs, logps, rates, tau_out, normals, uniforms, B, occ, seed, walker0, steps, segments, target, gain, reinit, st); break;
    case 8: err = launch<8>(x0, tau0, xs, logps, rates, tau_out, normals, uniforms, B, occ, seed, walker0, steps, segments, target, gain, reinit, st); break;
    case 9: err = launch<9>(x0, tau0, xs, logps, rates, tau_out, normals, uniforms, B, occ, seed, walker0, steps, segments, target, gain, reinit, st); break;
    case 10: err = launch<10>(x0, tau0, xs, logps, rates, tau_out, normals, uniforms, B, occ, seed, walker0, steps, segments, target, gain, reinit, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

// One fixed-tau chain of `steps` (the segments = 1, reinit = 0 case of the
// kernel above): x (d, B), logp (B,), acc (B,).  Injected noise, when given,
// is normals (steps, d, B) and uniforms (steps, B): with one segment and no
// restart the kernel reads exactly those slots.
extern "C" int ff_metropolis_free_fermion(
    const float* x0, const float* tau, float* x, float* logp, float* acc,
    const float* normals, const float* uniforms, int B, int n, int nup,
    const int* nx, const int* ny, const unsigned int* seed, unsigned int walker0,
    int steps, void* stream) {
  return ff_metropolis_chains(x0, tau, x, logp, acc, nullptr, normals,
                              uniforms, B, n, nup, nx, ny, seed, walker0,
                              steps, 1, 0.f, 0.f, 0, stream);
}

// The chains kernel's launch for n particles over B walkers: resident warps
// per SM, the warps of the grid the launcher makes, and lanes per chain.
extern "C" int ff_metropolis_occupancy(int n, int B, int* warps_per_sm,
                                       int* grid_warps, int* lanes) {
  *grid_warps = sampler_grid_warps(B);
  *lanes = kSamplerLanes;
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
