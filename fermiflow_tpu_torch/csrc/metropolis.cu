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
// write per segment snapshot.  FP32 issue rate and the latency of the
// transcendentals (log, sincos, exp) are the limit.
//
// Design: one thread per walker; the 2N coordinates, the 3-deep Hermite
// table and the N x N elimination sit in registers (fully unrolled over the
// compile-time N, pivots resolved by selects, no data-dependent indexing).
// Random numbers come from a counter-based Philox4x32-10 keyed by
// (seed, walker) with counter (draw, step, segment), so no generator state
// is kept.  Optional pre-drawn normal/uniform buffers replace the generator
// (null in production) so the kernel and its plain PyTorch version can be
// compared on one random stream.  Between segments tau adapts per walker,
// tau *= exp(gain * (rate - target)); with reinit each segment restarts from
// fresh Gaussians at fixed tau.
#include "sampler.cuh"

namespace {

// log p(x) = 2 sum_sectors log|det|: one N x N matrix whose cross-sector
// entries are zero (det of a block-diagonal matrix = product of the blocks).
template <int N>
__device__ __forceinline__ float slater_logp(const float (&x)[2 * N], const Occ& occ) {
  float D[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float xi = x[2 * i], yi = x[2 * i + 1];
    const float g = kPref * expf(-0.5f * (xi * xi + yi * yi));
    float hx[FF_KMAX], hy[FF_KMAX];
    hermite<FF_KMAX>(xi, hx);
    hermite<FF_KMAX>(yi, hy);
    const bool up_i = i < occ.nup;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const bool same = up_i == (j < occ.nup);
      D[i][j] = same ? g * select_order<FF_KMAX>(hx, occ.nx[j]) *
                           select_order<FF_KMAX>(hy, occ.ny[j])
                     : 0.f;
    }
  }
  return ge_logabsdet2<N>(D);
}

template <int N>
__global__ void __launch_bounds__(128) metropolis_chains_kernel(
    const float* __restrict__ x0, const float* __restrict__ tau0,
    float* __restrict__ xs, float* __restrict__ logps, float* __restrict__ rates,
    float* __restrict__ tau_out, const float* __restrict__ normals,
    const float* __restrict__ uniforms, int B, Occ occ, uint32_t seed,
    int steps, int segments, float target, float gain, int reinit) {
  constexpr int D = 2 * N;
  constexpr int NU = D + 1;  // d Box-Muller uniforms + 1 accept uniform
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= B) return;
  const size_t Bs = (size_t)B;

  float x[D];
#pragma unroll
  for (int c = 0; c < D; ++c) x[c] = x0[c * Bs + w];
  float tau = tau0[w];
  float logp = slater_logp<N>(x, occ);

  for (int s = 0; s < segments; ++s) {
    if (reinit && s > 0) {
      float z[D];
      if (normals) {
#pragma unroll
        for (int c = 0; c < D; ++c)
          z[c] = normals[(((size_t)s * (steps + 1) + steps) * D + c) * Bs + w];
      } else {
        float u[NU];
        philox_uniforms<NU>(u, seed, (uint32_t)w, (uint32_t)steps, (uint32_t)s);
        box_muller<D, NU>(u, z);
      }
#pragma unroll
      for (int c = 0; c < D; ++c) x[c] = z[c];
      logp = slater_logp<N>(x, occ);
    }
    float acc = 0.f;
    for (int t = 0; t < steps; ++t) {
      float z[D];
      float ua;
      if (normals) {
#pragma unroll
        for (int c = 0; c < D; ++c)
          z[c] = normals[(((size_t)s * (steps + 1) + t) * D + c) * Bs + w];
        ua = uniforms[((size_t)s * steps + t) * Bs + w];
      } else {
        float u[NU];
        philox_uniforms<NU>(u, seed, (uint32_t)w, (uint32_t)t, (uint32_t)s);
        box_muller<D, NU>(u, z);
        ua = u[D];
      }
      float xn[D];
#pragma unroll
      for (int c = 0; c < D; ++c) xn[c] = __fadd_rn(x[c], __fmul_rn(tau, z[c]));
      const float lpn = slater_logp<N>(xn, occ);
      const bool accept = ua < expf(fminf(lpn - logp, 0.f));
      if (accept) {
#pragma unroll
        for (int c = 0; c < D; ++c) x[c] = xn[c];
        logp = lpn;
        acc += 1.f;
      }
    }
    const float rate = acc / (float)(steps > 1 ? steps : 1);
#pragma unroll
    for (int c = 0; c < D; ++c) xs[((size_t)s * D + c) * Bs + w] = x[c];
    logps[(size_t)s * Bs + w] = logp;
    rates[(size_t)s * Bs + w] = rate;
    if (!reinit) tau = tau * expf(gain * (rate - target));
  }
  if (tau_out) tau_out[w] = tau;
}

template <int N>
cudaError_t launch(const float* x0, const float* tau0, float* xs, float* logps,
                   float* rates, float* tau_out, const float* normals,
                   const float* uniforms, int B, Occ occ, uint32_t seed, int steps,
                   int segments, float target, float gain, int reinit,
                   cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  metropolis_chains_kernel<N><<<blocks, threads, 0, stream>>>(
      x0, tau0, xs, logps, rates, tau_out, normals, uniforms, B, occ, seed,
      steps, segments, target, gain, reinit);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ff_metropolis_chains(
    const float* x0, const float* tau0, float* xs, float* logps, float* rates,
    float* tau_out, const float* normals, const float* uniforms, int B, int n,
    int nup, const int* nx, const int* ny, unsigned int seed, int steps,
    int segments, float target, float gain, int reinit, void* stream) {
  const Occ occ = make_occ(nx, ny, n, nup);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (n) {
    case 2: err = launch<2>(x0, tau0, xs, logps, rates, tau_out, normals, uniforms, B, occ, seed, steps, segments, target, gain, reinit, st); break;
    case 3: err = launch<3>(x0, tau0, xs, logps, rates, tau_out, normals, uniforms, B, occ, seed, steps, segments, target, gain, reinit, st); break;
    case 4: err = launch<4>(x0, tau0, xs, logps, rates, tau_out, normals, uniforms, B, occ, seed, steps, segments, target, gain, reinit, st); break;
    case 5: err = launch<5>(x0, tau0, xs, logps, rates, tau_out, normals, uniforms, B, occ, seed, steps, segments, target, gain, reinit, st); break;
    case 6: err = launch<6>(x0, tau0, xs, logps, rates, tau_out, normals, uniforms, B, occ, seed, steps, segments, target, gain, reinit, st); break;
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
    const int* nx, const int* ny, unsigned int seed, int steps, void* stream) {
  return ff_metropolis_chains(x0, tau, x, logp, acc, nullptr, normals,
                              uniforms, B, n, nup, nx, ny, seed, steps, 1,
                              0.f, 0.f, 0, stream);
}
