// Multi-segment Metropolis sampler of the free-fermion |det|^2 density.
//
// Replaces: fermiflow_tpu/ops/pallas_metropolis.py
//   metropolis_free_fermion_chains (kernel _metropolis_multichain_kernel).
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
#include "common.cuh"

namespace {

constexpr float kPref = 0.56418958354775628f;  // pi^{-1/2}
constexpr float kTwoPi = 6.28318530717958648f;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// Uniform in (0, 1) from 24 random bits, floored at 1e-12 (log(0) guard of
// the TPU kernel's _uniform01).
__device__ __forceinline__ float bits_to_uniform(uint32_t b) {
  return fmaxf((float)(b >> 8) * (1.f / 16777216.f), 1e-12f);
}

// NU uniforms for (segment, step) of one walker.
template <int NU>
__device__ __forceinline__ void philox_uniforms(float (&u)[NU], uint32_t seed,
                                                uint32_t walker, uint32_t step,
                                                uint32_t segment) {
  const uint2 key = make_uint2(seed, walker);
#pragma unroll
  for (int q = 0; q < (NU + 3) / 4; ++q) {
    const uint4 r = philox4x32_10(make_uint4((uint32_t)q, step, segment, 0u), key);
    const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * q + e < NU) u[4 * q + e] = bits_to_uniform(bits[e]);
  }
}

// d standard normals by Box-Muller: pair k uses u[k], u[k + d/2];
// coordinate k gets r cos, coordinate k + d/2 gets r sin (TPU order).
template <int D, int NU>
__device__ __forceinline__ void box_muller(const float (&u)[NU], float (&z)[D]) {
#pragma unroll
  for (int k = 0; k < D / 2; ++k) {
    const float r = sqrtf(-2.f * logf(u[k]));
    float s, c;
    sincosf(kTwoPi * u[k + D / 2], &s, &c);
    z[k] = r * c;
    z[k + D / 2] = r * s;
  }
}

// 2 log|det D| by pivoted elimination without row swaps (the TPU kernel's
// _ge_logabsdet): pivot = first row with the largest |entry| among unused.
template <int N>
__device__ __forceinline__ float ge_logabsdet2(float (&D)[N][N]) {
  bool used[N];
#pragma unroll
  for (int i = 0; i < N; ++i) used[i] = false;
  float logabs = 0.f;
#pragma unroll
  for (int col = 0; col < N; ++col) {
    float best = -2.f;
    int bi = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float cand = used[i] ? -1.f : fabsf(D[i][col]);
      if (cand > best) { best = cand; bi = i; }
    }
    float pv = 0.f;
    float prow[N];
#pragma unroll
    for (int j = 0; j < N; ++j) prow[j] = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const bool isp = (bi == i);
      pv = isp ? D[i][col] : pv;
#pragma unroll
      for (int j = col; j < N; ++j) prow[j] = isp ? D[i][j] : prow[j];
    }
    logabs += logf(fmaxf(fabsf(pv), 1e-30f));
    const float sp = fabsf(pv) > 1e-30f ? pv : 1.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const bool isp = (bi == i);
      const float m = (!used[i] && !isp) ? D[i][col] / sp : 0.f;
#pragma unroll
      for (int j = col + 1; j < N; ++j) D[i][j] = D[i][j] - m * prow[j];
      used[i] = used[i] || isp;
    }
  }
  return 2.f * logabs;
}

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
  tau_out[w] = tau;
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
