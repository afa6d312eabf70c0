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
// launch.
//
// Design: the ground-state sampler's (metropolis.cu), whose device code it
// shares (sampler.cuh): one thread per walker, everything in registers,
// Philox4x32-10 keyed by (seed, walker) with counter (draw, step, 0).  The
// walker's N (nx, ny) pairs are read once before the chain and stay in
// registers (the counterpart of the TPU kernel's one-hot masks hoisted out
// of its loop).  Orbital values are picked from the Hermite table by
// unrolled compare-selects, never by indexing a register array with a
// per-walker number, which would send the array to local memory.  The
// Hermite depth K is a template parameter.  A quantum number outside
// [0, K) turns the walker's outputs into NaN rather than a wrong chain.
#include "sampler.cuh"

namespace {

template <int N, int K>
__device__ __forceinline__ float slater_logp_ms(const float (&x)[2 * N],
                                                const int (&qx)[N],
                                                const int (&qy)[N]) {
  float D[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float xi = x[2 * i], yi = x[2 * i + 1];
    const float g = kPref * expf(-0.5f * (xi * xi + yi * yi));
    float hx[K], hy[K];
    hermite<K>(xi, hx);
    hermite<K>(yi, hy);
#pragma unroll
    for (int j = 0; j < N; ++j)
      D[i][j] = g * select_order<K>(hx, qx[j]) * select_order<K>(hy, qy[j]);
  }
  return ge_logabsdet2<N>(D);
}

template <int N, int K>
__global__ void __launch_bounds__(128) metropolis_ms_kernel(
    const float* __restrict__ x0, const float* __restrict__ tau0,
    const int* __restrict__ nx, const int* __restrict__ ny,
    float* __restrict__ x_out, float* __restrict__ logp_out,
    float* __restrict__ acc_out, const float* __restrict__ normals,
    const float* __restrict__ uniforms, int B, uint32_t seed, int steps) {
  constexpr int D = 2 * N;
  constexpr int NU = D + 1;  // d Box-Muller uniforms + 1 accept uniform
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= B) return;
  const size_t Bs = (size_t)B;

  int qx[N], qy[N];
  bool ok = true;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    qx[j] = nx[j * Bs + w];
    qy[j] = ny[j * Bs + w];
    ok = ok && qx[j] >= 0 && qx[j] < K && qy[j] >= 0 && qy[j] < K;
  }
  float x[D];
#pragma unroll
  for (int c = 0; c < D; ++c) x[c] = x0[c * Bs + w];
  const float tau = tau0[w];
  float logp = slater_logp_ms<N, K>(x, qx, qy);

  float acc = 0.f;
  for (int t = 0; t < steps; ++t) {
    float z[D];
    float ua;
    if (normals) {
#pragma unroll
      for (int c = 0; c < D; ++c) z[c] = normals[((size_t)t * D + c) * Bs + w];
      ua = uniforms[(size_t)t * Bs + w];
    } else {
      float u[NU];
      philox_uniforms<NU>(u, seed, (uint32_t)w, (uint32_t)t, 0u);
      box_muller<D, NU>(u, z);
      ua = u[D];
    }
    float xn[D];
#pragma unroll
    for (int c = 0; c < D; ++c) xn[c] = __fadd_rn(x[c], __fmul_rn(tau, z[c]));
    const float lpn = slater_logp_ms<N, K>(xn, qx, qy);
    const bool accept = ua < expf(fminf(lpn - logp, 0.f));
    if (accept) {
#pragma unroll
      for (int c = 0; c < D; ++c) x[c] = xn[c];
      logp = lpn;
      acc += 1.f;
    }
  }
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int c = 0; c < D; ++c) x_out[c * Bs + w] = ok ? x[c] : nan;
  logp_out[w] = ok ? logp : nan;
  acc_out[w] = ok ? acc / (float)(steps > 1 ? steps : 1) : nan;
}

template <int N, int K>
cudaError_t launch(const float* x0, const float* tau, const int* nx,
                   const int* ny, float* x, float* logp, float* acc,
                   const float* normals, const float* uniforms, int B,
                   uint32_t seed, int steps, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  metropolis_ms_kernel<N, K><<<blocks, threads, 0, stream>>>(
      x0, tau, nx, ny, x, logp, acc, normals, uniforms, B, seed, steps);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_k(int kdepth, const float* x0, const float* tau,
                     const int* nx, const int* ny, float* x, float* logp,
                     float* acc, const float* normals, const float* uniforms,
                     int B, uint32_t seed, int steps, cudaStream_t st) {
  switch (kdepth) {
    case 4: return launch<N, 4>(x0, tau, nx, ny, x, logp, acc, normals, uniforms, B, seed, steps, st);
    case 5: return launch<N, 5>(x0, tau, nx, ny, x, logp, acc, normals, uniforms, B, seed, steps, st);
    case 6: return launch<N, 6>(x0, tau, nx, ny, x, logp, acc, normals, uniforms, B, seed, steps, st);
    case 8: return launch<N, 8>(x0, tau, nx, ny, x, logp, acc, normals, uniforms, B, seed, steps, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x0 (d, B), tau (B,), nx/ny (n, B) int32 -> x (d, B), logp (B,), acc (B,).
// kdepth is the compiled Hermite depth (4, 5, 6 or 8).  Injected noise, when
// given, is normals (steps, d, B) and uniforms (steps, B).
extern "C" int ff_metropolis_multistate(
    const float* x0, const float* tau, const int* nx, const int* ny, float* x,
    float* logp, float* acc, const float* normals, const float* uniforms,
    int B, int n, int kdepth, unsigned int seed, int steps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (n) {
    case 2: err = launch_k<2>(kdepth, x0, tau, nx, ny, x, logp, acc, normals, uniforms, B, seed, steps, st); break;
    case 3: err = launch_k<3>(kdepth, x0, tau, nx, ny, x, logp, acc, normals, uniforms, B, seed, steps, st); break;
    case 4: err = launch_k<4>(kdepth, x0, tau, nx, ny, x, logp, acc, normals, uniforms, B, seed, steps, st); break;
    case 5: err = launch_k<5>(kdepth, x0, tau, nx, ny, x, logp, acc, normals, uniforms, B, seed, steps, st); break;
    case 6: err = launch_k<6>(kdepth, x0, tau, nx, ny, x, logp, acc, normals, uniforms, B, seed, steps, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
