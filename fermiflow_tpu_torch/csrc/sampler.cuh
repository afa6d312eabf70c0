// Device code shared by the Metropolis samplers (metropolis.cu and
// metropolis_ms.cu): the counter-based Philox4x32-10 stream, Box-Muller
// normals and the pivoted-elimination log|det|.
#pragma once

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

}  // namespace
