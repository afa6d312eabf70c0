// Device code shared by the Metropolis samplers (metropolis.cu and
// metropolis_ms.cu): a group of G = kSamplerLanes lanes of one warp walks
// one chain.  The
// counter-based Philox4x32-10 stream, Box-Muller normals and the
// pivoted-elimination log|det| are dealt over the group's lanes and give
// the numbers that one thread walking the whole chain would give.
//
// Lane l of a group owns particles l, l + G, ... (slot s holds particle
// l + s G): their coordinates, Gaussian factors, Hermite tables and rows of
// the Slater matrix.  A lane whose slot lies past the last particle
// computes on a copy of particle N - 1 and stores nothing.  Every lane of
// the warp runs every shuffle and ballot (full mask, width G), so a kernel
// never lets a lane leave early: ragged batches clamp the walker index.
#pragma once

#include "common.cuh"

namespace {

constexpr float kPref = 0.56418958354775628f;  // pi^{-1/2}
constexpr float kTwoPi = 6.28318530717958648f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kSamplerThreads = 128;
constexpr int kSamplerMinBlocks = 4;  // resident blocks per SM: <= 128 registers
// Lanes per chain (ops/metropolis.py: LANES).  8 beat 4 on every entry at
// the paths' shapes; tests build the sources at 4 as well, where the same
// Philox stream must give the same chains.
#ifndef FF_SAMPLER_LANES
#define FF_SAMPLER_LANES 8
#endif
constexpr int kSamplerLanes = FF_SAMPLER_LANES;
constexpr int kSamplerWalkers = kSamplerThreads / kSamplerLanes;  // per block

// Blocks of a sampler grid over B walkers, and the warps they hold.
inline int sampler_blocks(int B) { return (B + kSamplerWalkers - 1) / kSamplerWalkers; }
inline int sampler_grid_warps(int B) { return sampler_blocks(B) * (kSamplerThreads / 32); }

template <int N, int G>
struct Group {
  static_assert(32 % G == 0, "a lane group divides a warp");
  static constexpr int D = 2 * N;
  static constexpr int NU = D + 1;            // d Box-Muller uniforms + 1 accept uniform
  static constexpr int Q = (NU + 3) / 4;      // Philox calls per step, call q on lane q
  static constexpr int S = (N + G - 1) / G;   // particle slots (and Box-Muller pairs) per lane
  static_assert(Q <= G, "one Philox call per lane");
};

// The lane's particle in slot s, clamped to a real one.
template <int N, int G>
__device__ __forceinline__ int slot_particle(int lane, int s) {
  return min(lane + s * G, N - 1);
}

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

// Uniform u[j] of the step: word j % 4 of Philox call j / 4, which runs on
// lane j / 4.  Each lane names its own j.
template <int G>
__device__ __forceinline__ float uniform_at(const uint4& r, int j) {
  const int src = j >> 2, e = j & 3;
  const uint32_t a = __shfl_sync(kFullMask, r.x, src, G);
  const uint32_t b = __shfl_sync(kFullMask, r.y, src, G);
  const uint32_t c = __shfl_sync(kFullMask, r.z, src, G);
  const uint32_t d = __shfl_sync(kFullMask, r.w, src, G);
  return bits_to_uniform(e == 0 ? a : e == 1 ? b : e == 2 ? c : d);
}

// Step `step` of segment `seg` of walker `walker`: this lane's coordinates'
// normals z[s][a] (coordinate a of its slot-s particle) and the accept
// uniform ua.  The stream is one thread's: uniforms u[0..d] with u[4q + e]
// word e of Philox call q (counter (q, step, seg, 0), key (seed, walker));
// Box-Muller pair k from u[k], u[k + N] gives coordinate k r cos and
// coordinate k + N r sin (TPU order); ua = u[d].  Call q runs on lane q and
// pair k on lane k % G; shuffles bring uniforms and normals to their owners.
template <int N, int G>
__device__ __forceinline__ void draw_step(uint32_t seed, uint32_t walker, uint32_t step,
                                          uint32_t seg, int lane,
                                          float (&z)[Group<N, G>::S][2], float& ua) {
  using L = Group<N, G>;
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (lane < L::Q)
    r = philox4x32_10(make_uint4((uint32_t)lane, step, seg, 0u), make_uint2(seed, walker));
  float zc[L::S], zs[L::S];
#pragma unroll
  for (int p = 0; p < L::S; ++p) {
    const int k = min(lane + p * G, N - 1);
    const float u1 = uniform_at<G>(r, k);
    const float u2 = uniform_at<G>(r, k + N);
    const float rad = sqrtf(-2.f * logf(u1));
    float sn, cs;
    sincosf(kTwoPi * u2, &sn, &cs);
    zc[p] = rad * cs;
    zs[p] = rad * sn;
  }
  {
    constexpr int e = L::D & 3;
    const uint32_t word = e == 0 ? r.x : e == 1 ? r.y : e == 2 ? r.z : r.w;
    ua = bits_to_uniform(__shfl_sync(kFullMask, word, L::D >> 2, G));
  }
#pragma unroll
  for (int s = 0; s < L::S; ++s) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int c = 2 * slot_particle<N, G>(lane, s) + a;
      const bool is_cos = c < N;
      const int k = is_cos ? c : c - N;
      float v = 0.f;
#pragma unroll
      for (int p = 0; p < L::S; ++p) {
        const float vc = __shfl_sync(kFullMask, zc[p], k % G, G);
        const float vs = __shfl_sync(kFullMask, zs[p], k % G, G);
        v = (k / G == p) ? (is_cos ? vc : vs) : v;
      }
      z[s][a] = v;
    }
  }
}

// 2 log|det D| by pivoted elimination without row swaps (the TPU kernel's
// _ge_logabsdet), the group's rows in D[s] (row lane + s G).  Pivot = the
// first row with the largest |entry| among unused ones: each lane offers
// its first such row (used rows offer -1), an xor-shuffle max gives the
// value and a ballot per slot the first lane, lowest slot first.  The
// pivot row goes out from its lane by shuffles; each lane eliminates its
// own rows with the one-thread expression, and every lane sums
// log|pivot| in column order, each log formed on lane col % G.
template <int N, int G>
__device__ __forceinline__ float group_logabsdet2(float (&D)[Group<N, G>::S][N], int lane) {
  using L = Group<N, G>;
  constexpr unsigned group_bits = G == 32 ? kFullMask : (1u << G) - 1u;
  const int base = (int)(threadIdx.x & 31) & ~(G - 1);
  bool used[L::S];
#pragma unroll
  for (int s = 0; s < L::S; ++s) used[s] = lane + s * G >= N;
  float piv[N];
#pragma unroll
  for (int col = 0; col < N; ++col) {
    float best = -2.f;
    int bs = 0;
#pragma unroll
    for (int s = 0; s < L::S; ++s) {
      const float cand = used[s] ? -1.f : fabsf(D[s][col]);
      if (cand > best) { best = cand; bs = s; }
    }
    float m = best;
#pragma unroll
    for (int o = 1; o < G; o <<= 1) m = fmaxf(m, __shfl_xor_sync(kFullMask, m, o, G));
    int pl = 0, ps = 0;
    bool found = false;
#pragma unroll
    for (int s = 0; s < L::S; ++s) {
      const unsigned tie =
          (__ballot_sync(kFullMask, best == m && bs == s) >> base) & group_bits;
      pl = (!found && tie) ? __ffs(tie) - 1 : pl;
      ps = (!found && tie) ? s : ps;
      found = found || tie;
    }
    float prow[N];
#pragma unroll
    for (int j = col; j < N; ++j) {
      float v = D[0][j];
#pragma unroll
      for (int s = 1; s < L::S; ++s) v = (ps == s) ? D[s][j] : v;
      prow[j] = __shfl_sync(kFullMask, v, pl, G);
    }
    const float pv = prow[col];
    piv[col] = pv;
    const float sp = fabsf(pv) > 1e-30f ? pv : 1.f;
#pragma unroll
    for (int s = 0; s < L::S; ++s) {
      const bool isp = lane == pl && s == ps;
      const float mult = (!used[s] && !isp) ? D[s][col] / sp : 0.f;
#pragma unroll
      for (int j = col + 1; j < N; ++j) D[s][j] = D[s][j] - mult * prow[j];
      used[s] = used[s] || isp;
    }
  }
  float lg[L::S];
#pragma unroll
  for (int s = 0; s < L::S; ++s) {
    const int c = lane + s * G;
    float v = piv[0];
#pragma unroll
    for (int cc = 1; cc < N; ++cc) v = (c == cc) ? piv[cc] : v;
    lg[s] = logf(fmaxf(fabsf(v), 1e-30f));
  }
  float logabs = 0.f;
#pragma unroll
  for (int c = 0; c < N; ++c) logabs += __shfl_sync(kFullMask, lg[c / G], c % G, G);
  return 2.f * logabs;
}

}  // namespace
