// Closed-form REINFORCE adjoint: the flow-parameter gradient of
// sum_i w_i log p_theta(x_i) with the samples held fixed.
//
// Replaces: fermiflow_tpu/ops/pallas_reinforce.py
//   reinforce_flow_grad_pallas (kernel _reinforce_kernel, RHS
//   _adjoint_rhs_and_sources).
//
// Integrates backward from t1 to t0 (h = (t0 - t1)/steps < 0) on the flow's
// grid:  dx/dt = v(x),  da/dt = -A^T a + w grad(div),  a(t1) = -w g,
// theta_bar = int [(dv/dtheta)^T a - w d(div)/dtheta] dt, for the eta and
// mu MLPs (w2, w1, b1 rows; 3 x 50 + 3 x 50 = 300 at the production width).
//
// What bounds it on the H100: arithmetic.  Per walker and stage the hidden
// loop evaluates one sigmoid and ~25 flops per (pair, unit); device traffic
// is 25 floats per walker in and 12 out, plus the 300-row partials.
//
// Design: one thread per walker, 32 walkers per block; (x, a), the stage
// input, the dopri5 slopes, the pair scratch and the walker's own 300
// theta accumulators live in dynamic shared memory as [entry][walker]
// columns.  The TPU kernel summed theta across walker blocks in one output
// block because its grid runs in order; Hopper blocks run in no order, so
// each block reduces its own walkers in a fixed order into one row of a
// (num_blocks, nq) partials buffer, and a second kernel sums the rows in a
// fixed pairwise order.  No float atomics: the gradient is bitwise
// reproducible.
// Walkers past B carry w = 0 and contribute exactly zero.
#include "common.cuh"

namespace {

constexpr int BW = 32;

template <int N>
struct Layout {
  static constexpr int D = 2 * N;
  static constexpr int P = N * (N - 1) / 2;
  static constexpr int S = 2 * D;  // x, a
};

#define COL(off) sm[(off) * BW + t]

// One evaluation of (dx/dt, da/dt) into `out`, and q += bw * theta integrand
// when bw != 0.  Pair scratch at `pr` (7 P columns + 3 P accumulators),
// one-body scratch at `mr` (6 N columns).
template <int N>
__device__ void adjoint_rhs(float* sm, int t, int in, int out, int q_off,
                            int pr, int mr, float w, float bw, const float* ew1,
                            const float* eb1, const float* ew2, int de,
                            const float* mw1, const float* mb1, const float* mw2,
                            int dm) {
  using L = Layout<N>;
  constexpr int D = L::D, P = L::P;
  const bool acc_q = bw != 0.f;
  // Pair geometry: u0, u1, da0, da1, r, s = u.da, w r; then e0, e1, e2.
  {
    int p = 0;
    for (int i = 0; i < N; ++i) {
      for (int j = i + 1; j < N; ++j, ++p) {
        const float u0 = COL(in + 2 * i) - COL(in + 2 * j);
        const float u1 = COL(in + 2 * i + 1) - COL(in + 2 * j + 1);
        const float d0 = COL(in + D + 2 * i) - COL(in + D + 2 * j);
        const float d1 = COL(in + D + 2 * i + 1) - COL(in + D + 2 * j + 1);
        const float r = sqrtf(u0 * u0 + u1 * u1);
        COL(pr + 0 * P + p) = u0;
        COL(pr + 1 * P + p) = u1;
        COL(pr + 2 * P + p) = d0;
        COL(pr + 3 * P + p) = d1;
        COL(pr + 4 * P + p) = r;
        COL(pr + 5 * P + p) = u0 * d0 + u1 * d1;
        COL(pr + 6 * P + p) = w * r;
        COL(pr + 7 * P + p) = 0.f;
        COL(pr + 8 * P + p) = 0.f;
        COL(pr + 9 * P + p) = 0.f;
      }
    }
  }
  for (int hh = 0; hh < de; ++hh) {
    const float w1h = ew1[hh], w2h = ew2[hh], b1h = eb1[hh];
    float t_ss = 0.f, t_sd = 0.f, t_srd = 0.f, t_s = 0.f, t_d = 0.f;
    float t_wrd = 0.f, t_wrd2 = 0.f, t_wr2d2 = 0.f;
    for (int p = 0; p < P; ++p) {
      const float r = COL(pr + 4 * P + p), sp = COL(pr + 5 * P + p);
      const float wr = COL(pr + 6 * P + p);
      const float s = sigmoidf_(r * w1h + b1h);
      const float s1 = s * (1.f - s);
      const float s2 = s1 * (1.f - 2.f * s);
      COL(pr + 7 * P + p) += s * w2h;
      COL(pr + 8 * P + p) += s1 * (w2h * w1h);
      COL(pr + 9 * P + p) += s2 * (w2h * w1h * w1h);
      t_ss += sp * s;
      t_sd += sp * s1;
      t_srd += (sp * r) * s1;
      t_s += s;
      t_d += s1;
      t_wrd += wr * s1;
      t_wrd2 += wr * s2;
      t_wr2d2 += (wr * r) * s2;
    }
    if (acc_q) {
      COL(q_off + hh) += bw * (t_ss - 2.f * w1h * t_wrd - 4.f * (w * t_s));
      COL(q_off + de + hh) += bw * (w2h * (t_srd - 6.f * t_wrd - 2.f * w1h * t_wr2d2));
      COL(q_off + 2 * de + hh) += bw * (w2h * (t_sd - 2.f * w1h * t_wrd2 - 4.f * (w * t_d)));
    }
  }
  for (int c = 0; c < D; ++c) {
    COL(out + c) = 0.f;
    COL(out + D + c) = 0.f;
  }
  {
    int p = 0;
    for (int i = 0; i < N; ++i) {
      for (int j = i + 1; j < N; ++j, ++p) {
        const float ua = COL(pr + p), ub = COL(pr + P + p);
        const float r = COL(pr + 4 * P + p), iv = 1.f / r;
        const float e0 = COL(pr + 7 * P + p), e1 = COL(pr + 8 * P + p);
        const float e2 = COL(pr + 9 * P + p);
        COL(out + 2 * i) += e0 * ua;
        COL(out + 2 * i + 1) += e0 * ub;
        COL(out + 2 * j) -= e0 * ua;
        COL(out + 2 * j + 1) -= e0 * ub;
        const float cu = e1 * iv * COL(pr + 5 * P + p);
        const float m0 = cu * ua + e0 * COL(pr + 2 * P + p);
        const float m1 = cu * ub + e0 * COL(pr + 3 * P + p);
        const float cg = (2.f * (e2 * r + 3.f * e1)) * iv * w;
        COL(out + D + 2 * i) = COL(out + D + 2 * i) - m0 + cg * ua;
        COL(out + D + 2 * i + 1) = COL(out + D + 2 * i + 1) - m1 + cg * ub;
        COL(out + D + 2 * j) = COL(out + D + 2 * j) + m0 - cg * ua;
        COL(out + D + 2 * j + 1) = COL(out + D + 2 * j + 1) + m1 - cg * ub;
      }
    }
  }
  if (dm > 0) {
    // rho, x.a, w rho, then m0, m1, m2 accumulators.
    for (int i = 0; i < N; ++i) {
      const float xa = COL(in + 2 * i), xb = COL(in + 2 * i + 1);
      const float rho = sqrtf(xa * xa + xb * xb);
      COL(mr + i) = rho;
      COL(mr + N + i) = xa * COL(in + D + 2 * i) + xb * COL(in + D + 2 * i + 1);
      COL(mr + 2 * N + i) = w * rho;
      COL(mr + 3 * N + i) = 0.f;
      COL(mr + 4 * N + i) = 0.f;
      COL(mr + 5 * N + i) = 0.f;
    }
    const int qm = q_off + 3 * de;
    for (int hh = 0; hh < dm; ++hh) {
      const float w1h = mw1[hh], w2h = mw2[hh], b1h = mb1[hh];
      float t_ss = 0.f, t_sd = 0.f, t_srd = 0.f, t_s = 0.f, t_d = 0.f;
      float t_wrd = 0.f, t_wrd2 = 0.f, t_wr2d2 = 0.f;
      for (int i = 0; i < N; ++i) {
        const float rho = COL(mr + i), sx = COL(mr + N + i), wr = COL(mr + 2 * N + i);
        const float s = sigmoidf_(rho * w1h + b1h);
        const float s1 = s * (1.f - s);
        const float s2 = s1 * (1.f - 2.f * s);
        COL(mr + 3 * N + i) += s * w2h;
        COL(mr + 4 * N + i) += s1 * (w2h * w1h);
        COL(mr + 5 * N + i) += s2 * (w2h * w1h * w1h);
        t_ss += sx * s;
        t_sd += sx * s1;
        t_srd += (sx * rho) * s1;
        t_s += s;
        t_d += s1;
        t_wrd += wr * s1;
        t_wrd2 += wr * s2;
        t_wr2d2 += (wr * rho) * s2;
      }
      if (acc_q) {
        COL(qm + hh) += bw * (t_ss - w1h * t_wrd - 2.f * (w * t_s));
        COL(qm + dm + hh) += bw * (w2h * (t_srd - 3.f * t_wrd - w1h * t_wr2d2));
        COL(qm + 2 * dm + hh) += bw * (w2h * (t_sd - w1h * t_wrd2 - 2.f * (w * t_d)));
      }
    }
    for (int i = 0; i < N; ++i) {
      const float rho = COL(mr + i), iv = 1.f / rho;
      const float xa = COL(in + 2 * i), xb = COL(in + 2 * i + 1);
      const float m0 = COL(mr + 3 * N + i), m1 = COL(mr + 4 * N + i);
      const float m2 = COL(mr + 5 * N + i);
      COL(out + 2 * i) += m0 * xa;
      COL(out + 2 * i + 1) += m0 * xb;
      const float cu = m1 * iv * COL(mr + N + i);
      const float cg = (m2 * rho + 3.f * m1) * iv * w;
      COL(out + D + 2 * i) =
          COL(out + D + 2 * i) - (cu * xa + m0 * COL(in + D + 2 * i)) + cg * xa;
      COL(out + D + 2 * i + 1) =
          COL(out + D + 2 * i + 1) - (cu * xb + m0 * COL(in + D + 2 * i + 1)) + cg * xb;
    }
  }
}

template <int N>
__global__ void __launch_bounds__(BW) reinforce_kernel(
    const float* __restrict__ x1, const float* __restrict__ ghat,
    const float* __restrict__ wts_in, float* __restrict__ z_out,
    float* __restrict__ partials, int B, const float* __restrict__ eta_w1,
    const float* __restrict__ eta_b1, const float* __restrict__ eta_w2, int de,
    const float* __restrict__ mu_w1, const float* __restrict__ mu_b1,
    const float* __restrict__ mu_w2, int dm, int steps, Tableau hab) {
  using L = Layout<N>;
  constexpr int D = L::D, P = L::P, S = L::S;
  extern __shared__ float sm[];
  const int t = threadIdx.x;
  const int w_idx = blockIdx.x * BW + t;
  const bool live = w_idx < B;
  const int nq = 3 * (de + dm);
  const int st = 0, tmp = S, ks = 2 * S, q_off = ks + hab.stages * S;
  const int pr = q_off + nq, mr = pr + 10 * P;
  const int per_walker = mr + 6 * N;
  float* wts = sm + (size_t)per_walker * BW;
  for (int j = t; j < de; j += BW) {
    wts[j] = eta_w1[j];
    wts[de + j] = eta_b1[j];
    wts[2 * de + j] = eta_w2[j];
  }
  for (int j = t; j < dm; j += BW) {
    wts[3 * de + j] = mu_w1[j];
    wts[3 * de + dm + j] = mu_b1[j];
    wts[3 * de + 2 * dm + j] = mu_w2[j];
  }
  for (int r = 0; r < nq; ++r) COL(q_off + r) = 0.f;
  __syncthreads();
  const size_t Bs = (size_t)B;

  if (live) {
    const float w = wts_in[w_idx];
    for (int c = 0; c < D; ++c) {
      COL(st + c) = x1[c * Bs + w_idx];
      COL(st + D + c) = -w * ghat[c * Bs + w_idx];
    }
    for (int step = 0; step < steps; ++step) {
      for (int i = 0; i < hab.stages; ++i) {
        int in = st;
        if (i > 0) {
          for (int e = 0; e < S; ++e) {
            float acc = COL(st + e);
            for (int j = 0; j < i; ++j)
              if (hab.a[i][j] != 0.f) acc = acc + hab.a[i][j] * COL(ks + j * S + e);
            COL(tmp + e) = acc;
          }
          in = tmp;
        }
        // h < 0: -h b_i is the positive quadrature weight.
        adjoint_rhs<N>(sm, t, in, ks + i * S, q_off, pr, mr, w, -hab.b[i],
                       wts, wts + de, wts + 2 * de, de, wts + 3 * de,
                       wts + 3 * de + dm, wts + 3 * de + 2 * dm, dm);
      }
      for (int e = 0; e < S; ++e) {
        float acc = COL(st + e);
        for (int j = 0; j < hab.stages; ++j)
          if (hab.b[j] != 0.f) acc = acc + hab.b[j] * COL(ks + j * S + e);
        COL(st + e) = acc;
      }
    }
    for (int c = 0; c < D; ++c) z_out[c * Bs + w_idx] = COL(st + c);
  }
  __syncthreads();
  // Fixed-order pairwise reduction of this block's walkers.
  for (int r = t; r < nq; r += BW) {
    float v[BW];
#pragma unroll
    for (int k = 0; k < BW; ++k) v[k] = sm[(q_off + r) * BW + k];
#pragma unroll
    for (int half = BW / 2; half > 0; half /= 2) {
#pragma unroll
      for (int k = 0; k < half; ++k) v[k] += v[k + half];
    }
    partials[(size_t)blockIdx.x * nq + r] = v[0];
  }
}

constexpr int kReduceThreads = 256;

// grads[r] = sum over blocks of partials[b][r]: one CUDA block per row, a
// strided per-thread sum, then a pairwise tree in shared memory.  The order
// is fixed, so the sum is the same on every run.
__global__ void __launch_bounds__(kReduceThreads) reinforce_reduce_kernel(
    const float* __restrict__ partials, float* __restrict__ grads, int nblocks,
    int nq) {
  __shared__ float buf[kReduceThreads];
  const int r = blockIdx.x, t = threadIdx.x;
  float s = 0.f;
  for (int b = t; b < nblocks; b += kReduceThreads) s += partials[(size_t)b * nq + r];
  buf[t] = s;
  __syncthreads();
  for (int half = kReduceThreads / 2; half > 0; half /= 2) {
    if (t < half) buf[t] += buf[t + half];
    __syncthreads();
  }
  if (t == 0) grads[r] = buf[0];
}

template <int N>
cudaError_t launch(const float* x1, const float* ghat, const float* w,
                   float* z_out, float* partials, int B, const float* ew1,
                   const float* eb1, const float* ew2, int de, const float* mw1,
                   const float* mb1, const float* mw2, int dm, int steps,
                   const Tableau& hab, cudaStream_t stream) {
  using L = Layout<N>;
  const size_t per_walker = (size_t)(2 + hab.stages) * L::S + 3 * (de + dm) +
                            10 * L::P + 6 * N;
  const size_t bytes = (per_walker * BW + 3 * (size_t)(de + dm)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      reinforce_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (B + BW - 1) / BW;
  reinforce_kernel<N><<<blocks, BW, bytes, stream>>>(
      x1, ghat, w, z_out, partials, B, ew1, eb1, ew2, de, mw1, mb1, mw2, dm,
      steps, hab);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ff_reinforce_blocks(int B) { return (B + BW - 1) / BW; }

extern "C" int ff_reinforce_adjoint(const float* x1, const float* ghat,
                                    const float* w, float* z_out, float* partials,
                                    int B, int n, const float* eta_w1,
                                    const float* eta_b1, const float* eta_w2,
                                    int d_eta, const float* mu_w1,
                                    const float* mu_b1, const float* mu_w2,
                                    int d_mu, int steps, int stages,
                                    const float* h_a, const float* h_b,
                                    void* stream) {
  const Tableau hab = make_tableau(stages, h_a, h_b);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
#define FF_RF(NN)                                                             \
  launch<NN>(x1, ghat, w, z_out, partials, B, eta_w1, eta_b1, eta_w2, d_eta, \
             mu_w1, mu_b1, mu_w2, d_mu, steps, hab, st)
  switch (n) {
    case 2: err = FF_RF(2); break;
    case 3: err = FF_RF(3); break;
    case 4: err = FF_RF(4); break;
    case 5: err = FF_RF(5); break;
    case 6: err = FF_RF(6); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef FF_RF
  return (int)err;
}

extern "C" int ff_reinforce_reduce(const float* partials, float* grads,
                                   int nblocks, int nq, void* stream) {
  reinforce_reduce_kernel<<<nq, kReduceThreads, 0, (cudaStream_t)stream>>>(
      partials, grads, nblocks, nq);
  return (int)cudaGetLastError();
}
