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
// What bounds it on the H100: FP32 and SFU issue in the hidden-unit loop
// (at N = 10 the loop is 93 % of the kernel's time; PERF.md).  Per walker
// and RK stage at N=6 with 50 hidden units it evaluates 21 MLP inputs x 50
// units = 1050 sigmoids (an exp and a reciprocal each) inside ~41
// kflop-equivalents (106 k at N = 10; portbench/counts.py reinforce_flops),
// 24 stages per launch, against 25 floats of device traffic in and 12 out
// per walker plus one 300-row partials row per block.  Kept in one
// thread's shared-memory columns the per-walker working set fit two warps
// per SM, which then ran bound by latency.
//
// Design: a group of G lanes of one warp shares a walker (32/G walkers per
// warp), 128-thread blocks, 4 blocks (16 warps) per SM at <= 128 registers
// with no spill from N = 7 (MIN_BLOCKS).
// - The first du - du % G hidden units of an MLP are dealt over the lanes,
//   unit h to lane h % G.  The lane that owns a unit loops over all of the
//   walker's MLP inputs itself, so it forms the unit's eight theta sums
//   over pairs (or particles) in registers and adds its three bw * (...)
//   rows to the walker's accumulators: no theta value crosses lanes until
//   the block's end.  Dealing the inputs instead (as the Hessian flow does)
//   would put those sums across lanes: 800 values a stage, or 300
//   accumulators per lane.
// - What crosses lanes is each input's field coefficients e0, e1, e2, a sum
//   over units: 3 (P + N) = 63 values a stage at N=6.  Each lane holds its
//   units' partials in registers and a reduce-scatter of log2(G) xor-shuffle
//   rounds leaves lane l with the totals of inputs l Q .. l Q + Q - 1
//   (pairs in np.triu_indices order, Q = ceil(P / G); particles likewise).
//   Each total is formed by one lane along a fixed tree: no float atomics,
//   and the same inputs give the same bits.
// - The last du % G units (2 of 50 at either width) would take a round of
//   their own on that many lanes while the others wait: at 16 lanes a
//   fourth round, a fifth of the kernel at N = 10.  Instead every lane runs
//   them on the Q inputs whose totals it holds after the reduce-scatter:
//   their coefficients go into those totals, their theta sums over the
//   lane's inputs into rows of the lane's own (3 (du % G) G floats a
//   walker), which fold_lane_rows adds into the walker's theta rows in a
//   fixed order at the end of the launch.
// - The sigmoid's reciprocal: 1 + exp(-z) < 2^126 whenever r |w1|max +
//   |b1|max < 80, and there rcp_in_range (common.cuh) is the division's own
//   result without the range check and branch that kept the compiler from
//   interleaving the sigmoid chains (as in the Hessian flow).  geometry
//   checks every input of the warp's walkers once a stage, one ballot, and
//   the stage runs the MLP step's copy for that path; out of range, the
//   division.
// - The 2D = 4N (x, a) state entries are dealt over the lanes, entry e to
//   (lane e % G, slot e / G).  Between stages a lane keeps its entries and
//   their six dopri5 slopes (7 E floats, lane_state) in the walker's shared
//   region, where they hold no register across the hidden-unit loop: in
//   registers they spilled at 128 (N = 6, 10).
// - Shared memory per walker holds the stage input, each input's geometry
//   (r, u.da, w r), each input's contribution to its particles' slopes, the
//   lanes' entries and slopes, the walker's 3 (d_eta + d_mu) theta
//   accumulators and the lanes' own rows (3.1 KB at N = 6, 5.3 KB at
//   N = 10): 51 and 44 KB a block, so registers, not shared memory, set the
//   occupancy.
//   Four __syncwarp per stage; no block-wide barrier after the set-up.  A
//   region's stride is G (mod 32) floats, so the walkers of a warp fall on
//   distinct banks.
// - Up to N = 6, 8 lanes and 16 walkers a block: 8192 walkers are 512
//   blocks, one wave of the 528 that 132 SMs hold.  From N = 7 (lanes_for),
//   16 lanes and 8 walkers a block: 1024 blocks, two waves (with 3 blocks
//   per SM, three).  At N = 10 a lane then keeps 3 of the 40 state entries,
//   as at N = 6, and the 45 pairs' field coefficients are totalled in 3
//   chunks of 16 inputs (kChunkInputs): a lane holds 48 partials at a time
//   instead of the 144 (6 pairs x 8 lanes x 3) of one pass.  Each chunk
//   adds its units' theta sums to the accumulators.
// Hopper blocks run in no order, so each block sums its walkers' theta
// rows in a fixed pairwise order into one row of a (num_blocks, nq)
// partials buffer, and a second kernel sums the rows in a fixed order.
// Walkers past B compute on a copy of walker B-1 with w = 0 and a = 0, add
// nothing to the accumulators and store nothing.
//
// The reduce pass moves ~0.6 MB and does no arithmetic to speak of: it is
// bound by latency.  Each thread owns one column (neighbouring threads read
// neighbouring addresses) and sums a strided set of rows, 32 row groups
// per block; one warp per column then adds the 32 group sums in a fixed
// butterfly.  ff_reinforce launches both passes from one host call.
#include "common.cuh"

namespace {

// Lanes per walker (ops/reinforce.py: lanes_for): 8 up to N = 6, 16 from
// N = 7 (the design note above).
__host__ __device__ constexpr int lanes_for(int n) { return n <= 6 ? 8 : 16; }
constexpr int THREADS = 128;
// Resident blocks per SM at every N: <= 128 registers, 16 warps per SM.
constexpr int MIN_BLOCKS = 4;
constexpr int TABLEAU = FF_MAXSTAGES * FF_MAXSTAGES + FF_MAXSTAGES;
// MLP inputs whose field-coefficient partials a lane holds at once: 16
// inputs x 3 coefficients = 48 registers, the partials of all 15 pairs at
// N = 6 on 8 lanes.  More inputs are taken in chunks of this many.
constexpr int kChunkInputs = 16;

template <int N, int G>
struct Layout {
  static_assert(32 % G == 0, "a lane group divides a warp");
  static constexpr int D = 2 * N;
  static constexpr int S = 2 * D;  // x, a
  static constexpr int P = N * (N - 1) / 2;
  static constexpr int E = (S + G - 1) / G;   // state entries per lane
  static constexpr int QP = (P + G - 1) / G;  // pair inputs per lane
  static constexpr int QN = (N + G - 1) / G;  // one-body inputs per lane
  // Pair inputs a lane totals per chunk, and the chunks: chunk c covers
  // pairs c G QC .. (c + 1) G QC - 1, lane l totals c G QC + l QC + k.
  static constexpr int QC = QP < kChunkInputs / G ? QP : kChunkInputs / G;
  static constexpr int NC = (P + G * QC - 1) / (G * QC);
  static_assert(G * QN <= kChunkInputs, "the one-body inputs fit one chunk");
  static constexpr int NW = THREADS / G;      // walkers per block
  // A walker's shared region, in floats (float4 fields 16-byte aligned).
  static constexpr int IN = 0;                   // stage-input x (D), a (D)
  static constexpr int GEO = (S + 3) / 4 * 4;    // pairs: (r, u.da, w r, 0)
  static constexpr int GEO1 = GEO + 4 * P;       // particles: (|x|, x.a, w|x|, 0)
  static constexpr int CELL = GEO1 + 4 * N;      // pairs: (dx_i, da_i), 2 + 2
  static constexpr int CELL1 = CELL + 4 * P;     // particles: (dx_i, da_i)
  // The lanes' state entries and slopes (lane_state).
  static constexpr int KS = CELL1 + 4 * N;
  static constexpr int Q = KS + (FF_MAXSTAGES + 1) * E * G;  // theta accumulators
};

// Rows a walker accumulates at MLP widths de, dm: its 3 (de + dm) theta
// rows, then each lane's own rows of the last de % G and dm % G units.
template <int G>
__host__ __device__ inline int walker_rows(int de, int dm) {
  return 3 * (de + dm) + 3 * G * (de % G + dm % G);
}

// A walker's region stride: = G (mod 32) floats, so the 32 / G walkers of
// a warp fall on distinct banks.
template <int N, int G>
__host__ __device__ inline int region_floats(int de, int dm) {
  return (Layout<N, G>::Q + walker_rows<G>(de, dm) + 31 - G) / 32 * 32 + G;
}

// Floats before the walkers' regions: the weights (eta then mu, a float4 of
// (w1, b1, w2, 0) per unit), eta's and mu's largest |w1| and |b1| (a
// float4), the tableau and the pair index table.
template <int N, int G>
__host__ __device__ inline int header_floats(int de, int dm) {
  return (4 * (de + dm + 1) + TABLEAU + Layout<N, G>::P + 3) / 4 * 4;
}

template <int N, int G>
size_t smem_bytes(int de, int dm) {
  using L = Layout<N, G>;
  return sizeof(float) *
         ((size_t)header_floats<N, G>(de, dm) + (size_t)L::NW * region_floats<N, G>(de, dm));
}

// Reduce-scatter over the lane group: on entry v holds this lane's partials
// of G * Q inputs; on return v[0 .. Q) holds the group's totals of inputs
// lane * Q .. lane * Q + Q - 1.  The round at HALF pairs lanes that differ
// in bit HALF / Q: each keeps the half of the remaining inputs that its bit
// names and adds the partner's partials of that half.
template <int HALF, int G, int Q>
__device__ __forceinline__ void reduce_scatter(float (&v)[G * Q][3], int lane) {
  if constexpr (HALF >= Q) {
    constexpr int m = HALF / Q;
    const bool upper = (lane & m) != 0;
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float lo = v[j][c], hi = v[j + HALF][c];
        v[j][c] = (upper ? hi : lo) + __shfl_xor_sync(0xffffffffu, upper ? lo : hi, m);
      }
    }
    reduce_scatter<HALF / 2, G, Q>(v, lane);
  }
}

// The sigmoid s of r w1 + b1 and its derivative factors s1 = s (1 - s),
// s2 = s1 (1 - 2 s).  The reciprocal: rcp_in_range where every input of the
// warp's walkers is in its range (kInRange, geometry), else the division.
template <bool kInRange>
__device__ __forceinline__ void sigmoid_terms(float r, float w1, float b1, float& s, float& s1,
                                              float& s2) {
  const float d = 1.f + expf(-(r * w1 + b1));
  s = kInRange ? rcp_in_range(d) : 1.f / d;
  s1 = s * (1.f - s);
  s2 = s1 * (1.f - 2.f * s);
}

// One hidden unit's sums over a set of MLP inputs g = (r, u.da, w r, 0).
struct UnitSums {
  float ss = 0.f, sd = 0.f, srd = 0.f, s = 0.f, d = 0.f, wrd = 0.f, wrd2 = 0.f, wr2d2 = 0.f;
  __device__ __forceinline__ void add(float4 g, float sv, float s1, float s2) {
    const float r = g.x, sp = g.y, wr = g.z;
    ss += sp * sv;
    sd += sp * s1;
    srd += (sp * r) * s1;
    s += sv;
    d += s1;
    wrd += wr * s1;
    wrd2 += wr * s2;
    wr2d2 += (wr * r) * s2;
  }
  // The unit's three theta rows (w2, w1, b1), times bw, into q0, q1, q2.
  // CP, CO: the divergence coefficients (2, 4 for pairs; 1, 2 for the
  // one-body term).
  template <int CP, int CO>
  __device__ __forceinline__ void rows(float w1h, float w2h, float w, float bw, float& q0,
                                       float& q1, float& q2) const {
    q0 += bw * (ss - (float)CP * w1h * wrd - (float)CO * (w * s));
    q1 += bw * (w2h * (srd - (float)(CP + CO) * wrd - (float)CP * w1h * wr2d2));
    q2 += bw * (w2h * (sd - (float)CP * w1h * wrd2 - (float)CO * (w * d)));
  }
};

// One MLP of du hidden units (weights wt) over the M inputs whose geometry
// is at geo.  The first du - du % G units are dealt round robin, unit h to
// lane h % G, which runs it over every input: its field coefficients into
// e[input] and, when acc_q, its theta rows into q (w2 rows at q, w1 rows at
// q + du, b1 rows at q + 2 du).  Then the group's totals, e[0 .. Q) for
// inputs lane * Q + k, and the last du % G units, each run by every lane on
// the inputs it totals: their coefficients into those totals and their
// theta rows, over this lane's inputs, into the lane's own rows at ql (row
// c of unit dealt + j at ql[(3 j + c) G]; fold_lane_rows adds them into q).
template <int M, int G, int Q, int CP, int CO, bool kInRange>
__device__ __forceinline__ void mlp_coefficients(const float4* geo, const float4* wt,
                                                 int du, int lane, float w, float bw,
                                                 bool acc_q, float* q, float* ql,
                                                 float (&e)[G * Q][3]) {
#pragma unroll
  for (int p = 0; p < G * Q; ++p) e[p][0] = e[p][1] = e[p][2] = 0.f;
  const int dealt = du - du % G;
  for (int hh = lane; hh < dealt; hh += G) {
    const float4 wu = wt[hh];
    const float w1h = wu.x, b1h = wu.y, w2h = wu.z;
    const float c1 = w2h * w1h, c2 = w2h * w1h * w1h;
    UnitSums t;
#pragma unroll
    for (int p = 0; p < M; ++p) {
      const float4 g = geo[p];
      float s, s1, s2;
      sigmoid_terms<kInRange>(g.x, w1h, b1h, s, s1, s2);
      e[p][0] += s * w2h;
      e[p][1] += s1 * c1;
      e[p][2] += s2 * c2;
      t.add(g, s, s1, s2);
    }
    if (acc_q) t.rows<CP, CO>(w1h, w2h, w, bw, q[hh], q[du + hh], q[2 * du + hh]);
  }
  reduce_scatter<G * Q / 2, G, Q>(e, lane);
  for (int hh = dealt; hh < du; ++hh) {
    const float4 wu = wt[hh];
    const float w1h = wu.x, b1h = wu.y, w2h = wu.z;
    const float c1 = w2h * w1h, c2 = w2h * w1h * w1h;
    UnitSums t;
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const int p = lane * Q + k;
      if (p < M) {
        const float4 g = geo[p];
        float s, s1, s2;
        sigmoid_terms<kInRange>(g.x, w1h, b1h, s, s1, s2);
        e[k][0] += s * w2h;
        e[k][1] += s1 * c1;
        e[k][2] += s2 * c2;
        t.add(g, s, s1, s2);
      }
    }
    float* qr = ql + 3 * (hh - dealt) * G + lane;
    if (acc_q) t.rows<CP, CO>(w1h, w2h, w, bw, qr[0], qr[G], qr[2 * G]);
  }
}

// Pair p = (i, j), i < j, in np.triu_indices order.
template <int N>
__device__ __forceinline__ int pair_index(int i, int j) {
  return i * (2 * N - i - 1) / 2 + (j - i - 1);
}

// Geometry of this lane's inputs from the stage input.  Returns whether
// every input of the warp's walkers keeps r |w1|max + |b1|max < 80 (wmax:
// eta's in x, y, mu's in z, w): r >= 0, so -(r w1 + b1) stays under 80 and
// 1 + expf under 2^126, where rcp_in_range is the division's own result.
// One vote of the warp, so that its walkers take one path and the lane
// groups' shuffles stay convergent.
template <int N, int G>
__device__ __forceinline__ bool geometry(float* me, const int* ptab, int lane, float w,
                                         bool has_mu, const float4* wmax) {
  using L = Layout<N, G>;
  const float* x = me + L::IN;
  const float* a = x + L::D;
  float4* geo = reinterpret_cast<float4*>(me + L::GEO);
  const float4 wm = *wmax;
  bool in_range = true;
#pragma unroll
  for (int c = 0; c < L::NC; ++c)
#pragma unroll
  for (int k = 0; k < L::QC; ++k) {
    const int p = (c * G + lane) * L::QC + k;
    if (p < L::P) {
      const int ij = ptab[p], i = ij & 0xff, j = ij >> 8;
      const float u0 = x[2 * i] - x[2 * j], u1 = x[2 * i + 1] - x[2 * j + 1];
      const float d0 = a[2 * i] - a[2 * j], d1 = a[2 * i + 1] - a[2 * j + 1];
      const float r = sqrtf(u0 * u0 + u1 * u1);
      geo[p] = make_float4(r, u0 * d0 + u1 * d1, w * r, 0.f);
      in_range = in_range && r * wm.x + wm.y < 80.f;
    }
  }
  if (has_mu) {
    float4* geo1 = reinterpret_cast<float4*>(me + L::GEO1);
#pragma unroll
    for (int k = 0; k < L::QN; ++k) {
      const int i = lane * L::QN + k;
      if (i < N) {
        const float xa = x[2 * i], xb = x[2 * i + 1];
        const float rho = sqrtf(xa * xa + xb * xb);
        geo1[i] = make_float4(rho, xa * a[2 * i] + xb * a[2 * i + 1], w * rho, 0.f);
        in_range = in_range && rho * wm.z + wm.w < 80.f;
      }
    }
  }
  return __ballot_sync(0xffffffffu, !in_range) == 0u;
}

// Pair chunk C of the eta MLP and the chunks after it (the Layout's QC,
// NC): the theta rows into the walker's accumulators (the last de % G
// units' into the lanes' own rows at ql) and, for the pairs this lane
// totals, their contributions to the slopes of their particles.
template <int N, int G, bool kInRange, int C>
__device__ __forceinline__ void pair_chunks(float* me, float* ql, const int* ptab, int lane,
                                            const float4* ew, int de, float w, float bw,
                                            bool acc_q) {
  using L = Layout<N, G>;
  if constexpr (C < L::NC) {
    constexpr int p0 = C * G * L::QC;
    constexpr int M = L::P - p0 < G * L::QC ? L::P - p0 : G * L::QC;
    const float* x = me + L::IN;
    const float* a = x + L::D;
    const float4* geo = reinterpret_cast<const float4*>(me + L::GEO);
    float e[G * L::QC][3];
    mlp_coefficients<M, G, L::QC, 2, 4, kInRange>(geo + p0, ew, de, lane, w, bw, acc_q,
                                                  me + L::Q, ql, e);
    float4* cell = reinterpret_cast<float4*>(me + L::CELL);
#pragma unroll
    for (int k = 0; k < L::QC; ++k) {
      const int p = p0 + lane * L::QC + k;
      if (p < L::P) {
        const int ij = ptab[p], i = ij & 0xff, j = ij >> 8;
        const float ua = x[2 * i] - x[2 * j], ub = x[2 * i + 1] - x[2 * j + 1];
        const float d0 = a[2 * i] - a[2 * j], d1 = a[2 * i + 1] - a[2 * j + 1];
        const float4 g = geo[p];
        const float r = g.x, iv = 1.f / r;
        const float e0 = e[k][0], e1 = e[k][1], e2 = e[k][2];
        const float cu = e1 * iv * g.y;
        const float m0 = cu * ua + e0 * d0;
        const float m1 = cu * ub + e0 * d1;
        const float cg = (2.f * (e2 * r + 3.f * e1)) * iv * w;
        cell[p] = make_float4(e0 * ua, e0 * ub, cg * ua - m0, cg * ub - m1);
      }
    }
    pair_chunks<N, G, kInRange, C + 1>(me, ql, ptab, lane, ew, de, w, bw, acc_q);
  }
}

// The MLPs (theta rows into the walker's accumulators: eta's 3 de, then
// mu's, then the lanes' own rows of eta's last de % G units and of mu's
// last dm % G) and, for this lane's inputs, their contributions to the
// slopes of their particles.  kInRange: geometry's vote.
template <int N, int G, bool kInRange>
__device__ __forceinline__ void mlp_cells(float* me, const int* ptab, int lane,
                                          const float4* ew, int de, const float4* mw,
                                          int dm, float w, float bw, bool acc_q) {
  using L = Layout<N, G>;
  const float* x = me + L::IN;
  const float* a = x + L::D;
  float* q = me + L::Q + 3 * de;
  float* ql = me + L::Q + 3 * (de + dm);
  pair_chunks<N, G, kInRange, 0>(me, ql, ptab, lane, ew, de, w, bw, acc_q);
  if (dm > 0) {
    const float4* geo1 = reinterpret_cast<const float4*>(me + L::GEO1);
    float m[G * L::QN][3];
    ql += 3 * G * (de % G);
    mlp_coefficients<N, G, L::QN, 1, 2, kInRange>(geo1, mw, dm, lane, w, bw, acc_q, q, ql, m);
    float4* cell1 = reinterpret_cast<float4*>(me + L::CELL1);
#pragma unroll
    for (int k = 0; k < L::QN; ++k) {
      const int i = lane * L::QN + k;
      if (i < N) {
        const float xa = x[2 * i], xb = x[2 * i + 1];
        const float4 g = geo1[i];
        const float rho = g.x, iv = 1.f / rho;
        const float m0 = m[k][0], m1 = m[k][1], m2 = m[k][2];
        const float cu = m1 * iv * g.y;
        const float cg = (m2 * rho + 3.f * m1) * iv * w;
        cell1[i] = make_float4(m0 * xa, m0 * xb, cg * xa - (cu * xa + m0 * a[2 * i]),
                               cg * xb - (cu * xb + m0 * a[2 * i + 1]));
      }
    }
  }
}

// Slope of state entry e (x entries: dx/dt; a entries: da/dt): its
// particle's pair contributions in ascending partner order (+ where the
// particle is the pair's first, - where second), then the one-body one.
template <int N, int G>
__device__ __forceinline__ float slope(const float* me, int e, bool has_mu) {
  using L = Layout<N, G>;
  if (e >= L::S) return 0.f;
  const int f = e < L::D ? (e & 1) : 2 + (e & 1);
  const int i = (e < L::D ? e : e - L::D) >> 1;
  const float* cell = me + L::CELL + f;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j == i) continue;
    const float v = cell[4 * (i < j ? pair_index<N>(i, j) : pair_index<N>(j, i))];
    acc += i < j ? v : -v;
  }
  if (has_mu) acc += me[L::CELL1 + 4 * i + f];
  return acc;
}

// The lanes' own rows of an MLP's last du % G units (at ql, mlp_coefficients)
// into its theta rows q, each row's lanes in ascending order.
template <int G>
__device__ __forceinline__ void fold_lane_rows(float* q, const float* ql, int du, int lane) {
  const int dealt = du - du % G;
  for (int i = lane; i < 3 * (du - dealt); i += G) {
    float v = 0.f;
#pragma unroll
    for (int l = 0; l < G; ++l) v += ql[i * G + l];
    q[i % 3 * du + dealt + i / 3] += v;
  }
}

// Where this lane keeps its share of the walker's state between stages, in
// the walker's shared region, so that it holds no register across the
// hidden-unit loop: entry slot s (entry lane + G s) at j = -1, its dopri5
// slope at stage j at j = 0 .. FF_MAXSTAGES - 1.
template <int N, int G>
__device__ __forceinline__ int lane_state(int lane, int j, int s) {
  return Layout<N, G>::KS + ((j + 1) * Layout<N, G>::E + s) * G + lane;
}

template <int N, int G>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) reinforce_kernel(
    const float* __restrict__ x1, const float* __restrict__ ghat,
    const float* __restrict__ wts_in, float* __restrict__ z_out,
    float* __restrict__ partials, int B, const float* __restrict__ eta_w1,
    const float* __restrict__ eta_b1, const float* __restrict__ eta_w2, int de,
    const float* __restrict__ mu_w1, const float* __restrict__ mu_b1,
    const float* __restrict__ mu_w2, int dm, int steps, Tableau hab) {
  using L = Layout<N, G>;
  constexpr int D = L::D, S = L::S, E = L::E, NW = L::NW;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid % G, slot = tid / G;
  const int w0 = blockIdx.x * NW;
  const int nq = 3 * (de + dm), nrows = walker_rows<G>(de, dm);
  const int rw = region_floats<N, G>(de, dm);
  const bool has_mu = dm > 0;

  float4* ew = smem4;
  float4* mw = ew + de;
  float4* wmax = mw + dm;  // eta's largest |w1|, |b1| (x, y), mu's (z, w)
  float* tab = reinterpret_cast<float*>(wmax + 1);  // h a (6 x 6), then h b (6)
  int* ptab = reinterpret_cast<int*>(tab + TABLEAU);  // pair -> i | j << 8
  float* walkers = sm + header_floats<N, G>(de, dm);
  float* me = walkers + slot * rw;

  // Set-up, the only block-wide barriers: weights, tableau, pair table,
  // zeroed accumulators, and the block's walkers, row by row (coalesced).
  for (int j = tid; j < de; j += THREADS)
    ew[j] = make_float4(eta_w1[j], eta_b1[j], eta_w2[j], 0.f);
  for (int j = tid; j < dm; j += THREADS)
    mw[j] = make_float4(mu_w1[j], mu_b1[j], mu_w2[j], 0.f);
  for (int j = tid; j < FF_MAXSTAGES * FF_MAXSTAGES; j += THREADS)
    tab[j] = hab.a[j / FF_MAXSTAGES][j % FF_MAXSTAGES];
  for (int j = tid; j < FF_MAXSTAGES; j += THREADS)
    tab[FF_MAXSTAGES * FF_MAXSTAGES + j] = hab.b[j];
  for (int p = tid; p < L::P; p += THREADS) {
    int i = 0, r = p;
    while (r >= N - 1 - i) r -= N - 1 - i++;
    ptab[p] = i | ((i + 1 + r) << 8);
  }
  for (int idx = tid; idx < NW * nrows; idx += THREADS)
    walkers[(idx / nrows) * rw + L::Q + idx % nrows] = 0.f;
  const size_t Bs = (size_t)B;
  for (int idx = tid; idx < S * NW; idx += THREADS) {
    const int e = idx / NW, c = idx % NW;
    const bool on = w0 + c < B;
    const size_t wi = (size_t)min(w0 + c, B - 1);
    float v;
    if (e < D) v = x1[e * Bs + wi];
    else v = on ? -wts_in[wi] * ghat[(e - D) * Bs + wi] : 0.f;
    walkers[c * rw + e] = v;
  }
  __syncthreads();
  if (tid < 32) {
    float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = tid; j < de; j += 32)
      m = make_float4(fmaxf(m.x, fabsf(ew[j].x)), fmaxf(m.y, fabsf(ew[j].y)), m.z, m.w);
    for (int j = tid; j < dm; j += 32)
      m = make_float4(m.x, m.y, fmaxf(m.z, fabsf(mw[j].x)), fmaxf(m.w, fabsf(mw[j].y)));
#pragma unroll
    for (int o = 1; o < 32; o <<= 1)
      m = make_float4(fmaxf(m.x, __shfl_xor_sync(0xffffffffu, m.x, o)),
                      fmaxf(m.y, __shfl_xor_sync(0xffffffffu, m.y, o)),
                      fmaxf(m.z, __shfl_xor_sync(0xffffffffu, m.z, o)),
                      fmaxf(m.w, __shfl_xor_sync(0xffffffffu, m.w, o)));
    if (tid == 0) *wmax = m;
  }
  __syncthreads();

  const bool live = w0 + slot < B;
  const float w = live ? wts_in[w0 + slot] : 0.f;
  const auto y = [&](int s) -> float& { return me[lane_state<N, G>(lane, -1, s)]; };
  const auto k = [&](int j, int s) -> float& { return me[lane_state<N, G>(lane, j, s)]; };
#pragma unroll
  for (int s = 0; s < E; ++s) {
    const int e = lane + G * s;
    y(s) = e < S ? me[L::IN + e] : 0.f;
  }
  const float* tb = tab + FF_MAXSTAGES * FF_MAXSTAGES;
  for (int step = 0; step < steps; ++step) {
    for (int st = 0; st < hab.stages; ++st) {
      const float* ta = tab + st * FF_MAXSTAGES;
      // h < 0: -h b_i is the positive quadrature weight.
      const float bw = -tb[st];
      __syncwarp();  // the group is done reading the last stage's shared data
#pragma unroll
      for (int s = 0; s < E; ++s) {
        float acc = y(s);
#pragma unroll
        for (int j = 0; j < FF_MAXSTAGES - 1; ++j)
          if (j < st && ta[j] != 0.f) acc = acc + ta[j] * k(j, s);
        const int e = lane + G * s;
        if (e < S) me[L::IN + e] = acc;
      }
      __syncwarp();
      const bool in_range = geometry<N, G>(me, ptab, lane, w, has_mu, wmax);
      __syncwarp();
      if (in_range)
        mlp_cells<N, G, true>(me, ptab, lane, ew, de, mw, dm, w, bw, live && bw != 0.f);
      else
        mlp_cells<N, G, false>(me, ptab, lane, ew, de, mw, dm, w, bw, live && bw != 0.f);
      __syncwarp();
#pragma unroll
      for (int s = 0; s < E; ++s) k(st, s) = slope<N, G>(me, lane + G * s, has_mu);
    }
#pragma unroll
    for (int s = 0; s < E; ++s) {
      float acc = y(s);
#pragma unroll
      for (int j = 0; j < FF_MAXSTAGES; ++j)
        if (j < hab.stages && tb[j] != 0.f) acc = acc + tb[j] * k(j, s);
      y(s) = acc;
    }
  }

  __syncwarp();
  fold_lane_rows<G>(me + L::Q, me + L::Q + nq, de, lane);
  fold_lane_rows<G>(me + L::Q + 3 * de, me + L::Q + nq + 3 * G * (de % G), dm, lane);
#pragma unroll
  for (int s = 0; s < E; ++s) {
    const int e = lane + G * s;
    if (e < D) me[L::IN + e] = y(s);
  }
  __syncthreads();
  for (int idx = tid; idx < D * NW; idx += THREADS) {
    const int e = idx / NW, c = idx % NW;
    if (w0 + c < B) z_out[e * Bs + w0 + c] = walkers[c * rw + L::IN + e];
  }
  // Fixed-order pairwise reduction of this block's walkers.
  for (int r = tid; r < nq; r += THREADS) {
    float v[NW];
#pragma unroll
    for (int c = 0; c < NW; ++c) v[c] = walkers[c * rw + L::Q + r];
#pragma unroll
    for (int lvl = 1; lvl < NW; lvl *= 2) {
#pragma unroll
      for (int c = 0; c < NW / (2 * lvl); ++c) v[c] += v[c + NW / (2 * lvl)];
    }
    partials[(size_t)blockIdx.x * nq + r] = v[0];
  }
}

constexpr int kReduceCols = 32, kReduceRows = 32;

// grads[r] = sum over blocks of partials[b][r]: thread (tx, ty) sums rows
// ty, ty + 32, ... of column tx in order; after the barrier, warp ty adds
// column ty's 32 group sums by a butterfly (adds commute, so every lane
// holds the same bits).
__global__ void __launch_bounds__(kReduceCols * kReduceRows) reinforce_reduce_kernel(
    const float* __restrict__ partials, float* __restrict__ grads, int nblocks,
    int nq) {
  __shared__ float buf[kReduceRows][kReduceCols + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * kReduceCols + tx;
  float s = 0.f;
  if (col < nq) {
#pragma unroll 8
    for (int b = ty; b < nblocks; b += kReduceRows) s += partials[(size_t)b * nq + col];
  }
  buf[ty][tx] = s;
  __syncthreads();
  float v = buf[tx][ty];
#pragma unroll
  for (int off = kReduceRows / 2; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int out = blockIdx.x * kReduceCols + ty;
  if (tx == 0 && out < nq) grads[out] = v;
}

// Once per instantiation and process (the port drives one device per
// process): allow the card's largest dynamic shared memory and prefer
// shared memory over L1 (the kernel reads device memory only in its set-up).
template <int N>
cudaError_t prepare() {
  static const cudaError_t err = [] {
    auto kern = reinforce_kernel<N, lanes_for(N)>;
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return err;
}

int num_blocks(int B, int n) {
  const int nw = THREADS / lanes_for(n);  // walkers per block
  return (B + nw - 1) / nw;
}

template <int N>
cudaError_t launch(const float* x1, const float* ghat, const float* w,
                   float* z_out, float* partials, int B, const float* ew1,
                   const float* eb1, const float* ew2, int de, const float* mw1,
                   const float* mb1, const float* mw2, int dm, int steps,
                   const Tableau& hab, cudaStream_t stream) {
  cudaError_t err = prepare<N>();
  if (err != cudaSuccess) return err;
  constexpr int G = lanes_for(N);
  reinforce_kernel<N, G><<<num_blocks(B, N), THREADS, smem_bytes<N, G>(de, dm), stream>>>(
      x1, ghat, w, z_out, partials, B, ew1, eb1, ew2, de, mw1, mb1, mw2, dm, steps, hab);
  return cudaGetLastError();
}

template <int N>
cudaError_t occupancy(int de, int dm, int* warps_per_sm) {
  cudaError_t err = prepare<N>();
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, reinforce_kernel<N, lanes_for(N)>, THREADS,
      smem_bytes<N, lanes_for(N)>(de, dm));
  *warps_per_sm = blocks * (THREADS / 32);
  return err;
}

}  // namespace

// Rows of the partials buffer of a launch over B walkers of n particles.
extern "C" int ff_reinforce_blocks(int B, int n) { return num_blocks(B, n); }

// Lanes per walker of the adjoint's instantiation for n (0 if there is none).
extern "C" int ff_reinforce_lanes(int n) {
  return n >= 2 && n <= FF_MAXN ? lanes_for(n) : 0;
}

extern "C" int ff_reinforce_adjoint(const float* x1, const float* ghat,
                                    const float* w, float* z_out, float* partials,
                                    int B, int n, const float* eta_w1,
                                    const float* eta_b1, const float* eta_w2,
                                    int d_eta, const float* mu_w1,
                                    const float* mu_b1, const float* mu_w2,
                                    int d_mu, int steps, int stages,
                                    const float* h_a, const float* h_b,
                                    void* stream) {
  if (B <= 0) return 0;
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
    case 7: err = FF_RF(7); break;
    case 8: err = FF_RF(8); break;
    case 9: err = FF_RF(9); break;
    case 10: err = FF_RF(10); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef FF_RF
  return (int)err;
}

extern "C" int ff_reinforce_reduce(const float* partials, float* grads,
                                   int nblocks, int nq, void* stream) {
  const dim3 block(kReduceCols, kReduceRows);
  reinforce_reduce_kernel<<<(nq + kReduceCols - 1) / kReduceCols, block, 0,
                            (cudaStream_t)stream>>>(partials, grads, nblocks, nq);
  return (int)cudaGetLastError();
}

// Both passes on one stream from one host call: the adjoint, then the
// reduce of its partials into grads (nq = 3 (d_eta + d_mu)).
extern "C" int ff_reinforce(const float* x1, const float* ghat, const float* w,
                            float* z_out, float* partials, float* grads, int B, int n,
                            const float* eta_w1, const float* eta_b1,
                            const float* eta_w2, int d_eta, const float* mu_w1,
                            const float* mu_b1, const float* mu_w2, int d_mu,
                            int steps, int stages, const float* h_a,
                            const float* h_b, void* stream) {
  const int err = ff_reinforce_adjoint(x1, ghat, w, z_out, partials, B, n, eta_w1,
                                       eta_b1, eta_w2, d_eta, mu_w1, mu_b1, mu_w2,
                                       d_mu, steps, stages, h_a, h_b, stream);
  if (err != 0) return err;
  return ff_reinforce_reduce(partials, grads, ff_reinforce_blocks(B, n), 3 * (d_eta + d_mu),
                             stream);
}

// Resident warps per SM of the adjoint pass for n at these widths.
extern "C" int ff_reinforce_occupancy(int n, int d_eta, int d_mu, int* warps_per_sm) {
  cudaError_t err;
  switch (n) {
    case 2: err = occupancy<2>(d_eta, d_mu, warps_per_sm); break;
    case 3: err = occupancy<3>(d_eta, d_mu, warps_per_sm); break;
    case 4: err = occupancy<4>(d_eta, d_mu, warps_per_sm); break;
    case 5: err = occupancy<5>(d_eta, d_mu, warps_per_sm); break;
    case 6: err = occupancy<6>(d_eta, d_mu, warps_per_sm); break;
    case 7: err = occupancy<7>(d_eta, d_mu, warps_per_sm); break;
    case 8: err = occupancy<8>(d_eta, d_mu, warps_per_sm); break;
    case 9: err = occupancy<9>(d_eta, d_mu, warps_per_sm); break;
    case 10: err = occupancy<10>(d_eta, d_mu, warps_per_sm); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
