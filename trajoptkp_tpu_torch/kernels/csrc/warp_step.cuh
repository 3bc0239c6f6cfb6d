// The cooperative step: one K1 step (step.cuh) of one lane spread over the
// 32 threads of a warp, with the lane's arrays in shared memory.  K3 and
// K4 (linesearch.cu, K3 its open loop) and K5 (fd_jacobian.cu, without the
// residual) run it for every instance with constraint rows; K5ad, K8 and
// fk_bias keep the one-thread step.
//
// Replaces the JAX lane step, trajoptkp_tpu/dynamics/lanes.py:1595
// (build_smooth_step) with the constraint solve of lanes.py:1523 and the
// contact rows of lanes.py:989, as step.cuh, constraint.cuh and
// contact.cuh do for one thread; its plain twin is theirs,
// trajoptkp_tpu_torch/dynamics/step.py:step_state.
//
// Work across the warp, every sum in the one-thread step's order (so the
// two, and the twin, agree bit for bit under -fmad=false):
// - thread 0: FK and the RNE velocities down the tree (step.cuh: fk_body,
//   rne_chain), then, after each body's inertia and RNE force on a thread
//   of its own (body_inertia, body_rne_force), the residual, the RNE
//   backward sweep and the composite inertias (rne_backward); the narrow
//   phase a pair per thread, the pairs of one geom type side by side
//   (contact.cuh's colliders, one code path per pair type);
// - one thread per dof: CRBA's row of M (a dot6 per entry on the dof's
//   root path), the smooth force, M e and M dx (k = 0..NV-1 in order);
// - one thread per limited joint: its two limit rows; one thread per
//   contact slot: its impedance and gate; one thread per (slot, support
//   dof): the point Jacobian and four coefficients; one thread per row: its
//   velocity sum, y = J x - aref and J dx;
// - the gradient and H = M + J'GJ: the limit rows by limited joint, then
//   the pairs (a pair's rows share its support), each entry of H (w1 >= w2
//   of a support) and of the gradient owned by one thread, which sums its
//   pairs' rows in row order (the owners balanced by rows at compile
//   time, WarpTables::h_item): every entry's rows come in row order, as in
//   newton_iterations;
// - Cholesky right-looking by column (warp_factor_solve), a row of the
//   matrix in each thread's registers: after column j, each trailing entry
//   subtracts L[i][j] L[l][j] (L[l][j] by shuffle), the k order of
//   chol_factor's inner sums; the forward solve by column, the backward
//   solve on one thread (its sums run k = i+1..N-1 from the last-found
//   b[i+1], a chain no split shortens): up to 32 dofs (a model past that
//   needs two rows a thread, or the factor in shared memory);
// - the merit at alpha = 0 and the six step lengths: seven threads sum
//   their penalties over the rows in order while three more sum e'Me,
//   e'M dx and dx'M dx; six threads form the six merits, and every thread
//   takes the first minimum over them in order.
// No tree reduction: every sum is one thread's, left to right (shuffles
// only move values).  Every phase ends at __syncwarp(); M and H are packed lower
// triangles (constraint.cuh:tri).
//
// Shared memory per lane (WarpLayout, kernels/ops.py:linesearch_lane_
// doubles mirrors it): q, v, u, the FK products (xpos, xquat, cdof), the
// composite inertias, f, M, H (which first holds the RNE's per-body
// arrays, then the slots' narrow-phase results), eight dof vectors, the rows' packed coefficients, aref, invR,
// y, J dx, the merit sums and K4's targets, residual and state difference:
// 25.1 KB at push_lcl (31 dofs, 114 rows), 10.6 KB at push_ncl, 11.9 KB at
// box_sweep, 14.6 KB at the walker; K5 adds the plus step's q and v
// (FD_DOUBLES, ops.fd_lane_doubles).  The topology's tables the threads
// index at run time (WarpTables) are copied into each block's shared
// memory at the kernel's start.
//
// Bound: the step's dependent chains, now ~NV long per factorisation
// (right-looking columns) instead of ~NV^2/2 ... NV^3/6, the rows' sums one
// row per thread, and the backward solve's NV^2/2 chain; a step at
// push_lcl is ~150-300k SM cycles of one warp (chip_smoke.py's step_ops
// counts its double operations).
#pragma once

#include "step.cuh"

namespace trajopt {

constexpr int WARP = 32;
// doubles per contact slot of the narrow phase: pos (3), frame (9), dist,
// kk, imp, invR
constexpr int SLOT_DOUBLES = 16;

// the per-instance tables of the cooperative step
template <class T>
struct WarpSizes {
  static constexpr int NV = T::NV, NB = T::NBODY, R = T::R;
  static constexpr int NLIM = T::NLIM, NPAIR = T::NPAIR, NSLOT = T::NSLOT;
  static constexpr int NTRI = NV * (NV + 1) / 2;
  __host__ __device__ static constexpr int count_coef() {
    int n = 2 * NLIM;
    for (int p = 0; p < NPAIR; ++p) n += 4 * T::pair_ncon(p) * T::nsup(p);
    return n;
  }
  static constexpr int NCOEF = count_coef();
  __host__ __device__ static constexpr int count_items() {
    int n = 0;
    for (int p = 0; p < NPAIR; ++p) n += T::pair_ncon(p) * T::nsup(p);
    return n;
  }
  static constexpr int NJI = count_items();  // (slot, support dof) items
  // the pairs' items of the gradient and H (each pair: its support's lower
  // triangle of H, then its support's gradient entries)
  __host__ __device__ static constexpr int count_h_items() {
    int n = 0;
    for (int p = 0; p < NPAIR; ++p)
      n += T::nsup(p) * (T::nsup(p) + 1) / 2 + T::nsup(p);
    return n;
  }
  static constexpr int NHI = count_h_items();
};

constexpr int WARP_THREADS = 32;

template <class T>
struct WarpTables {
  using Z = WarpSizes<T>;
  static constexpr int NV = Z::NV, NB = Z::NB, R = Z::R;
  // per body, whether dof j lies on its root path (T::PATH); per dof its
  // body, qpos and whether its body is free; per limited joint its dof
  short path[NB * NV];
  short dof_body[NV], dof_q[NV], dof_free[NV];
  short lim_dof[Z::NLIM > 0 ? Z::NLIM : 1];
  // per row its first coefficient and width; per coefficient its dof
  short row_coef[R > 0 ? R : 1], row_w[R > 0 ? R : 1];
  short coef_dof[Z::NCOEF > 0 ? Z::NCOEF : 1];
  // per pair its first row, rows, support width, first coefficient and
  // support (dof, sign); per slot its pair
  short pair_row0[Z::NPAIR > 0 ? Z::NPAIR : 1];
  short pair_nrow[Z::NPAIR > 0 ? Z::NPAIR : 1];
  short pair_w[Z::NPAIR > 0 ? Z::NPAIR : 1];
  short pair_coef0[Z::NPAIR > 0 ? Z::NPAIR : 1];
  short supp[Z::NPAIR > 0 ? Z::NPAIR * NV : 1];
  short supp_sign[Z::NPAIR > 0 ? Z::NPAIR * NV : 1];
  short slot_pair[Z::NSLOT > 0 ? Z::NSLOT : 1];
  // the (slot, support dof) items of the contact Jacobians
  short ji_slot[Z::NJI > 0 ? Z::NJI : 1], ji_w[Z::NJI > 0 ? Z::NJI : 1];
  // per pair its bodies and first slot; the pairs grouped by their geom
  // types (type_members), a group from type_off[p] for type_cnt[p] pairs
  // where p is its first pair
  short pair_b1[Z::NPAIR > 0 ? Z::NPAIR : 1];
  short pair_b2[Z::NPAIR > 0 ? Z::NPAIR : 1];
  short pair_slot0[Z::NPAIR > 0 ? Z::NPAIR : 1];
  short type_off[Z::NPAIR > 0 ? Z::NPAIR : 1];
  short type_cnt[Z::NPAIR > 0 ? Z::NPAIR : 1];
  short type_members[Z::NPAIR > 0 ? Z::NPAIR : 1];
  // the pairs' gradient and H items by thread: thread k's from
  // h_off[k] to h_off[k + 1], in pair order, each (p << 16) | (w1 << 8) |
  // w2 (w2 = 255: the gradient entry of w1); every entry of H and of the
  // gradient belongs to one thread, so its rows come in row order
  int h_item[Z::NHI > 0 ? Z::NHI : 1];
  short h_off[WARP_THREADS + 1];
};

// whether pair p is the first of its geom types
template <class T>
__host__ __device__ constexpr bool first_of_type(int p) {
  for (int q = 0; q < p; ++q)
    if (T::pair_t1(q) == T::pair_t1(p) && T::pair_t2(q) == T::pair_t2(p))
      return false;
  return true;
}

template <class T>
__host__ __device__ constexpr WarpTables<T> make_warp_tables() {
  using Z = WarpSizes<T>;
  constexpr int NV = Z::NV;
  WarpTables<T> t{};
  for (int b = 0; b < Z::NB; ++b)
    for (int j = 0; j < NV; ++j)
      t.path[b * NV + j] = static_cast<short>(T::on_path(b, j) ? 1 : 0);
  for (int j = 0; j < NV; ++j) {
    t.dof_body[j] = static_cast<short>(T::dof_body(j));
    t.dof_q[j] = static_cast<short>(T::dof_q(j));
    t.dof_free[j] = static_cast<short>(T::free(T::dof_body(j)) ? 1 : 0);
  }
  for (int k = 0; k < Z::NLIM; ++k) t.lim_dof[k] = T::lim_dof(k);
  int c = 0;
  for (int r = 0; r < 2 * Z::NLIM; ++r) {
    t.row_coef[r] = static_cast<short>(c);
    t.row_w[r] = 1;
    t.coef_dof[c++] = static_cast<short>(T::lim_dof(r % Z::NLIM));
  }
  int r = 2 * Z::NLIM, s = 0, item = 0;
  for (int p = 0; p < Z::NPAIR; ++p) {
    const int W = T::nsup(p), nc = T::pair_ncon(p);
    int w = 0;
    for (int j = 0; j < NV; ++j)
      if (T::on_path(T::pair_b1(p), j) != T::on_path(T::pair_b2(p), j)) {
        t.supp[p * NV + w] = static_cast<short>(j);
        t.supp_sign[p * NV + w] =
            static_cast<short>(T::on_path(T::pair_b2(p), j) ? 1 : -1);
        ++w;
      }
    t.pair_row0[p] = static_cast<short>(r);
    t.pair_nrow[p] = static_cast<short>(4 * nc);
    t.pair_w[p] = static_cast<short>(W);
    t.pair_coef0[p] = static_cast<short>(c);
    for (int e = 0; e < 4 * nc; ++e, ++r) {
      t.row_coef[r] = static_cast<short>(c);
      t.row_w[r] = static_cast<short>(W);
      for (int ww = 0; ww < W; ++ww) t.coef_dof[c++] = t.supp[p * NV + ww];
    }
    t.pair_b1[p] = static_cast<short>(T::pair_b1(p));
    t.pair_b2[p] = static_cast<short>(T::pair_b2(p));
    t.pair_slot0[p] = static_cast<short>(s);
    for (int k = 0; k < nc; ++k, ++s) {
      t.slot_pair[s] = static_cast<short>(p);
      for (int ww = 0; ww < W; ++ww, ++item) {
        t.ji_slot[item] = static_cast<short>(s);
        t.ji_w[item] = static_cast<short>(ww);
      }
    }
  }
  // each entry of H (d1 >= d2) and of the gradient (NV * NV + d) to the
  // least loaded thread when first met, its load its rows over the pairs;
  // a pair's items are its support's lower triangle (w1 >= w2) row by row,
  // then its gradient entries
  {
    int owner[NV * NV + NV] = {};
    int load[WARP_THREADS] = {};
    for (int e = 0; e < NV * NV + NV; ++e) owner[e] = -1;
    for (int pass = 0; pass < 2; ++pass) {
      int n = 0;
      for (int k = 0; k < (pass ? WARP_THREADS : 1); ++k) {
        if (pass) t.h_off[k] = static_cast<short>(n);
        for (int p = 0; p < Z::NPAIR; ++p) {
          const int W = T::nsup(p), nr = 4 * T::pair_ncon(p);
          for (int w1 = 0; w1 < W; ++w1)
            for (int w2 = 0; w2 <= w1 + 1; ++w2) {
              // w2 <= w1: H's entry (w1, w2); w2 = w1 + 1: the gradient's
              const bool hm = w2 <= w1;
              const int e = hm ? t.supp[p * NV + w1] * NV + t.supp[p * NV + w2]
                               : NV * NV + t.supp[p * NV + w1];
              if (!pass) {
                if (owner[e] < 0) {
                  int best = 0;
                  for (int j = 1; j < WARP_THREADS; ++j)
                    if (load[j] < load[best]) best = j;
                  owner[e] = best;
                }
                load[owner[e]] += nr;
              } else if (owner[e] == k) {
                t.h_item[n++] = (p << 16) | (w1 << 8) | (hm ? w2 : 255);
              }
            }
        }
      }
      if (pass) t.h_off[WARP_THREADS] = static_cast<short>(n);
    }
  }
  int m = 0;
  for (int p = 0; p < Z::NPAIR; ++p) {
    if (!first_of_type<T>(p)) continue;
    t.type_off[p] = static_cast<short>(m);
    for (int q = p; q < Z::NPAIR; ++q)
      if (T::pair_t1(q) == T::pair_t1(p) && T::pair_t2(q) == T::pair_t2(p))
        t.type_members[m++] = static_cast<short>(q);
    t.type_cnt[p] = static_cast<short>(m - t.type_off[p]);
  }
  return t;
}

// the dofs of a body's ancestors precede its own: every entry CRBA
// writes lies in M's lower triangle
template <class T>
__host__ __device__ constexpr bool ancestors_first() {
  for (int i = 0; i < T::NV; ++i)
    for (int j = i + 1; j < T::NV; ++j)
      if (T::on_path(T::dof_body(i), j) && T::dof_body(j) != T::dof_body(i))
        return false;
  return true;
}

template <class T>
__device__ const WarpTables<T> WARP_TABLES = make_warp_tables<T>();

// The block's copy of the tables in shared memory (static, beside the
// lanes' dynamic shared memory: kernels/ops.py:warp_tables_bytes), which
// the threads index at run time; warp_tables_load fills it at the
// kernel's start.
template <class T>
__device__ __forceinline__ WarpTables<T>& warp_tables() {
  static __shared__ WarpTables<T> tables;
  return tables;
}

template <class T>
__device__ __forceinline__ void warp_tables_load() {
  static_assert(sizeof(WarpTables<T>) % 4 == 0, "copied as ints");
  const int* src = reinterpret_cast<const int*>(&WARP_TABLES<T>);
  int* dst = reinterpret_cast<int*>(&warp_tables<T>());
  for (int i = threadIdx.x; i < int(sizeof(WarpTables<T>) / 4);
       i += blockDim.x)
    dst[i] = src[i];
  __syncthreads();
}

// The lane's shared memory, in doubles from the lane's base.
template <class T>
struct WarpLayout {
  using Z = WarpSizes<T>;
  static constexpr int NQ = T::NQ, NV = T::NV, NU = T::NU, NB = T::NBODY;
  static constexpr int R = T::R;
  // H, which first holds the RNE's per-body velocity, acceleration and
  // force, then the slots' narrow phase
  static constexpr int max3(int a, int b, int c) {
    return a > b ? (a > c ? a : c) : (b > c ? b : c);
  }
  static constexpr int HS_SIZE =
      max3(Z::NTRI, SLOT_DOUBLES * Z::NSLOT, 18 * NB);
  static constexpr int Q = 0;
  static constexpr int V = Q + NQ;
  static constexpr int U = V + NV;
  static constexpr int XPOS = U + NU;
  static constexpr int XQUAT = XPOS + 3 * NB;
  static constexpr int CDOF = XQUAT + 4 * NB;
  static constexpr int INER = CDOF + 6 * NV;
  static constexpr int F = INER + 10 * NB;
  static constexpr int M = F + NV;
  static constexpr int HS = M + Z::NTRI;
  static constexpr int A0 = HS + HS_SIZE;
  static constexpr int X = A0 + NV;
  static constexpr int DX = X + NV;
  static constexpr int E = DX + NV;
  static constexpr int ME = E + NV;
  static constexpr int MDX = ME + NV;
  static constexpr int QC = MDX + NV;
  static constexpr int COEF = QC + NV;
  static constexpr int AREF = COEF + Z::NCOEF;
  static constexpr int INVR = AREF + R;
  static constexpr int Y = INVR + R;
  static constexpr int JDX = Y + R;
  static constexpr int MER = JDX + R;  // 7 penalties, 3 products
  static constexpr int TG = MER + 16;
  static constexpr int RES = TG + T::NTGT;
  static constexpr int DXS = RES + T::NRES;
  static constexpr int DOUBLES = DXS + T::NX;
  // K5 (fd_jacobian.cu): the plus step's result (q, v) beside the lane
  static constexpr int FDP = DOUBLES;
  static constexpr int FD_DOUBLES = FDP + NQ + NV;
};

__device__ __forceinline__ void warp_sync() { __syncwarp(); }

// constraint.cuh's step lengths, by index without a local array
__device__ __forceinline__ double alpha_ladder(int a) {
  return a == 0 ? 1.0
         : a == 1 ? 0.5
         : a == 2 ? 0.25
         : a == 3 ? 0.1
         : a == 4 ? 0.04
                  : 0.01;
}

// With TRAJOPT_WARP_MARKS (bench_kernels.py --marks) thread 0 of block 0
// adds the SM cycles of each phase of the cooperative step to
// trajopt_warp_marks (linesearch.cu: trajopt_warp_marks_read): 0 the
// control law, 1 FK, RNE and the narrow phase (thread 0), 2 CRBA, forces
// and rows, 3 a0, 4 the Newton iterations' products, 5 their gradient and
// H, 6 their solves, 7 their step length, 8 the constraint force, 9 the
// mass-matrix solve and the integration; entry 15 counts steps.
#ifdef TRAJOPT_WARP_MARKS
__device__ unsigned long long trajopt_warp_marks[16];
__device__ unsigned long long trajopt_warp_clock;
#define WARP_MARK(k)                                                     \
  do {                                                                   \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                           \
      const unsigned long long c_ = clock64();                          \
      trajopt_warp_marks[k] += c_ - trajopt_warp_clock;                  \
      trajopt_warp_clock = c_;                                           \
    }                                                                    \
  } while (0)
#define WARP_MARK_START()                                                \
  do {                                                                   \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                           \
      trajopt_warp_clock = clock64();                                    \
      trajopt_warp_marks[15] += 1;                                       \
    }                                                                    \
  } while (0)
#else
#define WARP_MARK(k) \
  do {               \
  } while (0)
#define WARP_MARK_START() \
  do {                    \
  } while (0)
#endif

constexpr unsigned FULL_WARP = 0xffffffffu;

// Solve A x = b in place (A packed SPD, N x N, N <= 32), A left holding its
// lower Cholesky factor: the operations of chol_factor and chol_solve in
// the same order per entry.  Thread i holds row i of A in registers.  The
// factor runs right-looking by column: the column's pivot and L[l][j]
// come from their rows' threads by shuffle, and each trailing entry (i, l)
// subtracts L[i][j] L[l][j] in j order, as chol_factor's inner sums do.
// The forward solve runs by column (b[k] broadcast, every later b[i]
// subtracts L[i][k] b[k]); the backward solve, whose b[i] sums k = i+1..N-1
// from the last-found b[i+1] on, runs on thread 0 fully unrolled.
template <int N>
__device__ __forceinline__ void warp_factor_solve(double* A, double* b,
                                                  int lane) {
  static_assert(N <= WARP,
                "a row of A per thread: the cooperative step takes up to 32 "
                "dofs");
  double a[N];
#pragma unroll
  for (int l = 0; l < N; ++l)
    a[l] = (lane < N && l <= lane) ? A[tri(lane, l)] : 0.0;
  double bi = lane < N ? b[lane] : 0.0;
  // column j's pivot, its root and reciprocal: each taken as soon as
  // column j - 1's first update has made it final, so that the root's
  // latency runs beside the rest of that column's updates.  The forward
  // solve's column j follows the factor's column j (its b[j] is final once
  // column j - 1's updates are in), so its divisions run beside the
  // factor's later columns.
  double d = sqrt(__shfl_sync(FULL_WARP, a[0], 0));
  double inv = recip(d);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const double lij = a[j] * inv;
    double dn = 0.0, invn = 0.0;
#pragma unroll
    for (int l = j + 1; l < N; ++l) {
      const double llj = __shfl_sync(FULL_WARP, lij, l);
      if (l <= lane) a[l] = a[l] - lij * llj;
      if (l == j + 1) {
        dn = sqrt(__shfl_sync(FULL_WARP, a[l], l));
        invn = recip(dn);
      }
    }
    if (lane == j) a[j] = d;
    if (lane > j) a[j] = lij;
    // forward solve, column j: b[j] = s / L[j][j], then every later b[i]
    // subtracts L[i][j] b[j]
    const double bj = __shfl_sync(FULL_WARP, bi, j) / d;
    if (lane > j) bi = bi - lij * bj;
    if (lane == j) bi = bj;
    d = dn;
    inv = invn;
  }
#pragma unroll
  for (int l = 0; l < N; ++l)
    if (lane < N && l <= lane) A[tri(lane, l)] = a[l];
  if (lane < N) b[lane] = bi;
  __syncwarp();
  if (lane == 0) {
    double x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = b[i];
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
      double s = x[i];
#pragma unroll
      for (int k = i + 1; k < N; ++k) s -= A[tri(k, i)] * x[k];
      x[i] = s / A[tri(i, i)];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) b[i] = x[i];
  }
  __syncwarp();
}

template <class T>
__device__ __forceinline__ void warp_solve(double* A, double* b, int lane) {
  warp_factor_solve<T::NV>(A, b, lane);
}

// out[r] = sum_w coef[r][w] x[dof], left to right, one thread per row
template <class T>
__device__ __forceinline__ void warp_rows_times(const WarpTables<T>& tb,
                                                const double* coef,
                                                const double* x, double* out,
                                                int lane) {
#pragma unroll 1
  for (int r = lane; r < T::R; r += WARP) {
    const int c0 = tb.row_coef[r], W = tb.row_w[r];
    double s = coef[c0] * x[tb.coef_dof[c0]];
#pragma unroll 4
    for (int w = 1; w < W; ++w) s += coef[c0 + w] * x[tb.coef_dof[c0 + w]];
    out[r] = s;
  }
}

// out[i] = sum_k M[i][k] x[k], k = 0..NV-1, one thread per dof
template <int NV>
__device__ __forceinline__ void warp_sym_times(const double* M,
                                               const double* x, double* out,
                                               int lane) {
#pragma unroll 1
  for (int i = lane; i < NV; i += WARP) {
    double s = M[tri(i, 0)] * x[0];
#pragma unroll
    for (int k = 1; k < NV; ++k)
      s += M[k <= i ? tri(i, k) : tri(k, i)] * x[k];
    out[i] = s;
  }
}

// FK, RNE, CRBA, the smooth force and the constraint rows (the part of
// smooth_step before the constraint solve) into the lane's shared memory;
// with WANT_RES the residual of (q, v, u) into RES.
template <class T, bool WANT_RES>
__device__ void warp_prelude(const double* __restrict__ P, double* sm,
                             const double* resc, int lane) {
  using LY = WarpLayout<T>;
  constexpr int NV = T::NV, NB = T::NBODY, NU = T::NU, NLIM = T::NLIM;
  const WarpTables<T>& tb = warp_tables<T>();
  double* q = sm + LY::Q;
  double* v = sm + LY::V;
  const double* u = sm + LY::U;
  auto& xpos = *reinterpret_cast<double(*)[NB][3]>(sm + LY::XPOS);
  auto& xquat = *reinterpret_cast<double(*)[NB][4]>(sm + LY::XQUAT);
  auto& cdof = *reinterpret_cast<double(*)[NV][6]>(sm + LY::CDOF);
  auto& In = *reinterpret_cast<Inertia<double>(*)[NB]>(sm + LY::INER);
  auto& bias = *reinterpret_cast<double(*)[NV]>(sm + LY::F);
  double* M = sm + LY::M;
  double* slot = sm + LY::HS;
  // the RNE's per-body arrays, in H's space until the narrow phase
  auto& cvel = *reinterpret_cast<double(*)[NB][6]>(sm + LY::HS);
  auto& cacc = *reinterpret_cast<double(*)[NB][6]>(sm + LY::HS + 6 * NB);
  auto& cfrc = *reinterpret_cast<double(*)[NB][6]>(sm + LY::HS + 12 * NB);
  if (lane == 0) {
    if constexpr (WANT_RES && T::RES == RES_JOINT)
      joint_space_residual<T::NJ, T::NUR>(q, v, u, sm + LY::TG, sm + LY::RES);
    else if constexpr (WANT_RES && T::RES == RES_SELECT)
      select_residual<T>(q, v, u, sm + LY::TG, sm + LY::RES);
    fk_rne_root<T>(P, xpos, xquat, cvel, cacc);
#pragma unroll
    for (int b = 1; b < NB; ++b) {
      fk_body<T>(P, q, b, xpos, xquat, cdof);
      rne_chain<T>(v, b, cdof, cvel, cacc);
    }
  }
  warp_sync();
  // each body's inertia and RNE force on its own thread
#pragma unroll 1
  for (int b = 1 + lane; b < NB; b += WARP) {
    body_inertia<T>(P, b, xpos[b], xquat[b], In[b]);
    body_rne_force(In[b], cvel[b], cacc[b], cfrc[b]);
  }
  warp_sync();
  if (lane == 0) {
    if constexpr (WANT_RES && fk_residual(T::RES))
      fk_residual_of<T>(resc, xpos, xquat, v, sm + LY::TG, sm + LY::RES);
    rne_backward<T>(cdof, cfrc, In, bias);
  }
  warp_sync();
  // the narrow phase, a pair per thread: the pairs of one geom type run
  // the same collider side by side, one type after another; each slot's
  // dist, pos and frame into H's space
  static_for<T::NPAIR>([&](auto pc) {
    constexpr int PF = decltype(pc)::value;
    if constexpr (first_of_type<T>(PF)) {
      constexpr int t1 = T::pair_t1(PF), t2 = T::pair_t2(PF);
      constexpr int NC = T::pair_ncon(PF);
      constexpr bool FLIP = pair_flipped(t1, t2);
      constexpr int A = FLIP ? t2 : t1, Bt = FLIP ? t1 : t2;
      constexpr int NFR = Bt == GEOM_BOX && A != GEOM_PLANE ? NC : 1;
#pragma unroll 1
      for (int k = lane; k < tb.type_cnt[PF]; k += WARP) {
        const int p = tb.type_members[tb.type_off[PF] + k];
        const int b1 = tb.pair_b1[p], b2 = tb.pair_b2[p];
        const double* pp = P + T::PAIRB + p * PAIR_STRIDE;
        double xp1[3], xm1[9], xp2[3], xm2[9];
        geom_pose(xpos[b1], xquat[b1], pp + G1_POS, pp + G1_QUAT, xp1, xm1);
        geom_pose(xpos[b2], xquat[b2], pp + G2_POS, pp + G2_QUAT, xp2, xm2);
        double dist[MAX_SLOTS], pos[MAX_SLOTS][3], fr[NFR][3][3];
        if constexpr (FLIP) {
          collide<A, Bt, NFR>(xp2, xm2, pp + G2_SIZE, xp1, xm1,
                              pp + G1_SIZE, dist, pos, fr);
#pragma unroll
          for (int f = 0; f < NFR; ++f)
#pragma unroll
            for (int j = 0; j < 3; ++j) fr[f][0][j] = -fr[f][0][j];
        } else {
          collide<A, Bt, NFR>(xp1, xm1, pp + G1_SIZE, xp2, xm2,
                              pp + G2_SIZE, dist, pos, fr);
        }
#pragma unroll
        for (int s = 0; s < NC; ++s) {
          double* sd = slot + SLOT_DOUBLES * (tb.pair_slot0[p] + s);
#pragma unroll
          for (int j = 0; j < 3; ++j) sd[j] = pos[s][j];
#pragma unroll
          for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int j = 0; j < 3; ++j)
              sd[3 + 3 * a + j] = fr[NFR == 1 ? 0 : s][a][j];
          sd[12] = dist[s];
        }
      }
    }
  });
#pragma unroll 1
  for (int m = lane; m < NV * (NV + 1) / 2; m += WARP) M[m] = 0.0;
  warp_sync();
  WARP_MARK(1);

  // CRBA (one thread per dof: its row of M on its root path), the smooth
  // force, the limit rows and the slots' gates
#pragma unroll 1
  for (int i = lane; i < NV; i += WARP) {
    const int bi = tb.dof_body[i];
    double F[6];
    inertia_mul(In[bi], cdof[i], F);
    M[tri(i, i)] = dot6(cdof[i], F) + P[T::DOFB + i * DOF_STRIDE + D_ARM];
#pragma unroll 4
    for (int j = 0; j < i; ++j)
      if (tb.path[bi * NV + j]) M[tri(i, j)] = dot6(cdof[j], F);
    const double* pd = P + T::DOFB + i * DOF_STRIDE;
    const double damp = pd[D_DAMP];
    double passive = -damp * v[i];
    if (!tb.dof_free[i])
      passive = passive + (-pd[D_STIFF] * (q[tb.dof_q[i]] - pd[D_QSPRING]));
    double act = 0.0;
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      const double* pa = P + T::ACT + a * ACT_STRIDE;
      if (static_cast<int>(pa[A_DOF]) == i) {
        double c = u[a];
        if (pa[A_LIMITED] != 0.0) c = clip(c, pa[A_LO], pa[A_HI]);
        act += c * pa[A_GEAR];
      }
    }
    bias[i] = passive + act - bias[i];  // f, in place of the bias
  }
  double* coef = sm + LY::COEF;
  double* aref = sm + LY::AREF;
  double* invR = sm + LY::INVR;
  if constexpr (NLIM > 0) {
#pragma unroll 1
    for (int k = lane; k < NLIM; k += WARP) {
      const int d = tb.lim_dof[k];
      const double* pl = P + T::LIM + k * LIM_STRIDE;
      const double qd = q[tb.dof_q[d]];
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const int r = side * NLIM + k;
        const double dist = side == 0 ? qd - pl[L_LO] : pl[L_HI] - qd;
        const double vel = side == 0 ? v[d] : -v[d];
        const double inc = dist < pl[L_MARGIN] ? 1.0 : 0.0;
        const double imp = dist - pl[L_MARGIN];
        const double dd = impedance(pl, imp);
        const double kk = dd / pl[L_KDEN];
        aref[r] = (-pl[L_B]) * vel - kk * imp;
        const double Rr =
            at_least((1.0 - dd) / at_least(dd, 1e-6), 1e-9) * pl[L_INVW];
        invR[r] = inc / Rr;
        coef[tb.row_coef[r]] = side == 0 ? 1.0 : -1.0;
      }
    }
  }
  if constexpr (T::NPAIR > 0) {
#pragma unroll 1
    for (int s = lane; s < T::NSLOT; s += WARP) {
      double* sd = slot + SLOT_DOUBLES * s;
      const double* pc = P + T::PAIRB + tb.slot_pair[s] * PAIR_STRIDE +
                         PAIR_CONST;
      const double inc = sd[12] < pc[L_MARGIN] ? 1.0 : 0.0;
      const double imp = sd[12] - pc[L_MARGIN];
      const double dd = impedance(pc, imp);
      const double kk = dd / pc[L_KDEN];
      const double Rr =
          at_least((1.0 - dd) / at_least(dd, 1e-6), 1e-9) * pc[C_RCONST];
      sd[13] = kk;
      sd[14] = imp;
      sd[15] = inc / Rr;
    }
    warp_sync();
    // the point Jacobians and the four rows' coefficients, one thread per
    // (slot, support dof)
#pragma unroll 1
    for (int m = lane; m < WarpSizes<T>::NJI; m += WARP) {
      const int s = tb.ji_slot[m], w = tb.ji_w[m];
      const int p = tb.slot_pair[s];
      const double* sd = slot + SLOT_DOUBLES * s;
      const int i = tb.supp[p * NV + w];
      const double sg = tb.supp_sign[p * NV + w] > 0 ? 1.0 : -1.0;
      double wp[3], jac[3], J[3];
      cross3(cdof[i], sd, wp);
#pragma unroll
      for (int k = 0; k < 3; ++k) jac[k] = (cdof[i][3 + k] + wp[k]) * sg;
#pragma unroll
      for (int a = 0; a < 3; ++a)
        J[a] = (sd[3 + 3 * a] * jac[0] + sd[3 + 3 * a + 1] * jac[1]) +
               sd[3 + 3 * a + 2] * jac[2];
      const double mu = P[T::PAIRB + p * PAIR_STRIDE + PAIR_CONST + C_MU];
      const int r0 = 2 * NLIM + 4 * s;  // the slot's first row
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const double smu = (e % 2 == 0) ? mu : -mu;
        coef[tb.row_coef[r0 + e] + w] = J[0] + smu * J[1 + e / 2];
      }
    }
    warp_sync();
    // each contact row's velocity sum, aref and invR
#pragma unroll 1
    for (int r = 2 * NLIM + lane; r < T::R; r += WARP) {
      const int s = (r - 2 * NLIM) / 4;
      const int p = tb.slot_pair[s];
      const double* sd = slot + SLOT_DOUBLES * s;
      const double* pc = P + T::PAIRB + p * PAIR_STRIDE + PAIR_CONST;
      const int c0 = tb.row_coef[r], W = tb.row_w[r];
      double vel = 0.0;
#pragma unroll 4
      for (int w = 0; w < W; ++w) {
        const double cv = coef[c0 + w] * v[tb.coef_dof[c0 + w]];
        vel = w == 0 ? cv : vel + cv;
      }
      aref[r] = (-pc[L_B]) * vel - sd[13] * sd[14];
      invR[r] = sd[15];
    }
  }
  warp_sync();
  WARP_MARK(2);
}

// a0 = M^-1 f and the NEWTON_ITERS projected-Newton iterations from it
// (constraint.cuh:constraint_solve, newton_iterations) -> x in X.
template <class T>
__device__ void warp_newton(double* sm, int lane) {
  using LY = WarpLayout<T>;
  constexpr int NV = T::NV, R = T::R, NLIM = T::NLIM;
  constexpr int NTRI = NV * (NV + 1) / 2;
  const WarpTables<T>& tb = warp_tables<T>();
  const double* M = sm + LY::M;
  double* H = sm + LY::HS;
  double* a0 = sm + LY::A0;
  double* x = sm + LY::X;
  double* dx = sm + LY::DX;
  double* e = sm + LY::E;
  double* Me = sm + LY::ME;
  double* Mdx = sm + LY::MDX;
  const double* coef = sm + LY::COEF;
  const double* aref = sm + LY::AREF;
  const double* invR = sm + LY::INVR;
  double* y = sm + LY::Y;
  double* jdx = sm + LY::JDX;
  double* mer = sm + LY::MER;
  const double* f = sm + LY::F;
#pragma unroll 1
  for (int m = lane; m < NTRI; m += WARP) H[m] = M[m];
#pragma unroll 1
  for (int i = lane; i < NV; i += WARP) a0[i] = f[i];
  warp_sync();
  warp_solve<T>(H, a0, lane);
#pragma unroll 1
  for (int i = lane; i < NV; i += WARP) x[i] = a0[i];
  warp_sync();
  WARP_MARK(3);
#pragma unroll 1
  for (int it = 0; it < NEWTON_ITERS; ++it) {
    warp_rows_times<T>(tb, coef, x, y, lane);
#pragma unroll 1
    for (int r = lane; r < R; r += WARP) y[r] = y[r] - aref[r];
#pragma unroll 1
    for (int i = lane; i < NV; i += WARP) e[i] = x[i] - a0[i];
#pragma unroll 1
    for (int m = lane; m < NTRI; m += WARP) H[m] = M[m];
    warp_sync();
    warp_sym_times<NV>(M, e, Me, lane);
#pragma unroll 1
    for (int i = lane; i < NV; i += WARP) dx[i] = Me[i];
    warp_sync();
    WARP_MARK(4);
    // the gradient and H over the rows in row order: the limit rows (row k
    // then NLIM + k touch dof lim_dof(k) alone), then pair by pair
#pragma unroll 1
    for (int k = lane; k < NLIM; k += WARP) {
      const int d = tb.lim_dof[k];
      double gd = dx[d], hd = H[tri(d, d)];
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const int r = side * NLIM + k;
        const double g = y[r] < 0.0 ? invR[r] : 0.0;
        const double gy = g * y[r];
        const double c = coef[tb.row_coef[r]];
        gd = gd + c * gy;
        hd = hd + (c * g) * c;
      }
      dx[d] = gd;
      H[tri(d, d)] = hd;
    }
    warp_sync();
    // the pairs: each thread its own entries (WarpTables::h_item), so
    // that no pair waits for the one before it
#pragma unroll 1
    for (int it = tb.h_off[lane]; it < tb.h_off[lane + 1]; ++it) {
      const int code = tb.h_item[it];
      const int p = code >> 16, w1 = (code >> 8) & 255, w2 = code & 255;
      const int W = tb.pair_w[p], nr = tb.pair_nrow[p];
      const int r0 = tb.pair_row0[p], c0 = tb.pair_coef0[p];
      const short* sp = tb.supp + p * NV;
      if (w2 != 255) {
        double* hp = H + tri(sp[w1], sp[w2]);
        double hv = *hp;
#pragma unroll 4
        for (int rr = 0; rr < nr; ++rr) {
          const int r = r0 + rr;
          const double g = y[r] < 0.0 ? invR[r] : 0.0;
          const double* cf = coef + c0 + rr * W;
          hv = hv + (cf[w1] * g) * cf[w2];
        }
        *hp = hv;
      } else {
        double* gp = dx + sp[w1];
        double gv = *gp;
#pragma unroll 4
        for (int rr = 0; rr < nr; ++rr) {
          const int r = r0 + rr;
          const double g = y[r] < 0.0 ? invR[r] : 0.0;
          const double gy = g * y[r];
          gv = gv + coef[c0 + rr * W + w1] * gy;
        }
        *gp = gv;
      }
    }
    warp_sync();
#pragma unroll 1
    for (int i = lane; i < NV; i += WARP)
      H[tri(i, i)] = H[tri(i, i)] + HESSIAN_JITTER;
    warp_sync();
    WARP_MARK(5);
    warp_solve<T>(H, dx, lane);
    WARP_MARK(6);
#pragma unroll 1
    for (int i = lane; i < NV; i += WARP) dx[i] = -dx[i];
    warp_sync();

    // merit along x + alpha dx from shared products
    warp_rows_times<T>(tb, coef, dx, jdx, lane);
    warp_sym_times<NV>(M, dx, Mdx, lane);
    warp_sync();
    if (lane < N_ALPHA + 1) {
      // lane a < 6: step length a; lane 6: alpha = 0 (J dx taken as 0)
      const double al = lane < N_ALPHA ? alpha_ladder(lane) : 0.0;
      double s = 0.0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const double jd = lane < N_ALPHA ? jdx[r] : 0.0;
        const double ya = y[r] + al * jd;
        const double neg = ya < 0.0 ? ya : 0.0;
        s += invR[r] * (neg * neg);
      }
      mer[lane] = s;
    } else if (lane < N_ALPHA + 4) {
      const int which = lane - N_ALPHA - 1;  // e'Me, e'M dx, dx'M dx
      const double* a = which == 2 ? dx : e;
      const double* b = which == 0 ? Me : Mdx;
      double s = 0.0;
#pragma unroll
      for (int i = 0; i < NV; ++i) s += a[i] * b[i];
      mer[N_ALPHA + 1 + which] = s;
    }
    warp_sync();
    // each step length's merit on its thread; every thread then takes the
    // first minimum over the six, in order
    const double eMe = mer[7], eMdx = mer[8], dMd = mer[9];
    double cost = 0.0;
    if (lane < N_ALPHA) {
      const double al = alpha_ladder(lane);
      cost = 0.5 * (eMe + (2.0 * al) * eMdx + (al * al) * dMd) +
             0.5 * mer[lane];
    }
    const double c0 = 0.5 * eMe + 0.5 * mer[N_ALPHA];
    double best_c = 0.0, best_a = 0.0;
#pragma unroll
    for (int a = 0; a < N_ALPHA; ++a) {
      const double ca = __shfl_sync(FULL_WARP, cost, a);
      if (a == 0 || ca < best_c || (isnan(ca) && !isnan(best_c))) {
        best_c = ca;
        best_a = alpha_ladder(a);
      }
    }
    const double alpha = best_c < c0 ? best_a : 0.0;
#pragma unroll 1
    for (int i = lane; i < NV; i += WARP) x[i] = x[i] + alpha * dx[i];
    warp_sync();
    WARP_MARK(7);
  }
}

// qc = J' f at x (constraint.cuh:constraint_force) -> QC
template <class T>
__device__ void warp_constraint_force(double* sm, int lane) {
  using LY = WarpLayout<T>;
  constexpr int NV = T::NV, R = T::R, NLIM = T::NLIM;
  const WarpTables<T>& tb = warp_tables<T>();
  const double* coef = sm + LY::COEF;
  const double* aref = sm + LY::AREF;
  const double* invR = sm + LY::INVR;
  double* frc = sm + LY::JDX;
  double* qc = sm + LY::QC;
  warp_rows_times<T>(tb, coef, sm + LY::X, frc, lane);
#pragma unroll 1
  for (int r = lane; r < R; r += WARP) {
    const double yr = frc[r] - aref[r];
    frc[r] = (-(yr < 0.0 ? yr : 0.0)) * invR[r];
  }
#pragma unroll 1
  for (int i = lane; i < NV; i += WARP) qc[i] = 0.0;
  warp_sync();
#pragma unroll 1
  for (int k = lane; k < NLIM; k += WARP) {
    const int d = tb.lim_dof[k];
    double v = qc[d];
    v = v + coef[tb.row_coef[k]] * frc[k];
    v = v + coef[tb.row_coef[NLIM + k]] * frc[NLIM + k];
    qc[d] = v;
  }
  warp_sync();
#pragma unroll 1
  for (int p = 0; p < T::NPAIR; ++p) {
    const int W = tb.pair_w[p], nr = tb.pair_nrow[p];
    const int r0 = tb.pair_row0[p], c0 = tb.pair_coef0[p];
#pragma unroll 1
    for (int w = lane; w < W; w += WARP) {
      double* qp = qc + tb.supp[p * NV + w];
      double v = *qp;
#pragma unroll 4
      for (int rr = 0; rr < nr; ++rr)
        v = v + coef[c0 + rr * W + w] * frc[r0 + rr];
      *qp = v;
    }
    warp_sync();
  }
  WARP_MARK(8);
}

// One step of the lane in shared memory: (q, v, u) -> (q, v) in place,
// with WANT_RES its residual at (q, v, u) in RES (targets in TG).
template <class T, bool WANT_RES>
__device__ void warp_step(const double* __restrict__ P, double* sm,
                          const double* resc, int lane) {
  static_assert(ancestors_first<T>(),
                "a dof's root path must come before it (CRBA's rows)");
  using LY = WarpLayout<T>;
  constexpr int NV = T::NV;
  const WarpTables<T>& tb = warp_tables<T>();
  warp_prelude<T, WANT_RES>(P, sm, resc, lane);
  double* f = sm + LY::F;
  double* M = sm + LY::M;
  if constexpr (T::R > 0) {
    warp_newton<T>(sm, lane);
    warp_constraint_force<T>(sm, lane);
#pragma unroll 1
    for (int i = lane; i < NV; i += WARP) f[i] = f[i] + sm[LY::QC + i];
  }
  const double h = P[T::DT];
#pragma unroll 1
  for (int i = lane; i < NV; i += WARP)
    M[tri(i, i)] += h * P[T::DOFB + i * DOF_STRIDE + D_DAMP];
  warp_sync();
  warp_solve<T>(M, f, lane);
  double* v = sm + LY::V;
#pragma unroll 1
  for (int i = lane; i < NV; i += WARP) v[i] = v[i] + h * f[i];
  warp_sync();
  if (lane == 0) integrate_pos<T>(sm + LY::Q, v, h, sm + LY::Q);
  warp_sync();
  WARP_MARK(9);
}

}  // namespace trajopt
