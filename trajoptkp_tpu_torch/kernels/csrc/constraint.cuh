// K2a: joint-limit rows and the projected-Newton constraint solve for one
// lane, in double precision.
//
// Replaces, in the JAX lane engine trajoptkp_tpu/dynamics/lanes.py, the
// limit rows (_limit_rows_regs:672, _impedance_reg:656) and the solver
// (_solve_rows:1523 over _stack_solver_operands:1387 and _solve_rows_x:1427),
// i.e. the cold-start semantics of trajoptkp_tpu/dynamics/contact.py
// (_limit_rows:283, _newton_iterations:38, solve_constraints:344).  It is a
// __device__ function called by smooth_step (step.cuh) between the force
// assembly and the (M + h D) solve, so it runs inside the rollout (K3),
// line-search (K4) and FD-Jacobian (K5) kernels, as the JAX lane step fuses
// it (lanes.py:1673-1682).  Plain twin:
// trajoptkp_tpu_torch/dynamics/contact.py (solve_constraints).
//
// Per step and lane: two one-sided rows per limited joint (impedance sigmoid
// from solimp, aref from solref), a0 = M^-1 qfrc by Cholesky, then
// NEWTON_ITERS iterations from x = a0.  Each builds H = M + J'GJ + 1e-10 I
// over the rows with y = J x - aref < 0, factors it, and searches the merit
// along the Newton direction over six step lengths from shared products
// (e'Me, e'M dx, dx'M dx, J dx); the first minimum wins and is taken only if
// it beats the merit at alpha = 0.  The result is qfrc_con = J' f,
// f = -min(y, 0) / R.  The solution x itself is not used: the integrator
// solves (M + h D) qacc = qfrc + qfrc_con.
//
// Row format: sparse.  Row r touches the dofs T::row_dof(r, w),
// w < T::row_w(r) <= ROW_W, with coefficients rows.coef[r][w]; a limit row
// has one entry, +1 (q - lo) or -1 (hi - q).  Row order: every limited
// joint's lower side, then every upper side (the JAX generic engine's
// order), then the contact rows of contact.cuh (K2b), four per slot over
// the support of the slot's pair.  R, ROW_W, row_dof and row_w come from
// the topology's tables; the loops over the rows run at compile time
// (for_rows: static_for), so each row's dofs and width are constants of
// its own iteration, with any number of pairs, or under TRAJOPT_ROLL_LOOPS
// as a loop that reads them from the table (push_lcl's 114 rows over 31
// dofs: unrolled, nvcc would take tens of minutes).
// The per-joint constants (range, margin, impedance and solref products) are
// folded on the host in doubles and read from the model buffer, LIM_STRIDE
// per limited joint (kernels/ops.py:pack_model, dynamics/contact.py
// LIMIT_FIELDS), so this code and the twin start from the same numbers.  The
// impedance power must be a small integer and is multiplied out: CUDA's pow
// and torch.pow need not round alike.
//
// K2c, in the forward-mode step of K5ad (ad_jacobian.cu), where the rows,
// M and the smooth force are dual numbers (dual.cuh): the Newton
// iterations run on the values alone, and the solution's tangent is the
// implicit one at the iterate they return (JAX dynamics/contact.py:
// _newton_solver:95-135, lanes.py:_solve_rows_x_jvp:1490 and
// _solve_rows_x_regs_jvp:1309): dx = -(H + 1e-10 I)^-1 dF, H = M + J'GJ
// gated at x, dF the tangent of F = M (x - a0) + J' (min(y, 0) invR) at
// the fixed x, evaluated in dual numbers (`implicit_tangent`); the force is
// then recomputed from the dual x.  Plain twin:
// dynamics/contact.py:_NewtonSolve, implicit_residual_tangent.
//
// Rounding: every sum runs left to right exactly as the twin's (-fmad=false),
// because `dist < margin`, `y < 0` and the choice of step length are
// branches, and central FD divides a flipped branch's jump by 2 eps.
//
// Bound: per step ~2 NV^3/3 + 8 iterations x (NV^3/3 + 7 NV^2 + ~50 R +
// 3 sum_r row_w(r)^2) dependent double operations per lane (about 10k at
// panda with 14 limit rows, ~50k at push_ncl with 42 rows up to 13 wide,
// ~414k at push_lcl with 114 rows over 31 dofs, beside ~6-52k for the
// smooth step; chip_smoke.py:constraint_ops and newton_ops count them term
// by term) and no global memory traffic of its own beyond the constants
// per joint and pair: bound by the latency of the dependent double
// arithmetic.  These functions run one lane per thread, H and L (NV x NV)
// in local memory past panda width, the Newton and step-length loops
// rolled to bound code size and compile time; warp_step.cuh runs the same
// solve across a warp for K4 (its Cholesky right-looking by column, a
// chain NV columns long instead of NV^2/2).  In K5ad the Newton iterations
// and K2c's gated-Hessian factor run once per (slot, lane) in its primal
// pass (ad_primal) and every column reads them (constraint_solve given
// the buffer); K2c's column solve reads the packed factor from global
// memory (linalg.cuh:chol_solve_packed).
#pragma once

#include "dual.cuh"
#include "linalg.cuh"

namespace trajopt {

constexpr int LIM_STRIDE = 13;
enum LimField {
  L_LO = 0, L_HI = 1, L_MARGIN = 2, L_INVW = 3, L_WIDTH = 4, L_MID = 5,
  L_DEN_LO = 6, L_DEN_HI = 7, L_D0 = 8, L_DSPAN = 9, L_B = 10, L_KDEN = 11,
  L_POWER = 12
};
constexpr int NEWTON_ITERS = 8;  // cold start, contact._NEWTON_ITERS
constexpr int N_ALPHA = 6;
constexpr double HESSIAN_JITTER = 1e-10;

template <int R, int W, class S = double>
struct Rows {
  S coef[R][W];
  S aref[R];
  S invR[R];  // active / R: an inactive row contributes nothing
};

// K5ad's primal buffer of one (slot, lane), batch last (entry e at
// p[e * stride]): the Newton iterate x (NV), the lower Cholesky factor of
// K2c's gated Hessian at x packed row by row (entry (i, k <= i) at
// i (i + 1) / 2 + k), then with a free rotation in the state the nominal
// next positions (NQ); kernels/ops.py:ad_primal_entries mirrors it.
struct AdPrimalBuf {
  double* p;
  long long stride;
};

template <class T>
struct AdLayout {
  static constexpr int NTRI = T::NV * (T::NV + 1) / 2;
  static constexpr int X = 0;
  static constexpr int L = T::NV;
  static constexpr int QN = T::R > 0 ? T::NV + NTRI : 0;
  static constexpr int ENTRIES = QN + (T::HAS_ROT ? T::NQ : 0);
};

// K5ad's tangent pass is launched while its primal pass still runs
// (programmatic dependent launch, csrc/ad_jacobian.cu): the primal pass
// lets it start at once, and the tangent pass waits for the primal pass's
// end, and for its writes to be visible, just before its first read of
// the buffer.  Each is a no-op in a launch without that attribute and on
// the host.
__device__ __forceinline__ void primal_release_tangents() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  asm volatile("griddepcontrol.launch_dependents;");
#endif
}

__device__ __forceinline__ void wait_for_primal() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  asm volatile("griddepcontrol.wait;" ::: "memory");
#endif
}

__host__ __device__ constexpr int tri(int i, int k) {
  return i * (i + 1) / 2 + k;
}

// x^n for n >= 1 by repeated multiplication
template <class S>
__device__ __forceinline__ S ipow(S x, int n) {
  S r = x;
  for (int k = 1; k < n; ++k) r = r * x;
  return r;
}

// mj_assignImpedance: power sigmoid from d0 to d0 + dspan over `width`
template <class S>
__device__ __forceinline__ S impedance(const double* pl, S pos) {
  const S x = clip(fabs(pos) / pl[L_WIDTH], 0.0, 1.0);
  const int pw = static_cast<int>(pl[L_POWER]);
  const S y_lo = ipow(x, pw) / pl[L_DEN_LO];
  const S y_hi = 1.0 - ipow(1.0 - x, pw) / pl[L_DEN_HI];
  const S y = x <= pl[L_MID] ? y_lo : y_hi;
  return pl[L_D0] + y * pl[L_DSPAN];
}

// Rows 0..NLIM-1: q - lo of each limited joint; NLIM..2 NLIM-1: hi - q.
template <class T, class S>
__device__ __forceinline__ void limit_rows(
    const double* __restrict__ P, const S* q, const S* v,
    Rows<T::R, T::ROW_W, S>& rows) {
  constexpr int NLIM = T::NLIM;
#pragma unroll
  for (int side = 0; side < 2; ++side) {
#pragma unroll
    for (int k = 0; k < NLIM; ++k) {
      const int r = side * NLIM + k;
      const int d = T::lim_dof(k);
      const double* pl = P + T::LIM + k * LIM_STRIDE;
      const S qd = q[T::dof_q(d)];
      const S dist = side == 0 ? qd - pl[L_LO] : pl[L_HI] - qd;
      const S vel = side == 0 ? v[d] : -v[d];
      const double inc = dist < pl[L_MARGIN] ? 1.0 : 0.0;
      const S imp = dist - pl[L_MARGIN];
      const S dd = impedance(pl, imp);
      const S kk = dd / pl[L_KDEN];
      rows.aref[r] = (-pl[L_B]) * vel - kk * imp;
      const S Rr =
          at_least((1.0 - dd) / at_least(dd, 1e-6), 1e-9) * pl[L_INVW];
      rows.invR[r] = inc / Rr;
      rows.coef[r][0] = side == 0 ? 1.0 : -1.0;
    }
  }
}

// out[r] = sum_w coef[r][w] x[row dof w], left to right
template <class T, class S, class X, class O>
__device__ __forceinline__ void rows_times(const Rows<T::R, T::ROW_W, S>& rows,
                                           const X* x, O* out) {
  for_rows<T::R>([&](auto rc) {
    const int r = row_index(rc);
    const int RW = T::row_w(rc);
    O s = rows.coef[r][0] * x[T::row_dof(rc, 0)];
#pragma unroll
    for (int w = 1; w < RW; ++w)
      s += rows.coef[r][w] * x[T::row_dof(rc, w)];
    out[r] = s;
  });
}

// the same over the rows' values (the primal of dual rows)
template <class T, class S>
__device__ __forceinline__ void rows_times_v(
    const Rows<T::R, T::ROW_W, S>& rows, const double* x, double* out) {
  for_rows<T::R>([&](auto rc) {
    const int r = row_index(rc);
    const int RW = T::row_w(rc);
    double s = val(rows.coef[r][0]) * x[T::row_dof(rc, 0)];
#pragma unroll
    for (int w = 1; w < RW; ++w)
      s += val(rows.coef[r][w]) * x[T::row_dof(rc, w)];
    out[r] = s;
  });
}

// sum_r invR_r min(y_r + al jdx_r, 0)^2, left to right
template <int R, class S>
__device__ __forceinline__ double penalty(const S* invR, const double* y,
                                          const double* jdx, double al) {
  double s = 0.0;
  TRAJOPT_UNROLL
  for (int r = 0; r < R; ++r) {
    const double ya = y[r] + al * jdx[r];
    const double neg = ya < 0.0 ? ya : 0.0;
    s += val(invR[r]) * (neg * neg);
  }
  return s;
}

// H = M + J' diag(g) J + jitter I over the rows' values, row by row
template <class T, class S, class SM>
__device__ __forceinline__ void gated_hessian(
    const SM (&M)[T::NV][T::NV], const Rows<T::R, T::ROW_W, S>& rows,
    const double* g, double (&H)[T::NV][T::NV]) {
  constexpr int NV = T::NV;
  TRAJOPT_UNROLL
  for (int i = 0; i < NV; ++i)
    TRAJOPT_UNROLL
    for (int k = 0; k < NV; ++k) H[i][k] = val(M[i][k]);
  for_rows<T::R>([&](auto rc) {
    const int r = row_index(rc);
    const int RW = T::row_w(rc);
#pragma unroll
    for (int w1 = 0; w1 < RW; ++w1) {
      const int d1 = T::row_dof(rc, w1);
#pragma unroll
      for (int w2 = 0; w2 < RW; ++w2) {
        const int d2 = T::row_dof(rc, w2);
        H[d1][d2] = H[d1][d2] +
                    (val(rows.coef[r][w1]) * g[r]) * val(rows.coef[r][w2]);
      }
    }
  });
  TRAJOPT_UNROLL
  for (int i = 0; i < NV; ++i) H[i][i] = H[i][i] + HESSIAN_JITTER;
}

// NEWTON_ITERS projected-Newton iterations from x = a0 over the values of
// (M, rows): the primal solve, in double whatever the rows' scalar.
template <class T, class S, class SM>
__device__ __forceinline__ void newton_iterations(
    const SM (&M)[T::NV][T::NV], const double (&a0)[T::NV],
    const Rows<T::R, T::ROW_W, S>& rows, double (&x)[T::NV]) {
  constexpr int NV = T::NV, R = T::R;
  double H[NV][NV];
  TRAJOPT_UNROLL
  for (int i = 0; i < NV; ++i) x[i] = a0[i];
  const double ladder[N_ALPHA] = {1.0, 0.5, 0.25, 0.1, 0.04, 0.01};
  double zero[R];
  TRAJOPT_UNROLL
  for (int r = 0; r < R; ++r) zero[r] = 0.0;

#pragma unroll 1
  for (int it = 0; it < NEWTON_ITERS; ++it) {
    double y[R], g[R], e[NV], Me[NV], dx[NV], jdx[R], Mdx[NV];
    rows_times_v<T>(rows, x, y);
    TRAJOPT_UNROLL
    for (int r = 0; r < R; ++r) {
      y[r] = y[r] - val(rows.aref[r]);
      g[r] = y[r] < 0.0 ? val(rows.invR[r]) : 0.0;
    }
    TRAJOPT_UNROLL
    for (int i = 0; i < NV; ++i) e[i] = x[i] - a0[i];
    TRAJOPT_UNROLL
    for (int i = 0; i < NV; ++i) {
      double s = val(M[i][0]) * e[0];
      TRAJOPT_UNROLL
      for (int k = 1; k < NV; ++k) s += val(M[i][k]) * e[k];
      Me[i] = s;
      dx[i] = s;  // becomes the gradient, then the Newton direction
      TRAJOPT_UNROLL
      for (int k = 0; k < NV; ++k) H[i][k] = val(M[i][k]);
    }
    for_rows<R>([&](auto rc) {
      const int r = row_index(rc);
      const int RW = T::row_w(rc);
      const double gy = g[r] * y[r];
#pragma unroll
      for (int w1 = 0; w1 < RW; ++w1) {
        const int d1 = T::row_dof(rc, w1);
        dx[d1] = dx[d1] + val(rows.coef[r][w1]) * gy;
#pragma unroll
        for (int w2 = 0; w2 < RW; ++w2) {
          const int d2 = T::row_dof(rc, w2);
          H[d1][d2] = H[d1][d2] + (val(rows.coef[r][w1]) * g[r]) *
                                      val(rows.coef[r][w2]);
        }
      }
    });
    TRAJOPT_UNROLL
    for (int i = 0; i < NV; ++i) H[i][i] = H[i][i] + HESSIAN_JITTER;
    chol_factor<NV>(H);
    chol_solve<NV>(H, dx);
    TRAJOPT_UNROLL
    for (int i = 0; i < NV; ++i) dx[i] = -dx[i];

    // merit along x + alpha dx from shared products
    rows_times_v<T>(rows, dx, jdx);
    double eMe = 0.0, eMdx = 0.0, dMd = 0.0;
    TRAJOPT_UNROLL
    for (int i = 0; i < NV; ++i) {
      double s = val(M[i][0]) * dx[0];
      TRAJOPT_UNROLL
      for (int k = 1; k < NV; ++k) s += val(M[i][k]) * dx[k];
      Mdx[i] = s;
    }
    TRAJOPT_UNROLL
    for (int i = 0; i < NV; ++i) {
      eMe += e[i] * Me[i];
      eMdx += e[i] * Mdx[i];
      dMd += dx[i] * Mdx[i];
    }
    const double c0 = 0.5 * eMe + 0.5 * penalty<R>(rows.invR, y, zero, 0.0);
    double best_c = 0.0, best_a = 0.0;
#pragma unroll 1
    for (int a = 0; a < N_ALPHA; ++a) {
      const double al = ladder[a];
      const double cost =
          0.5 * (eMe + (2.0 * al) * eMdx + (al * al) * dMd) +
          0.5 * penalty<R>(rows.invR, y, jdx, al);
      // first minimum wins; a NaN cost wins over numbers (argmin)
      if (a == 0 || cost < best_c || (isnan(cost) && !isnan(best_c))) {
        best_c = cost;
        best_a = al;
      }
    }
    const double alpha = best_c < c0 ? best_a : 0.0;
    TRAJOPT_UNROLL
    for (int i = 0; i < NV; ++i) x[i] = x[i] + alpha * dx[i];
  }
}

// qc = J' f, f = -min(J x - aref, 0) invR
template <class T, class S>
__device__ __forceinline__ void constraint_force(
    const Rows<T::R, T::ROW_W, S>& rows, const S (&x)[T::NV],
    S (&qc)[T::NV]) {
  S y[T::R];
  rows_times<T>(rows, x, y);
  TRAJOPT_UNROLL
  for (int i = 0; i < T::NV; ++i) qc[i] = 0.0;
  for_rows<T::R>([&](auto rc) {
    const int r = row_index(rc);
    const int RW = T::row_w(rc);
    const S yr = y[r] - rows.aref[r];
    const S f = (-(yr < 0.0 ? yr : S(0.0))) * rows.invR[r];
#pragma unroll
    for (int w = 0; w < RW; ++w) {
      const int d = T::row_dof(rc, w);
      qc[d] = qc[d] + rows.coef[r][w] * f;
    }
  });
}

// qc = J' f at the solution of the soft-constraint problem for
// (M, qfrc, rows).
template <class T>
__device__ void constraint_solve(const double (&M)[T::NV][T::NV],
                                 const double (&qfrc)[T::NV],
                                 const Rows<T::R, T::ROW_W>& rows,
                                 double (&qc)[T::NV],
                                 const AdPrimalBuf* = nullptr) {
  constexpr int NV = T::NV;
  double H[NV][NV], a0[NV], x[NV];
  TRAJOPT_UNROLL
  for (int i = 0; i < NV; ++i) {
    a0[i] = qfrc[i];
    TRAJOPT_UNROLL
    for (int k = 0; k < NV; ++k) H[i][k] = M[i][k];
  }
  chol_factor<NV>(H);
  chol_solve<NV>(H, a0);
  newton_iterations<T>(M, a0, rows, x);
  constraint_force<T>(rows, x, qc);
}

// K2c's values, once per (slot, lane) in K5ad's primal pass: a0 and the
// Newton iterate x of the step's values (as constraint_solve runs them),
// the gate at x and the Cholesky factor of the gated Hessian (as
// implicit_tangent computes them), written to `ad` (AdLayout).  The dual
// step's values are these numbers: each dual operation's value is the
// double operation.
template <class T>
__device__ void ad_primal(const double (&M)[T::NV][T::NV],
                          const double (&qfrc)[T::NV],
                          const Rows<T::R, T::ROW_W>& rows,
                          const AdPrimalBuf& ad) {
  constexpr int NV = T::NV, R = T::R;
  double H[NV][NV], a0[NV], x[NV];
  TRAJOPT_UNROLL
  for (int i = 0; i < NV; ++i) {
    a0[i] = qfrc[i];
    TRAJOPT_UNROLL
    for (int k = 0; k < NV; ++k) H[i][k] = M[i][k];
  }
  chol_factor<NV>(H);
  chol_solve<NV>(H, a0);
  newton_iterations<T>(M, a0, rows, x);
  double y[R], g[R];
  rows_times_v<T>(rows, x, y);
  TRAJOPT_UNROLL
  for (int r = 0; r < R; ++r) {
    y[r] = y[r] - rows.aref[r];
    g[r] = y[r] < 0.0 ? rows.invR[r] : 0.0;
  }
  gated_hessian<T>(M, rows, g, H);
  chol_factor<NV>(H);
  TRAJOPT_UNROLL
  for (int i = 0; i < NV; ++i) {
    ad.p[(AdLayout<T>::X + i) * ad.stride] = x[i];
    TRAJOPT_UNROLL
    for (int k = 0; k <= i; ++k)
      ad.p[(AdLayout<T>::L + tri(i, k)) * ad.stride] = H[i][k];
  }
}

// K2c: dx = -(H + 1e-10 I)^-1 dF at the Newton iterate x, dF the tangent
// of F = M (x - a0) + J' (min(J x - aref, 0) invR) at the fixed x, F
// evaluated in dual numbers row by row in the order of
// dynamics/contact.py:implicit_residual_tangent.
// The gated Hessian's factor is the one the primal pass wrote to `ad`
// (ad_primal): the same numbers, read instead of computed.
template <class T>
__device__ void implicit_tangent(const Dual (&M)[T::NV][T::NV],
                                 const Dual (&a0)[T::NV],
                                 const Rows<T::R, T::ROW_W, Dual>& rows,
                                 const double (&x)[T::NV],
                                 double (&dx)[T::NV],
                                 const AdPrimalBuf& ad) {
  constexpr int NV = T::NV;
  Dual e[NV], F[NV];
  TRAJOPT_UNROLL
  for (int i = 0; i < NV; ++i) e[i] = x[i] - a0[i];
  TRAJOPT_UNROLL
  for (int i = 0; i < NV; ++i) {
    Dual s = M[i][0] * e[0];
    TRAJOPT_UNROLL
    for (int k = 1; k < NV; ++k) s = s + M[i][k] * e[k];
    F[i] = s;
  }
  for_rows<T::R>([&](auto rc) {
    const int r = row_index(rc);
    const int RW = T::row_w(rc);
    Dual y = rows.coef[r][0] * x[T::row_dof(rc, 0)];
#pragma unroll
    for (int w = 1; w < RW; ++w)
      y = y + rows.coef[r][w] * x[T::row_dof(rc, w)];
    y = y - rows.aref[r];
    const Dual f = (y < 0.0 ? y : Dual(0.0)) * rows.invR[r];
#pragma unroll
    for (int w = 0; w < RW; ++w) {
      const int d = T::row_dof(rc, w);
      F[d] = F[d] + rows.coef[r][w] * f;
    }
  });
  TRAJOPT_UNROLL
  for (int i = 0; i < NV; ++i) dx[i] = F[i].d;
  chol_solve_packed<NV>(ad.p + AdLayout<T>::L * ad.stride, ad.stride, dx);
  TRAJOPT_UNROLL
  for (int i = 0; i < NV; ++i) dx[i] = -dx[i];
}

// The forward-mode constraint force: a0 = M^-1 qfrc in dual numbers, the
// Newton iterate of the values from K5ad's primal pass (`ad`, which the
// dual step, run only by its tangent pass, is always given), K2c's tangent
// of the iterate, and the force from the dual x.
template <class T>
__device__ void constraint_solve(const Dual (&M)[T::NV][T::NV],
                                 const Dual (&qfrc)[T::NV],
                                 const Rows<T::R, T::ROW_W, Dual>& rows,
                                 Dual (&qc)[T::NV], const AdPrimalBuf* ad) {
  constexpr int NV = T::NV;
  Dual L[NV][NV], a0[NV];
  TRAJOPT_UNROLL
  for (int i = 0; i < NV; ++i) {
    a0[i] = qfrc[i];
    TRAJOPT_UNROLL
    for (int k = 0; k < NV; ++k) L[i][k] = M[i][k];
  }
  chol_factor<NV>(L);
  chol_solve<NV>(L, a0);
  double x[NV], dx[NV];
  wait_for_primal();
  TRAJOPT_UNROLL
  for (int i = 0; i < NV; ++i)
    x[i] = ad->p[(AdLayout<T>::X + i) * ad->stride];
  implicit_tangent<T>(M, a0, rows, x, dx, *ad);
  Dual xd[NV];
  TRAJOPT_UNROLL
  for (int i = 0; i < NV; ++i) xd[i] = Dual(x[i], dx[i]);
  constraint_force<T>(rows, xd, qc);
}

}  // namespace trajopt
