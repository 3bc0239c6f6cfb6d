// K1: one MuJoCo step for one lane, in double-precision registers.
//
// Replaces the JAX lane step, trajoptkp_tpu/dynamics/lanes.py:1595
// (build_smooth_step; _fk_registers:288, _smooth_force_and_M:509,
// _chol_solve_stacked:412, integrate_q_regs:1549).  It is a __device__
// function shared by the rollout (K3), line-search (K4) and FD-Jacobian (K5)
// kernels, not a kernel of its own.  Its plain twin is
// trajoptkp_tpu_torch/dynamics/step.py:step_state.
//
// Scope: trees whose bodies carry one hinge or slide joint or none (a welded
// body passes its inertia and force to its parent), qpos index = dof index,
// joint limits through the constraint solve of constraint.cuh (K2a), no
// contacts, no free or ball joints.  The topology is a template argument
// (Topo); the numeric model is one double buffer whose layout
// kernels/ops.py:pack_model writes: BODY_STRIDE per body 1..NBODY-1 (the
// joint fields of a welded body are zero), ACT_STRIDE per actuator,
// LIM_STRIDE per limited joint, gravity, timestep.
//
// Per body the step runs FK (quaternion frames, cdof), then RNE for the
// bias force and CRBA over composite inertias for the mass matrix, in the
// compact form of a spatial inertia (m, h = m c, J = I_c + m (c.c I - c c^T)).
// The plain twin (dynamics/fk.py, smooth.py, step.py) runs the same
// recursions.
//
// Rounding: built with -fmad=false, and the plain twin runs the same
// operations in the same order, so on the card the two agree bit for bit
// (FD divides rounding differences by 2 eps; bitwise-equal steps keep the
// kernel and plain solves on the same path through a chaotic horizon).
//
// Bound: one step is ~1.3k (acrobot) to ~6k (panda, plus ~10k for its
// constraint solve) dependent double operations per lane, so a kernel built
// on it is bound by latency per thread, not by bytes; this first version
// runs one lane per thread and spills the per-body arrays to local memory
// from pentabot width up.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "constraint.cuh"
#include "linalg.cuh"

namespace trajopt {

constexpr int BODY_STRIDE = 29;
enum BodyField {
  F_BPOS = 0, F_BQUAT = 3, F_IPOS = 7, F_IQUAT = 10, F_MASS = 14,
  F_INERTIA = 15, F_JPOS = 18, F_JAXIS = 21, F_QPOS0 = 24, F_STIFF = 25,
  F_QSPRING = 26, F_DAMP = 27, F_ARM = 28
};
constexpr int ACT_STRIDE = 5;
enum ActField { A_DOF = 0, A_GEAR = 1, A_LIMITED = 2, A_LO = 3, A_HI = 4 };

// NV dofs, NU actuators, NBODY bodies (world included).  The residual is
// joint-space over the first NJ joints with NUR control terms.  Bit codes:
// joint of dof j is a slide when bit j of SLIDE is set; dof j is limited when
// bit j of LIMITED is set; the parent of body b is (PARENTS >> 4b) & 15; the
// dof of body b is ((BODYDOF >> 4b) & 15) - 1, -1 for a welded body.
template <int NV_, int NU_, int NJ_, int NUR_, int NBODY_, unsigned SLIDE_,
          unsigned long long PARENTS_, unsigned long long BODYDOF_,
          unsigned LIMITED_>
struct Topo {
  static constexpr int NV = NV_;
  static constexpr int NU = NU_;
  static constexpr int NX = 2 * NV_;
  static constexpr int NJ = NJ_;
  static constexpr int NUR = NUR_;
  static constexpr int NRES = 2 * NJ_ + NUR_;
  static constexpr int NBODY = NBODY_;
  __host__ __device__ static constexpr int parent(int b) {
    return static_cast<int>((PARENTS_ >> (4 * b)) & 0xFull);
  }
  __host__ __device__ static constexpr bool slide(int j) {
    return ((SLIDE_ >> j) & 1u) != 0u;
  }
  __host__ __device__ static constexpr int body_dof(int b) {
    return static_cast<int>((BODYDOF_ >> (4 * b)) & 0xFull) - 1;
  }
  // The inverse maps are folded into bit codes once, so that a lookup in an
  // unrolled loop is a shift of a constant like parent(): as loops over the
  // bodies they did not always fold, and an index the compiler cannot see
  // sends the per-body arrays through local memory (pentabot's FD kernel ran
  // 2.2x slower that way).
  __host__ __device__ static constexpr unsigned long long make_dofbody() {
    unsigned long long code = 0;
    for (int b = 1; b < NBODY_; ++b)
      if (body_dof(b) >= 0)
        code |= static_cast<unsigned long long>(b) << (4 * body_dof(b));
    return code;
  }
  static constexpr unsigned long long DOFBODY = make_dofbody();
  // the body of dof j
  __host__ __device__ static constexpr int dof_body(int j) {
    return static_cast<int>((DOFBODY >> (4 * j)) & 0xFull);
  }
  __host__ __device__ static constexpr int count_limited() {
    int n = 0;
    for (int j = 0; j < NV_; ++j) n += (LIMITED_ >> j) & 1u;
    return n;
  }
  __host__ __device__ static constexpr unsigned long long make_limdof() {
    unsigned long long code = 0;
    int k = 0;
    for (int j = 0; j < NV_; ++j)
      if ((LIMITED_ >> j) & 1u) {
        code |= static_cast<unsigned long long>(j) << (4 * k);
        ++k;
      }
    return code;
  }
  static constexpr unsigned long long LIMDOF = make_limdof();
  // the k-th limited dof
  __host__ __device__ static constexpr int lim_dof(int k) {
    return static_cast<int>((LIMDOF >> (4 * k)) & 0xFull);
  }
  static constexpr int NLIM = count_limited();
  // constraint rows (constraint.cuh): two per limited joint, one entry each
  static constexpr int R = 2 * NLIM;
  static constexpr int ROW_W = 1;
  __host__ __device__ static constexpr int row_dof(int r, int /*w*/) {
    return lim_dof(r < NLIM ? r : r - NLIM);
  }
  static constexpr int ACT = (NBODY_ - 1) * BODY_STRIDE;  // actuator block
  static constexpr int LIM = ACT + NU_ * ACT_STRIDE;      // limit block
  static constexpr int GRAV = LIM + NLIM * LIM_STRIDE;
  static constexpr int DT = GRAV + 3;
};

__device__ __forceinline__ void cross3(const double* a, const double* b,
                                       double* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void quat_mul(const double* a, const double* b,
                                         double* o) {
  const double w = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  const double x = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  const double y = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  const double z = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
  o[0] = w; o[1] = x; o[2] = y; o[3] = z;
}

// R(q) v = v + 2 w (u x v) + 2 u x (u x v)
__device__ __forceinline__ void quat_rotate(const double* q, const double* v,
                                            double* o) {
  const double u[3] = {q[1], q[2], q[3]};
  double uv[3], uuv[3];
  cross3(u, v, uv);
  cross3(u, uv, uuv);
#pragma unroll
  for (int k = 0; k < 3; ++k) o[k] = v[k] + 2.0 * (q[0] * uv[k] + uuv[k]);
}

__device__ __forceinline__ void quat_to_mat(const double* q, double* R) {
  const double w = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = 1 - 2 * (y * y + z * z); R[1] = 2 * (x * y - w * z);
  R[2] = 2 * (x * z + w * y);     R[3] = 2 * (x * y + w * z);
  R[4] = 1 - 2 * (x * x + z * z); R[5] = 2 * (y * z - w * x);
  R[6] = 2 * (x * z - w * y);     R[7] = 2 * (y * z + w * x);
  R[8] = 1 - 2 * (x * x + y * y);
}

// rotation vector -> quaternion, with the series form near zero
__device__ __forceinline__ void quat_exp(const double* v, double* o) {
  const double sumsq = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  double w, s;
  if (sumsq < 1e-18) {
    s = 0.5 - sumsq * (1.0 / 48.0);
    w = 1.0 - sumsq / 8.0;
  } else {
    const double angle = sqrt(sumsq);
    const double half = 0.5 * angle;
    s = sin(half) / angle;
    w = cos(half);
  }
  o[0] = w; o[1] = v[0] * s; o[2] = v[1] * s; o[3] = v[2] * s;
}

// Spatial inertia about the world origin in compact form.
struct Inertia {
  double m;
  double h[3];   // m * com
  double J[6];   // xx yy zz xy xz yz of I_com + m (c.c I - c c^T)
};

// o = I s, s = [angular; linear]
__device__ __forceinline__ void inertia_mul(const Inertia& I, const double* s,
                                            double* o) {
  const double* w = s;
  const double* v = s + 3;
  double hv[3], hw[3];
  cross3(I.h, v, hv);
  cross3(I.h, w, hw);
  o[0] = I.J[0] * w[0] + I.J[3] * w[1] + I.J[4] * w[2] + hv[0];
  o[1] = I.J[3] * w[0] + I.J[1] * w[1] + I.J[5] * w[2] + hv[1];
  o[2] = I.J[4] * w[0] + I.J[5] * w[1] + I.J[2] * w[2] + hv[2];
#pragma unroll
  for (int k = 0; k < 3; ++k) o[3 + k] = I.m * v[k] - hw[k];
}

__device__ __forceinline__ void inertia_add(Inertia& a, const Inertia& b) {
  a.m += b.m;
#pragma unroll
  for (int k = 0; k < 3; ++k) a.h[k] += b.h[k];
#pragma unroll
  for (int k = 0; k < 6; ++k) a.J[k] += b.J[k];
}

// v x m (spatial motion cross product)
__device__ __forceinline__ void cross_motion(const double* v, const double* m,
                                             double* o) {
  double a[3], b[3], c[3];
  cross3(v, m, a);
  cross3(v, m + 3, b);
  cross3(v + 3, m, c);
#pragma unroll
  for (int k = 0; k < 3; ++k) { o[k] = a[k]; o[3 + k] = b[k] + c[k]; }
}

// v x* f (spatial force cross product)
__device__ __forceinline__ void cross_force(const double* v, const double* f,
                                            double* o) {
  double a[3], b[3], c[3];
  cross3(v, f, a);
  cross3(v + 3, f + 3, b);
  cross3(v, f + 3, c);
#pragma unroll
  for (int k = 0; k < 3; ++k) { o[k] = a[k] + b[k]; o[3 + k] = c[k]; }
}

__device__ __forceinline__ double dot6(const double* a, const double* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3] +
         a[4] * b[4] + a[5] * b[5];
}

// (q, v, u) -> (qn, vn): FK, RNE bias, CRBA mass matrix, passive and
// actuator forces, the constraint force of the limit rows (K2a),
// (M + h D) qacc = f, semi-implicit Euler.
template <class T>
__device__ void smooth_step(const double* __restrict__ P, const double* q,
                            const double* v, const double* u, double* qn,
                            double* vn) {
  constexpr int NV = T::NV;
  constexpr int NU = T::NU;
  constexpr int NB = T::NBODY;
  double xpos[NB][3], xquat[NB][4];
  double cdof[NV][6];
  Inertia In[NB];
  double cvel[NB][6], cacc[NB][6], cfrc[NB][6];
#pragma unroll
  for (int k = 0; k < 3; ++k) xpos[0][k] = 0.0;
  xquat[0][0] = 1.0; xquat[0][1] = 0.0; xquat[0][2] = 0.0; xquat[0][3] = 0.0;
#pragma unroll
  for (int k = 0; k < 6; ++k) cvel[0][k] = 0.0;
  cacc[0][0] = 0.0; cacc[0][1] = 0.0; cacc[0][2] = 0.0;
#pragma unroll
  for (int k = 0; k < 3; ++k) cacc[0][3 + k] = -P[T::GRAV + k];

  // ---- forward kinematics, body inertias and the RNE forward sweep
#pragma unroll
  for (int b = 1; b < NB; ++b) {
    const double* pb = P + (b - 1) * BODY_STRIDE;
    const int p = T::parent(b);
    const int j = T::body_dof(b);
    double xq[4], xp[3], tmp[3];
    quat_mul(xquat[p], pb + F_BQUAT, xq);
    quat_rotate(xquat[p], pb + F_BPOS, tmp);
#pragma unroll
    for (int k = 0; k < 3; ++k) xp[k] = xpos[p][k] + tmp[k];
    if (j < 0) {
      // welded body: the parent's frame moved by the body offset
    } else if (T::slide(j)) {
      const double dq = q[j] - pb[F_QPOS0];
      double aw[3];
      quat_rotate(xq, pb + F_JAXIS, aw);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        xp[k] = xp[k] + aw[k] * dq;
        cdof[j][k] = 0.0;
        cdof[j][3 + k] = aw[k];
      }
    } else {
      const double dq = q[j] - pb[F_QPOS0];
      double anchor[3], rv[3], ql[4], xq2[4], a[3], ax[3];
      quat_rotate(xq, pb + F_JPOS, anchor);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        anchor[k] += xp[k];
        rv[k] = pb[F_JAXIS + k] * dq;
      }
      quat_exp(rv, ql);
      quat_mul(xq, ql, xq2);
#pragma unroll
      for (int k = 0; k < 4; ++k) xq[k] = xq2[k];
      quat_rotate(xq, pb + F_JPOS, tmp);
#pragma unroll
      for (int k = 0; k < 3; ++k) xp[k] = anchor[k] - tmp[k];
      quat_rotate(xq, pb + F_JAXIS, a);
      cross3(anchor, a, ax);
#pragma unroll
      for (int k = 0; k < 3; ++k) { cdof[j][k] = a[k]; cdof[j][3 + k] = ax[k]; }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) xpos[b][k] = xp[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) xquat[b][k] = xq[k];

    // inertia of body b about the world origin
    double R[9], Ri[9], X[9], c[3];
    quat_to_mat(xq, R);
    quat_to_mat(pb + F_IQUAT, Ri);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      c[r] = xp[r] + (R[3 * r] * pb[F_IPOS] + R[3 * r + 1] * pb[F_IPOS + 1] +
                      R[3 * r + 2] * pb[F_IPOS + 2]);
#pragma unroll
      for (int s = 0; s < 3; ++s)
        X[3 * r + s] = R[3 * r] * Ri[s] + R[3 * r + 1] * Ri[3 + s] +
                       R[3 * r + 2] * Ri[6 + s];
    }
    const double m = pb[F_MASS];
    const double* d = pb + F_INERTIA;
    const int kk[6][2] = {{0, 0}, {1, 1}, {2, 2}, {0, 1}, {0, 2}, {1, 2}};
    const double cc = c[0] * c[0] + c[1] * c[1] + c[2] * c[2];
    Inertia& I = In[b];
    I.m = m;
#pragma unroll
    for (int r = 0; r < 3; ++r) I.h[r] = m * c[r];
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      const int r = kk[e][0], s = kk[e][1];
      const double ic = X[3 * r] * d[0] * X[3 * s] +
                        X[3 * r + 1] * d[1] * X[3 * s + 1] +
                        X[3 * r + 2] * d[2] * X[3 * s + 2];
      I.J[e] = ic + m * ((r == s ? cc : 0.0) - c[r] * c[s]);
    }

    // RNE forward: body velocity, acceleration and force
    double Iv[6], Ia[6], cf[6];
    if (j < 0) {
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        cvel[b][k] = cvel[p][k];
        cacc[b][k] = cacc[p][k];
      }
    } else {
      double cm[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) cvel[b][k] = cvel[p][k] + cdof[j][k] * v[j];
      cross_motion(cvel[p], cdof[j], cm);
#pragma unroll
      for (int k = 0; k < 6; ++k) cacc[b][k] = cacc[p][k] + cm[k] * v[j];
    }
    inertia_mul(I, cvel[b], Iv);
    inertia_mul(I, cacc[b], Ia);
    cross_force(cvel[b], Iv, cf);
#pragma unroll
    for (int k = 0; k < 6; ++k) cfrc[b][k] = Ia[k] + cf[k];
  }

  // ---- RNE backward (bias) and composite inertias (CRBA)
  double bias[NV];
#pragma unroll
  for (int b = NB - 1; b >= 1; --b) {
    const int p = T::parent(b);
    const int j = T::body_dof(b);
    if (j >= 0) bias[j] = dot6(cdof[j], cfrc[b]);
    if (p > 0) {
#pragma unroll
      for (int k = 0; k < 6; ++k) cfrc[p][k] += cfrc[b][k];
      inertia_add(In[p], In[b]);
    }
  }
  double M[NV][NV];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int k = 0; k < NV; ++k) M[i][k] = 0.0;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int bi = T::dof_body(i);
    double F[6];
    inertia_mul(In[bi], cdof[i], F);
    M[i][i] = dot6(cdof[i], F) + P[(bi - 1) * BODY_STRIDE + F_ARM];
#pragma unroll
    for (int a = T::parent(bi); a > 0; a = T::parent(a)) {
      const int ja = T::body_dof(a);
      if (ja >= 0) {
        const double mij = dot6(cdof[ja], F);
        M[i][ja] = mij;
        M[ja][i] = mij;
      }
    }
  }

  // ---- forces, constraint force, implicit damping, Euler
  const double h = P[T::DT];
  double f[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const double* pb = P + (T::dof_body(i) - 1) * BODY_STRIDE;
    const double passive =
        -pb[F_DAMP] * v[i] + (-pb[F_STIFF] * (q[i] - pb[F_QSPRING]));
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
    f[i] = passive + act - bias[i];
  }
  if constexpr (T::R > 0) {
    Rows<T::R, T::ROW_W> rows;
    double qc[NV];
    limit_rows<T>(P, q, v, rows);
    constraint_solve<T>(M, f, rows, qc);
#pragma unroll
    for (int i = 0; i < NV; ++i) f[i] = f[i] + qc[i];
  }
#pragma unroll
  for (int i = 0; i < NV; ++i)
    M[i][i] += h * P[(T::dof_body(i) - 1) * BODY_STRIDE + F_DAMP];
  chol_factor<NV>(M);
  chol_solve<NV>(M, f);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    vn[i] = v[i] + h * f[i];
    qn[i] = q[i] + h * vn[i];
  }
}

}  // namespace trajopt
