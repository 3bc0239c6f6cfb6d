// K1: one MuJoCo step for one lane, in double-precision registers.
//
// Replaces the JAX lane step, trajoptkp_tpu/dynamics/lanes.py:1595
// (build_smooth_step; _fk_registers:288, _smooth_force_and_M:509,
// _chol_solve_stacked:412, integrate_q_regs:1549).  It is a __device__
// function shared by the rollout (K3), line-search (K4) and FD-Jacobian (K5)
// kernels, not a kernel of its own.  Its plain twin is
// trajoptkp_tpu_torch/dynamics/step.py:step_state.
//
// Scope: trees whose bodies carry hinge and slide joints (several per body
// compose in declaration order, as the walker's torso: rootz, rootx, rooty),
// one free joint alone, or none (a welded body passes its inertia and force
// to its parent), joint limits and contacts through the constraint solve of
// constraint.cuh (K2a) with the rows of contact.cuh (K2b), no ball joints.
// The topology is a template argument (Topo); the numeric model is one
// double buffer whose layout kernels/ops.py:pack_model writes: BODY_STRIDE
// per body 1..NBODY-1, DOF_STRIDE per dof (its damping and armature, then
// its joint's fields, zero for a free joint's dofs), ACT_STRIDE per
// actuator, LIM_STRIDE per limited joint, PAIR_STRIDE per contact pair,
// gravity, timestep.
//
// Per body the step runs FK (quaternion frames, cdof), then RNE for the
// bias force and CRBA over composite inertias for the mass matrix, in the
// compact form of a spatial inertia (m, h = m c, J = I_c + m (c.c I - c c^T)).
// A free joint's body takes its pose from qpos (position, normalised
// quaternion); its translations move along world axes, its rotations about
// the body's own axes, so their cdof turn with the whole body twist.  The
// plain twin (dynamics/fk.py, smooth.py, integrate.py, step.py) runs the
// same recursions.
//
// Rounding: built with -fmad=false, and the plain twin runs the same
// operations in the same order, so on the card the two agree bit for bit
// (FD divides rounding differences by 2 eps; bitwise-equal steps keep the
// kernel and plain solves on the same path through a chaotic horizon).
//
// Bound: one step is ~1.3k (acrobot) to ~6k (panda) dependent double
// operations per lane before its constraint solve (~10k more with panda's
// limit rows, ~86k with push_ncl's 42 rows, ~131k with the walker's 128;
// chip_smoke.py counts them), so a kernel
// built on it is bound by latency per thread, not by bytes; this first
// version runs one lane per thread and spills the per-body arrays and the
// rows to local memory from pentabot width up.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <utility>

#include "constraint.cuh"
#include "contact.cuh"
#include "dual.cuh"
#include "geometry.cuh"
#include "linalg.cuh"
#include "residuals.cuh"

namespace trajopt {

constexpr int BODY_STRIDE = 18;
enum BodyField {
  F_BPOS = 0, F_BQUAT = 3, F_IPOS = 7, F_IQUAT = 10, F_MASS = 14,
  F_INERTIA = 15
};
// per dof: damping, armature, then its joint's fields (zero for a free
// joint's dofs)
constexpr int DOF_STRIDE = 11;
enum DofField {
  D_DAMP = 0, D_ARM = 1, D_JPOS = 2, D_JAXIS = 5, D_QPOS0 = 8, D_STIFF = 9,
  D_QSPRING = 10
};
constexpr int ACT_STRIDE = 5;
enum ActField { A_DOF = 0, A_GEAR = 1, A_LIMITED = 2, A_LO = 3, A_HI = 4 };

__host__ __device__ constexpr int popcount(unsigned long long x) {
  int n = 0;
  for (; x; x >>= 1) n += static_cast<int>(x & 1ull);
  return n;
}

// NV dofs, NU actuators, NBODY bodies (world included).  Bit codes, 4 bits
// per entry unless said otherwise: the joint of dof j is a slide when bit j
// of SLIDE is set; body b's joint is free when bit b of FREE is set; dof j
// is limited when bit j of LIMITED is set; the parent of body b is
// (PARENTS >> 4b) & 15; its first dof is ((BODYDOF >> 4b) & 15) - 1, -1 for
// a welded body, and it has (BODYNDOF >> 4b) & 15 dofs (hinges and slides in
// declaration order, or 6 for a free joint); its first joint's first qpos is
// (QADR >> 4b) & 15.  The state vector holds NDOF dofs, state dof k being
// qvel index (SVDOF >> 4k) & 15.  RES, RESA, RESB: the residual (RES_JOINT,
// RES_PUSH, RES_SELECT of residuals.cuh).  PAIRS: one 16-bit code per
// contact pair, geom types (4 bits each) and bodies (4 bits each) of geom1
// and geom2; every lookup of a pair, a slot or a row is evaluated at compile
// time (pair_rows<T, PI>, static_for over the rows), so any number of pairs
// costs no runtime table.
template <int NV_, int NU_, int NBODY_, unsigned SLIDE_, unsigned FREE_,
          unsigned long long PARENTS_, unsigned long long BODYDOF_,
          unsigned long long BODYNDOF_, unsigned long long QADR_,
          unsigned LIMITED_, int NDOF_, unsigned long long SVDOF_, int RES_,
          int RESA_, unsigned long long RESB_, unsigned... PAIRS_>
struct Topo {
  static constexpr int NV = NV_;
  static constexpr int NU = NU_;
  static constexpr int NBODY = NBODY_;
  static constexpr int NQ = NV_ + popcount(FREE_);
  static constexpr int NDOF = NDOF_;
  static constexpr int NX = 2 * NDOF_;
  static constexpr int RES = RES_;
  static constexpr int NJ = RESA_;     // joint-space residual sizes
  static constexpr int NUR = static_cast<int>(RESB_);
  static constexpr int GOAL = RESA_;   // push residual bodies
  static constexpr int SITE_BODY = static_cast<int>(RESB_);
  static constexpr unsigned long long SELECT = RESB_;  // select residual
  static constexpr int NRES = RES_ == RES_JOINT    ? 2 * RESA_ + NUR
                              : RES_ == RES_SELECT ? RESA_
                                                   : 4;
  static constexpr int NTGT = RES_ == RES_PUSH ? 2 : NRES;
  __host__ __device__ static constexpr int parent(int b) {
    return static_cast<int>((PARENTS_ >> (4 * b)) & 0xFull);
  }
  __host__ __device__ static constexpr bool slide(int j) {
    return ((SLIDE_ >> j) & 1u) != 0u;
  }
  __host__ __device__ static constexpr bool free(int b) {
    return ((FREE_ >> b) & 1u) != 0u;
  }
  __host__ __device__ static constexpr int body_dof(int b) {
    return static_cast<int>((BODYDOF_ >> (4 * b)) & 0xFull) - 1;
  }
  __host__ __device__ static constexpr int body_ndof(int b) {
    return static_cast<int>((BODYNDOF_ >> (4 * b)) & 0xFull);
  }
  __host__ __device__ static constexpr int qadr(int b) {
    return static_cast<int>((QADR_ >> (4 * b)) & 0xFull);
  }
  // The inverse maps are folded into bit codes once, so that a lookup in an
  // unrolled loop is a shift of a constant like parent(): as loops over the
  // bodies they did not always fold, and an index the compiler cannot see
  // sends the per-body arrays through local memory (pentabot's FD kernel ran
  // 2.2x slower that way).
  __host__ __device__ static constexpr unsigned long long make_dofbody() {
    unsigned long long code = 0;
    for (int b = 1; b < NBODY_; ++b)
      for (int k = 0; k < body_ndof(b); ++k)
        code |= static_cast<unsigned long long>(b) << (4 * (body_dof(b) + k));
    return code;
  }
  static constexpr unsigned long long DOFBODY = make_dofbody();
  // the body of dof j
  __host__ __device__ static constexpr int dof_body(int j) {
    return static_cast<int>((DOFBODY >> (4 * j)) & 0xFull);
  }
  __host__ __device__ static constexpr unsigned long long make_dofq() {
    unsigned long long code = 0;
    for (int j = 0; j < NV_; ++j) {
      const int b = dof_body(j);
      code |= static_cast<unsigned long long>(qadr(b) + j - body_dof(b))
              << (4 * j);
    }
    return code;
  }
  static constexpr unsigned long long DOFQ = make_dofq();
  // the qpos of a hinge, slide or free-translation dof j
  __host__ __device__ static constexpr int dof_q(int j) {
    return static_cast<int>((DOFQ >> (4 * j)) & 0xFull);
  }
  // state dof k: its qvel index and its qpos (hinge, slide or translation)
  __host__ __device__ static constexpr int sv(int k) {
    return static_cast<int>((SVDOF_ >> (4 * k)) & 0xFull);
  }
  __host__ __device__ static constexpr int sv_q(int k) { return dof_q(sv(k)); }
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

  // ---- contact pairs (contact.cuh); compile time only
  static constexpr int NPAIR = static_cast<int>(sizeof...(PAIRS_));
  __host__ __device__ static constexpr unsigned pair_code(int p) {
    unsigned out = 0;
    int i = 0;
    ((out = (i++ == p ? PAIRS_ : out)), ...);
    return out;
  }
  __host__ __device__ static constexpr int pair_field(int p, int f) {
    return static_cast<int>((pair_code(p) >> (4 * f)) & 0xFu);
  }
  __host__ __device__ static constexpr int pair_t1(int p) {
    return pair_field(p, 0);
  }
  __host__ __device__ static constexpr int pair_t2(int p) {
    return pair_field(p, 1);
  }
  __host__ __device__ static constexpr int pair_b1(int p) {
    return pair_field(p, 2);
  }
  __host__ __device__ static constexpr int pair_b2(int p) {
    return pair_field(p, 3);
  }
  // slots per pair (dynamics/collision.py _COLLIDERS)
  __host__ __device__ static constexpr int pair_ncon(int p) {
    return pair_t1(p) == GEOM_PLANE
               ? (pair_t2(p) == GEOM_CYLINDER ? 3 : 2)
               : 1;
  }
  // dof j on body b's root path
  __host__ __device__ static constexpr bool on_path(int b, int j) {
    for (; b > 0; b = parent(b))
      if (body_ndof(b) > 0 && j >= body_dof(b) &&
          j < body_dof(b) + body_ndof(b))
        return true;
    return false;
  }
  // support of pair p: the dofs on exactly one of the two root paths, in
  // dof order, 4 bits each; a sign bit per support entry, set on geom2's
  // path (+1), clear on geom1's (-1)
  __host__ __device__ static constexpr unsigned long long supp_code(int p) {
    unsigned long long code = 0;
    int w = 0;
    for (int j = 0; j < NV_; ++j)
      if (on_path(pair_b1(p), j) != on_path(pair_b2(p), j))
        code |= static_cast<unsigned long long>(j) << (4 * w++);
    return code;
  }
  __host__ __device__ static constexpr unsigned sgn_code(int p) {
    unsigned code = 0;
    int w = 0;
    for (int j = 0; j < NV_; ++j)
      if (on_path(pair_b1(p), j) != on_path(pair_b2(p), j)) {
        if (on_path(pair_b2(p), j)) code |= 1u << w;
        ++w;
      }
    return code;
  }
  __host__ __device__ static constexpr int nsup(int p) {
    int w = 0;
    for (int j = 0; j < NV_; ++j)
      w += on_path(pair_b1(p), j) != on_path(pair_b2(p), j);
    return w;
  }
  __host__ __device__ static constexpr int count_slots() {
    int n = 0;
    for (int p = 0; p < NPAIR; ++p) n += pair_ncon(p);
    return n;
  }
  static constexpr int NSLOT = count_slots();
  // pair of contact slot s
  __host__ __device__ static constexpr int slot_pair(int s) {
    for (int p = 0; p < NPAIR; ++p) {
      if (s < pair_ncon(p)) return p;
      s -= pair_ncon(p);
    }
    return -1;
  }
  __host__ __device__ static constexpr int first_slot(int p) {
    int s = 0;
    for (int q = 0; q < p; ++q) s += pair_ncon(q);
    return s;
  }
  __host__ __device__ static constexpr int max_sup() {
    int w = 1;
    for (int p = 0; p < NPAIR; ++p) w = nsup(p) > w ? nsup(p) : w;
    return w;
  }

  // constraint rows (constraint.cuh): two one-entry rows per limited joint,
  // then four rows per contact slot over its pair's support; compile time
  // only: row r's dofs (4 bits each) and its width
  static constexpr int R = 2 * NLIM + 4 * NSLOT;
  static constexpr int ROW_W = max_sup();
  __host__ __device__ static constexpr unsigned long long row_code(int r) {
    return r < 2 * NLIM
               ? static_cast<unsigned long long>(lim_dof(r < NLIM ? r
                                                                  : r - NLIM))
               : supp_code(slot_pair((r - 2 * NLIM) / 4));
  }
  __host__ __device__ static constexpr int row_w(int r) {
    return r < 2 * NLIM ? 1 : nsup(slot_pair((r - 2 * NLIM) / 4));
  }

  // ---- the model buffer
  static constexpr int DOFB = (NBODY_ - 1) * BODY_STRIDE;  // per-dof block
  static constexpr int ACT = DOFB + NV_ * DOF_STRIDE;      // actuator block
  static constexpr int LIM = ACT + NU_ * ACT_STRIDE;       // limit block
  static constexpr int PAIRB = LIM + NLIM * LIM_STRIDE;    // contact pairs
  static constexpr int GRAV = PAIRB + NPAIR * PAIR_STRIDE;
  static constexpr int DT = GRAV + 3;
};

// Spatial inertia about the world origin in compact form.
template <class S = double>
struct Inertia {
  double m;
  S h[3];   // m * com
  S J[6];   // xx yy zz xy xz yz of I_com + m (c.c I - c c^T)
};

// o = I s, s = [angular; linear]
template <class S>
__device__ __forceinline__ void inertia_mul(const Inertia<S>& I, const S* s,
                                            S* o) {
  const S* w = s;
  const S* v = s + 3;
  S hv[3], hw[3];
  cross3(I.h, v, hv);
  cross3(I.h, w, hw);
  o[0] = I.J[0] * w[0] + I.J[3] * w[1] + I.J[4] * w[2] + hv[0];
  o[1] = I.J[3] * w[0] + I.J[1] * w[1] + I.J[5] * w[2] + hv[1];
  o[2] = I.J[4] * w[0] + I.J[5] * w[1] + I.J[2] * w[2] + hv[2];
#pragma unroll
  for (int k = 0; k < 3; ++k) o[3 + k] = I.m * v[k] - hw[k];
}

template <class S>
__device__ __forceinline__ void inertia_add(Inertia<S>& a,
                                            const Inertia<S>& b) {
  a.m += b.m;
#pragma unroll
  for (int k = 0; k < 3; ++k) a.h[k] += b.h[k];
#pragma unroll
  for (int k = 0; k < 6; ++k) a.J[k] += b.J[k];
}

// v x m (spatial motion cross product)
template <class S>
__device__ __forceinline__ void cross_motion(const S* v, const S* m, S* o) {
  S a[3], b[3], c[3];
  cross3(v, m, a);
  cross3(v, m + 3, b);
  cross3(v + 3, m, c);
#pragma unroll
  for (int k = 0; k < 3; ++k) { o[k] = a[k]; o[3 + k] = b[k] + c[k]; }
}

// v x* f (spatial force cross product)
template <class S>
__device__ __forceinline__ void cross_force(const S* v, const S* f, S* o) {
  S a[3], b[3], c[3];
  cross3(v, f, a);
  cross3(v + 3, f + 3, b);
  cross3(v, f + 3, c);
#pragma unroll
  for (int k = 0; k < 3; ++k) { o[k] = a[k] + b[k]; o[3 + k] = c[k]; }
}

template <class S>
__device__ __forceinline__ S dot6(const S* a, const S* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3] +
         a[4] * b[4] + a[5] * b[5];
}

// qn = q (+) v dt: hinge, slide and free translation q + dt v; a free
// rotation q * exp(omega dt), normalised (dynamics/integrate.py).
template <class T, class S>
__device__ __forceinline__ void integrate_pos(const S* q, const S* v,
                                              double dt, S* qn) {
#pragma unroll
  for (int b = 1; b < T::NBODY; ++b) {
    const int j = T::body_dof(b);
    const int a = T::qadr(b);
    if (j < 0) continue;
    if (T::free(b)) {
#pragma unroll
      for (int k = 0; k < 3; ++k) qn[a + k] = q[a + k] + dt * v[j + k];
      S w[3], ql[4], qq[4];
#pragma unroll
      for (int k = 0; k < 3; ++k) w[k] = v[j + 3 + k] * dt;
      quat_exp(w, ql);
      quat_mul(q + a + 3, ql, qq);
      quat_normalize(qq, qn + a + 3);
    } else {
#pragma unroll
      for (int k = 0; k < 6; ++k)
        if (k < T::body_ndof(b)) qn[a + k] = q[a + k] + dt * v[j + k];
    }
  }
}

// Where fk_bias writes the FK products and the bias force of one lane,
// batch last: xpos (NBODY, 3, B), xquat (NBODY, 4, B), cdof (NV, 6, B),
// bias (NV, B).
struct FkBiasOut {
  double* xpos;
  double* xquat;
  double* cdof;
  double* bias;
  int B;
  int b;
};

// Forward kinematics of body b, its parent's frame done: the world
// position xpos[b] and orientation xquat[b], and the cdof rows of its dofs.
// A free joint's body takes its pose from qpos (position, normalised
// quaternion); hinges and slides compose in declaration order, each from
// the frame the joints before it left (none: a welded body).
template <class T, class S>
__device__ __forceinline__ void fk_body(const double* __restrict__ P,
                                        const S* q, const int b,
                                        S (&xpos)[T::NBODY][3],
                                        S (&xquat)[T::NBODY][4],
                                        S (&cdof)[T::NV][6]) {
  const double* pb = P + (b - 1) * BODY_STRIDE;
  const int p = T::parent(b);
  const int j0 = T::body_dof(b);
  const int qa = T::qadr(b);
  S xq[4], xp[3], tmp[3];
  if (T::free(b)) {
    // the body's world pose is its qpos: position, normalised quaternion
#pragma unroll
    for (int k = 0; k < 3; ++k) xp[k] = q[qa + k];
    quat_normalize(q + qa + 3, xq);
    S Rf[9];
    quat_to_mat(xq, Rf);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      S a[3] = {Rf[k], Rf[3 + k], Rf[6 + k]}, ax[3];
      cross3(xp, a, ax);
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        cdof[j0 + k][m] = 0.0;
        cdof[j0 + k][3 + m] = m == k ? 1.0 : 0.0;
        cdof[j0 + 3 + k][m] = a[m];
        cdof[j0 + 3 + k][3 + m] = ax[m];
      }
    }
  } else {
    quat_mul(xquat[p], pb + F_BQUAT, xq);
    quat_rotate(xquat[p], pb + F_BPOS, tmp);
#pragma unroll
    for (int k = 0; k < 3; ++k) xp[k] = xpos[p][k] + tmp[k];
    // the body's hinges and slides in declaration order, each from the
    // frame the joints before it left (none: a welded body)
#pragma unroll
    for (int n = 0; n < 6; ++n) {
      if (n >= T::body_ndof(b)) continue;
      const int j = j0 + n;
      const double* pd = P + T::DOFB + j * DOF_STRIDE;
      const S dq = q[T::dof_q(j)] - pd[D_QPOS0];
      if (T::slide(j)) {
        S aw[3];
        quat_rotate(xq, pd + D_JAXIS, aw);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          xp[k] = xp[k] + aw[k] * dq;
          cdof[j][k] = 0.0;
          cdof[j][3 + k] = aw[k];
        }
      } else {
        S anchor[3], rv[3], ql[4], xq2[4], a[3], ax[3];
        quat_rotate(xq, pd + D_JPOS, anchor);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          anchor[k] += xp[k];
          rv[k] = pd[D_JAXIS + k] * dq;
        }
        quat_exp(rv, ql);
        quat_mul(xq, ql, xq2);
#pragma unroll
        for (int k = 0; k < 4; ++k) xq[k] = xq2[k];
        quat_rotate(xq, pd + D_JPOS, tmp);
#pragma unroll
        for (int k = 0; k < 3; ++k) xp[k] = anchor[k] - tmp[k];
        quat_rotate(xq, pd + D_JAXIS, a);
        cross3(anchor, a, ax);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          cdof[j][k] = a[k];
          cdof[j][3 + k] = ax[k];
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) xpos[b][k] = xp[k];
#pragma unroll
  for (int k = 0; k < 4; ++k) xquat[b][k] = xq[k];
}

// The FK products of one lane (the cost expansion's FK residual Jacobian,
// cost_expansion.cu, reads them).
template <class T>
struct Frames {
  double xpos[T::NBODY][3];
  double xquat[T::NBODY][4];
  double cdof[T::NV][6];
};

// (q, v, u) -> (qn, vn): FK, RNE bias, CRBA mass matrix, passive and
// actuator forces, the constraint force of the limit rows (K2a) and contact
// rows (K2b), (M + h D) qacc = f, semi-implicit Euler.  With WANT_RES the
// FK residual of the state (q, v) (RES_PUSH, with its constants `resc`
// from the task buffer) is written to `res`, from the same FK products the
// step uses.  With FK_BIAS the step stops after the
// RNE and writes its FK products and bias force to `out` (fk_bias below).
template <class T, bool WANT_RES = false, bool FK_BIAS = false,
          class S = double>
__device__ void smooth_step(const double* __restrict__ P, const S* q,
                            const S* v, const S* u, S* qn, S* vn,
                            const double* tg = nullptr,
                            const double* resc = nullptr,
                            double* res = nullptr,
                            const FkBiasOut* out = nullptr) {
  constexpr int NV = T::NV;
  constexpr int NU = T::NU;
  constexpr int NB = T::NBODY;
  S xpos[NB][3], xquat[NB][4];
  S cdof[NV][6];
  Inertia<S> In[NB];
  S cvel[NB][6], cacc[NB][6], cfrc[NB][6];
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
    fk_body<T>(P, q, b, xpos, xquat, cdof);
    const double* pb = P + (b - 1) * BODY_STRIDE;
    const int p = T::parent(b);
    const int j0 = T::body_dof(b);
    const S* xq = xquat[b];
    const S* xp = xpos[b];

    // inertia of body b about the world origin
    S R[9], Ri[9], X[9], c[3];
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
    const S cc = c[0] * c[0] + c[1] * c[1] + c[2] * c[2];
    Inertia<S>& I = In[b];
    I.m = m;
#pragma unroll
    for (int r = 0; r < 3; ++r) I.h[r] = m * c[r];
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      const int r = kk[e][0], s = kk[e][1];
      const S ic = X[3 * r] * d[0] * X[3 * s] +
                        X[3 * r + 1] * d[1] * X[3 * s + 1] +
                        X[3 * r + 2] * d[2] * X[3 * s + 2];
      I.J[e] = ic + m * ((r == s ? cc : 0.0) - c[r] * c[s]);
    }

    // RNE forward: body velocity, acceleration and force
    S Iv[6], Ia[6], cf[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      cvel[b][k] = cvel[p][k];
      cacc[b][k] = cacc[p][k];
    }
    if (T::free(b)) {
      // the rotations' cdof turn with the whole body twist
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int k = 0; k < 6; ++k)
          cvel[b][k] = cvel[b][k] + cdof[j0 + i][k] * v[j0 + i];
#pragma unroll
      for (int i = 3; i < 6; ++i) {
        S cm[6];
        cross_motion(cvel[b], cdof[j0 + i], cm);
#pragma unroll
        for (int k = 0; k < 6; ++k)
          cacc[b][k] = cacc[b][k] + cm[k] * v[j0 + i];
      }
    } else {
      // hinge or slide dof j's cdof turns with the twist of the dofs before
      // it: the parent's and the body's own earlier ones
#pragma unroll
      for (int n = 0; n < 6; ++n) {
        if (n >= T::body_ndof(b)) continue;
        const int j = j0 + n;
        S cm[6];
        cross_motion(cvel[b], cdof[j], cm);
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          cacc[b][k] = cacc[b][k] + cm[k] * v[j];
          cvel[b][k] = cvel[b][k] + cdof[j][k] * v[j];
        }
      }
    }
    inertia_mul(I, cvel[b], Iv);
    inertia_mul(I, cacc[b], Ia);
    cross_force(cvel[b], Iv, cf);
#pragma unroll
    for (int k = 0; k < 6; ++k) cfrc[b][k] = Ia[k] + cf[k];
  }
  if constexpr (WANT_RES && T::RES == RES_PUSH && !is_dual<S>::value)
    push_residual<T>(resc, xpos, xquat, v, tg, res);

  // ---- RNE backward (bias) and composite inertias (CRBA)
  S bias[NV];
#pragma unroll
  for (int b = NB - 1; b >= 1; --b) {
    const int p = T::parent(b);
    const int j = T::body_dof(b);
#pragma unroll
    for (int k = 0; k < 6; ++k)
      if (k < T::body_ndof(b)) bias[j + k] = dot6(cdof[j + k], cfrc[b]);
    if (p > 0) {
#pragma unroll
      for (int k = 0; k < 6; ++k) cfrc[p][k] += cfrc[b][k];
      inertia_add(In[p], In[b]);
    }
  }
  if constexpr (FK_BIAS && !is_dual<S>::value) {
    const int B = out->B, l = out->b;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
#pragma unroll
      for (int k = 0; k < 3; ++k) out->xpos[(b * 3 + k) * B + l] = xpos[b][k];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        out->xquat[(b * 4 + k) * B + l] = xquat[b][k];
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
#pragma unroll
      for (int k = 0; k < 6; ++k) out->cdof[(i * 6 + k) * B + l] = cdof[i][k];
      out->bias[i * B + l] = bias[i];
    }
  } else {
    S M[NV][NV];
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int k = 0; k < NV; ++k) M[i][k] = 0.0;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int bi = T::dof_body(i);
      S F[6];
      inertia_mul(In[bi], cdof[i], F);
      M[i][i] = dot6(cdof[i], F) + P[T::DOFB + i * DOF_STRIDE + D_ARM];
      // the body's own earlier dofs (a free joint's), then its ancestors';
      // loops of constant trip count with guards, which the unroller folds
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const int ik = T::body_dof(bi) + k;
        if (ik < i) {
          const S mik = dot6(cdof[ik], F);
          M[i][ik] = mik;
          M[ik][i] = mik;
        }
      }
#pragma unroll
      for (int a = T::parent(bi); a > 0; a = T::parent(a)) {
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          if (k < T::body_ndof(a)) {
            const int ja = T::body_dof(a) + k;
            const S mij = dot6(cdof[ja], F);
            M[i][ja] = mij;
            M[ja][i] = mij;
          }
        }
      }
    }

    // ---- forces, constraint force, implicit damping, Euler
    const double h = P[T::DT];
    S f[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int bi = T::dof_body(i);
      const double* pd = P + T::DOFB + i * DOF_STRIDE;
      const double damp = pd[D_DAMP];
      S passive = -damp * v[i];
      if (!T::free(bi))
        passive = passive + (-pd[D_STIFF] * (q[T::dof_q(i)] - pd[D_QSPRING]));
      S act = 0.0;
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        const double* pa = P + T::ACT + a * ACT_STRIDE;
        if (static_cast<int>(pa[A_DOF]) == i) {
          S c = u[a];
          if (pa[A_LIMITED] != 0.0) c = clip(c, pa[A_LO], pa[A_HI]);
          act += c * pa[A_GEAR];
        }
      }
      f[i] = passive + act - bias[i];
    }
    if constexpr (T::R > 0) {
      Rows<T::R, T::ROW_W, S> rows;
      S qc[NV];
      if constexpr (T::NLIM > 0) limit_rows<T>(P, q, v, rows);
      if constexpr (T::NPAIR > 0)
        contact_rows<T>(P, xpos, xquat, cdof, v, rows);
      constraint_solve<T>(M, f, rows, qc);
#pragma unroll
      for (int i = 0; i < NV; ++i) f[i] = f[i] + qc[i];
    }
#pragma unroll
    for (int i = 0; i < NV; ++i)
      M[i][i] += h * P[T::DOFB + i * DOF_STRIDE + D_DAMP];
    chol_factor<NV>(M);
    chol_solve<NV>(M, f);
#pragma unroll
    for (int i = 0; i < NV; ++i) vn[i] = v[i] + h * f[i];
    integrate_pos<T>(q, vn, h, qn);
  }
}

// The FK products and the bias force (mj_rne at qacc = 0) of one lane: the
// first part of smooth_step, for the pushing tasks' end-effector servo
// (tasks/pushing.py), whose control law needs the end-effector pose, cdof
// and qfrc_bias at every servo step.
template <class T>
__device__ __forceinline__ void fk_bias(const double* __restrict__ P,
                                        const double* q, const double* v,
                                        const FkBiasOut& out) {
  smooth_step<T, false, true, double>(P, q, v, nullptr, nullptr, nullptr,
                                      nullptr, nullptr, nullptr, &out);
}

// The FK products of one lane, as smooth_step computes them.
template <class T>
__device__ __forceinline__ void fk_frames(const double* __restrict__ P,
                                          const double* q, Frames<T>& fr) {
#pragma unroll
  for (int k = 0; k < 3; ++k) fr.xpos[0][k] = 0.0;
  fr.xquat[0][0] = 1.0; fr.xquat[0][1] = 0.0; fr.xquat[0][2] = 0.0;
  fr.xquat[0][3] = 0.0;
#pragma unroll
  for (int b = 1; b < T::NBODY; ++b)
    fk_body<T>(P, q, b, fr.xpos, fr.xquat, fr.cdof);
}

// the residual at (q, v, u) and one step, from the step's FK for an FK
// residual; `resc` holds the residual's constants (task buffer)
template <class T>
__device__ __forceinline__ void residual_and_step(
    const double* __restrict__ P, const double* q, const double* v,
    const double* u, const double* tg, const double* resc, double* r,
    double* qn, double* vn) {
  if constexpr (T::RES == RES_JOINT) {
    joint_space_residual<T::NJ, T::NUR>(q, v, u, tg, r);
    smooth_step<T>(P, q, v, u, qn, vn);
  } else if constexpr (T::RES == RES_SELECT) {
    select_residual<T::NQ, T::NV, T::NRES, T::SELECT>(q, v, u, tg, r);
    smooth_step<T>(P, q, v, u, qn, vn);
  } else {
    smooth_step<T, true>(P, q, v, u, qn, vn, tg, resc, r);
  }
}

}  // namespace trajopt
