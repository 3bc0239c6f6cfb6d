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
// limit rows, ~86k with push_ncl's 42 rows, ~131k with the walker's 128,
// ~466k with push_lcl's 114 over 31 dofs; chip_smoke.py:step_ops counts
// them), so a kernel built on it is bound by the latency of its dependent
// chains, not by bytes.  Here the step runs one lane per thread, the
// per-body arrays and the rows in the thread's local memory (a 39 KB frame
// at push_lcl): K3, K5, K5ad, K8 and fk_bias run it so.  K4 runs the same
// operations in the same order spread over a warp per lane with the
// lane's arrays in shared memory (warp_step.cuh: 25.1 KB at push_lcl);
// fk_rne is the part the two share.
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

// A compile-time table as values: lookup by a constant index (an unrolled
// loop's) folds to a constant in any compiler, a chain of selects without
// memory, and lookup by a runtime index costs one compare per entry.
// Device code may not name an instance's host `static constexpr` array, but
// its elements may be template arguments.
template <int... V>
struct Pack {
  __host__ __device__ static constexpr int at(int i) {
    int out = 0, k = 0;
    ((out = (k++ == i ? V : out)), ...);
    return out;
  }
};

// A table computed at compile time from the instance's arrays.
template <int N>
struct Table {
  int v[N > 0 ? N : 1];
  __host__ __device__ constexpr int operator[](int i) const { return v[i]; }
};

// Accessor name(i) of the instance's array Tab::FIELD of N entries (COL
// empty), or of column COL of a 2-D one.
#define TRAJOPT_TOPO_TABLE(name, FIELD, N, COL)                               \
  template <int... I>                                                         \
  static Pack<Tab::FIELD[I] COL...> name##_pack(                              \
      std::integer_sequence<int, I...>);                                      \
  using name##_values =                                                       \
      decltype(name##_pack(std::make_integer_sequence<int, N>{}));            \
  __host__ __device__ static constexpr int name(int i) {                      \
    return name##_values::at(i);                                              \
  }

// A table derived from the instance's arrays, computed once (the static
// member TABLE), and its accessor name(i).
#define TRAJOPT_TOPO_DERIVED(name, TABLE, N, make)                            \
  static constexpr Table<N> TABLE = make();                                   \
  template <int... I>                                                         \
  static Pack<TABLE.v[I]...> name##_pack(std::integer_sequence<int, I...>);   \
  using name##_values =                                                       \
      decltype(name##_pack(std::make_integer_sequence<int, N>{}));            \
  __host__ __device__ static constexpr int name(int i) {                      \
    return name##_values::at(i);                                              \
  }

// Lookups by a rolled loop's index (TRAJOPT_ROLL_LOOPS), from the tables
// in constant memory below.
template <class T>
__device__ int rolled_row_dof(int r, int w);
template <class T>
__device__ int rolled_row_w(int r);
template <class T>
__device__ int rolled_ancestor(int b, int k);

// The topology of an instance: its struct of tables Tab, which
// instances.cuh holds (written by kernels/topology.py).  NV dofs, NU
// actuators, NBODY bodies (world included), NDOF state dofs; per body
// (world first) PARENT, BODY_DOF (its first dof, -1 for a welded body),
// BODY_NDOF (hinges and slides in declaration order, or 6 for a free
// joint), BODY_QADR (its first joint's first qpos) and FREE; per dof SLIDE
// (else a hinge, or a free joint's), LIMITED (two constraint rows each),
// DOF_BODY and DOF_Q; per state dof SV, its qvel index; NPAIR contact
// pairs, PAIRS their geom types and bodies (geom1, geom2); RES and RESARGS
// the residual (residuals.cuh).  Every lookup of a pair, a slot or a row is
// evaluated at compile time (pair_rows<T, PI>, static_for over the rows) in
// the unrolled instances, so any number of pairs costs no runtime table
// there; the rolled ones (TRAJOPT_ROLL_LOOPS, linalg.cuh) read the rows'
// tables at run time.
template <class Tab>
struct Topo {
  static constexpr int NV = Tab::NV;
  static constexpr int NU = Tab::NU;
  static constexpr int NBODY = Tab::NBODY;
  static constexpr int NDOF = Tab::NDOF;
  static constexpr int NX = 2 * NDOF;
  static constexpr int RES = Tab::RES;
  static constexpr int NPAIR = Tab::NPAIR;
  static constexpr int NRESARG =
      static_cast<int>(sizeof(Tab::RESARGS) / sizeof(int));

  TRAJOPT_TOPO_TABLE(parent, PARENT, NBODY, )
  TRAJOPT_TOPO_TABLE(body_dof, BODY_DOF, NBODY, )
  TRAJOPT_TOPO_TABLE(body_ndof, BODY_NDOF, NBODY, )
  TRAJOPT_TOPO_TABLE(qadr, BODY_QADR, NBODY, )
  TRAJOPT_TOPO_TABLE(free_flag, FREE, NBODY, )
  TRAJOPT_TOPO_TABLE(slide_flag, SLIDE, NV, )
  TRAJOPT_TOPO_TABLE(limited_flag, LIMITED, NV, )
  // the body of dof j, and the qpos of a hinge, slide or free-translation
  // dof j
  TRAJOPT_TOPO_TABLE(dof_body, DOF_BODY, NV, )
  TRAJOPT_TOPO_TABLE(dof_q, DOF_Q, NV, )
  // state dof k: its qvel index
  TRAJOPT_TOPO_TABLE(sv, SV, NDOF, )
  TRAJOPT_TOPO_TABLE(resarg, RESARGS, NRESARG, )
  TRAJOPT_TOPO_TABLE(pair_t1, PAIRS, NPAIR, [0])
  TRAJOPT_TOPO_TABLE(pair_t2, PAIRS, NPAIR, [1])
  TRAJOPT_TOPO_TABLE(pair_b1, PAIRS, NPAIR, [2])
  TRAJOPT_TOPO_TABLE(pair_b2, PAIRS, NPAIR, [3])

  __host__ __device__ static constexpr bool free(int b) {
    return free_flag(b) != 0;
  }
  __host__ __device__ static constexpr bool slide(int j) {
    return slide_flag(j) != 0;
  }
  __host__ __device__ static constexpr int count_free() {
    int n = 0;
    for (int b = 0; b < NBODY; ++b) n += free(b) ? 1 : 0;
    return n;
  }
  static constexpr int NQ = NV + count_free();

  // ---- the residual: RESARGS holds joint_space's (NJ, NUR), the FK
  // residuals' (goal body, end-effector site body, obstacle bodies...) and
  // select's index of each row's coordinate in [qpos, qvel, ctrl]
  static constexpr int NJ = resarg(0);     // joint-space residual sizes
  static constexpr int NUR = NRESARG > 1 ? resarg(1) : 0;
  static constexpr int GOAL = resarg(0);   // FK residual bodies
  static constexpr int SITE_BODY = NUR;
  static constexpr int NOBST = RES == RES_PUSH ? NRESARG - 2 : 0;
  __host__ __device__ static constexpr int obstacle(int i) {
    return resarg(2 + i);
  }
  __host__ __device__ static constexpr int select(int k) { return resarg(k); }
  static constexpr int NRES = RES == RES_JOINT    ? 2 * NJ + NUR
                              : RES == RES_SELECT ? NRESARG
                              : RES == RES_SWEEP  ? 3
                              : RES == RES_TILT   ? 7
                                                  : 4 + NOBST;
  static constexpr int NTGT =
      (RES == RES_PUSH || RES == RES_TILT) ? 2
                                           : (RES == RES_SWEEP ? 4 : NRES);

  // state dof k: its qpos (hinge, slide or translation)
  __host__ __device__ static constexpr int sv_q(int k) { return dof_q(sv(k)); }
  // state dof k is component sv_rot(k) (0-2) of a free joint's rotation,
  // or -1: its position difference is the quaternion's log, taken per
  // body (sv_quat(k), the qpos of the body's quaternion)
  __host__ __device__ static constexpr int sv_rot(int k) {
    return (free(dof_body(sv(k))) && sv(k) - body_dof(dof_body(sv(k))) >= 3)
               ? sv(k) - body_dof(dof_body(sv(k))) - 3
               : -1;
  }
  __host__ __device__ static constexpr int sv_quat(int k) {
    return qadr(dof_body(sv(k))) + 3;
  }
  __host__ __device__ static constexpr bool make_has_rot() {
    for (int k = 0; k < NDOF; ++k)
      if (sv_rot(k) >= 0) return true;
    return false;
  }
  static constexpr bool HAS_ROT = make_has_rot();

  // ---- limits: the k-th limited dof
  __host__ __device__ static constexpr int count_limited() {
    int n = 0;
    for (int j = 0; j < NV; ++j) n += limited_flag(j) != 0 ? 1 : 0;
    return n;
  }
  static constexpr int NLIM = count_limited();
  __host__ __device__ static constexpr Table<NV> make_limdof() {
    Table<NV> t{};
    int k = 0;
    for (int j = 0; j < NV; ++j)
      if (limited_flag(j) != 0) t.v[k++] = j;
    return t;
  }
  TRAJOPT_TOPO_DERIVED(lim_dof, LIMDOF, NV, make_limdof)

  // ---- root paths: whether dof j lies on body b's root path
  __host__ __device__ static constexpr Table<NBODY * NV> make_path() {
    Table<NBODY * NV> t{};
    for (int b0 = 0; b0 < NBODY; ++b0)
      for (int b = b0; b > 0; b = parent(b))
        for (int k = 0; k < body_ndof(b); ++k)
          t.v[b0 * NV + body_dof(b) + k] = 1;
    return t;
  }
  TRAJOPT_TOPO_DERIVED(path_flag, PATH, NBODY * NV, make_path)
  // the k-th ancestor of body b (its parent first), 0 past the root
  __host__ __device__ static constexpr Table<NBODY * NBODY> make_anc() {
    Table<NBODY * NBODY> t{};
    for (int b0 = 0; b0 < NBODY; ++b0) {
      int k = 0;
      for (int a = parent(b0); b0 > 0 && a > 0; a = parent(a))
        t.v[b0 * NBODY + k++] = a;
    }
    return t;
  }
  TRAJOPT_TOPO_DERIVED(ancestor_at, ANC, NBODY * NBODY, make_anc)
  __device__ static int ancestor(int b, int k) {
    if constexpr (ROLL_LOOPS)
      return rolled_ancestor<Topo>(b, k);  // b a rolled loop's: a table
    else
      return ancestor_at(b * NBODY + k);
  }
  __host__ __device__ static constexpr bool on_path(int b, int j) {
    return path_flag(b * NV + j) != 0;
  }

  // ---- contact pairs (contact.cuh): slots per pair (dynamics/collision.py
  // _COLLIDERS), the support (the dofs on exactly one of the two root
  // paths, in dof order) and its signs (+1 on geom2's path, -1 on geom1's)
  __host__ __device__ static constexpr int pair_ncon(int p) {
    return pair_slots(pair_t1(p), pair_t2(p));
  }
  __host__ __device__ static constexpr int nsup(int p) {
    int w = 0;
    for (int j = 0; j < NV; ++j)
      w += on_path(pair_b1(p), j) != on_path(pair_b2(p), j) ? 1 : 0;
    return w;
  }
  // entry p NV + w: the w-th support dof of pair p, then its sign (+1, -1)
  __host__ __device__ static constexpr Table<NPAIR * NV> make_supp(bool sg) {
    Table<NPAIR * NV> t{};
    for (int p = 0; p < NPAIR; ++p) {
      int w = 0;
      for (int j = 0; j < NV; ++j)
        if (on_path(pair_b1(p), j) != on_path(pair_b2(p), j))
          t.v[p * NV + w++] = sg ? (on_path(pair_b2(p), j) ? 1 : -1) : j;
    }
    return t;
  }
  __host__ __device__ static constexpr Table<NPAIR * NV> make_supp_dof() {
    return make_supp(false);
  }
  __host__ __device__ static constexpr Table<NPAIR * NV> make_supp_sign() {
    return make_supp(true);
  }
  static constexpr Table<NPAIR * NV> SUPP = make_supp_dof();
  static constexpr Table<NPAIR * NV> SUPP_SIGN = make_supp_sign();
  template <int PI, int... W>
  static Pack<SUPP.v[PI * NV + W]...> supp_pack(
      std::integer_sequence<int, W...>);
  template <int PI, int... W>
  static Pack<SUPP_SIGN.v[PI * NV + W]...> sign_pack(
      std::integer_sequence<int, W...>);
  // the w-th support dof of pair PI, and its sign
  template <int PI>
  __host__ __device__ static constexpr int supp(
      std::integral_constant<int, PI>, int w) {
    return decltype(supp_pack<PI>(std::make_integer_sequence<int, NV>{}))::at(
        w);
  }
  template <int PI>
  __host__ __device__ static constexpr int supp_sign(
      std::integral_constant<int, PI>, int w) {
    return decltype(sign_pack<PI>(std::make_integer_sequence<int, NV>{}))::at(
        w);
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

  // ---- constraint rows (constraint.cuh): two one-entry rows per limited
  // joint, then four rows per contact slot over its pair's support; row r's
  // width row_w(r) and its w-th dof row_dof(r, w)
  static constexpr int R = 2 * NLIM + 4 * NSLOT;
  static constexpr int ROW_W = max_sup();
  __host__ __device__ static constexpr Table<R * ROW_W + R> make_rows() {
    Table<R * ROW_W + R> t{};
    const Table<NPAIR * NV> sup = make_supp_dof();
    for (int r = 0; r < R; ++r) {
      if (r < 2 * NLIM) {
        t.v[r * ROW_W] = lim_dof(r < NLIM ? r : r - NLIM);
        t.v[R * ROW_W + r] = 1;
      } else {
        const int p = slot_pair((r - 2 * NLIM) / 4);
        for (int w = 0; w < nsup(p); ++w) t.v[r * ROW_W + w] = sup[p * NV + w];
        t.v[R * ROW_W + r] = nsup(p);
      }
    }
    return t;
  }
  static constexpr Table<R * ROW_W + R> ROWS = make_rows();
  template <int RR, int... W>
  static Pack<ROWS.v[RR * ROW_W + W]...> row_pack(
      std::integer_sequence<int, W...>);
  // row RR of a compile-time loop (for_rows: static_for): constants
  template <int RR>
  __host__ __device__ static constexpr int row_dof(
      std::integral_constant<int, RR>, int w) {
    return decltype(row_pack<RR>(std::make_integer_sequence<int, ROW_W>{}))::
        at(w);
  }
  template <int RR>
  __host__ __device__ static constexpr int row_w(
      std::integral_constant<int, RR>) {
    return Pack<ROWS.v[R * ROW_W + RR]>::at(0);
  }
  // row r of a rolled loop (TRAJOPT_ROLL_LOOPS): read from the rows'
  // table in constant memory (ROW_TABLE below; a local copy of the table
  // would be written out at every lookup)
  __device__ static int row_dof(int r, int w) {
    return rolled_row_dof<Topo>(r, w);
  }
  __device__ static int row_w(int r) { return rolled_row_w<Topo>(r); }

  // ---- the model buffer
  static constexpr int DOFB = (NBODY - 1) * BODY_STRIDE;  // per-dof block
  static constexpr int ACT = DOFB + NV * DOF_STRIDE;      // actuator block
  static constexpr int LIM = ACT + NU * ACT_STRIDE;       // limit block
  static constexpr int PAIRB = LIM + NLIM * LIM_STRIDE;   // contact pairs
  static constexpr int GRAV = PAIRB + NPAIR * PAIR_STRIDE;
  static constexpr int DT = GRAV + 3;
};

// The rows' table and the ancestors' of an instance in constant memory,
// for the lookups of rolled loops: every lane of a warp reads the same
// entry at once.
template <class T>
__constant__ Table<T::R * T::ROW_W + T::R> ROW_TABLE = T::ROWS;
template <class T>
__constant__ Table<T::NBODY * T::NBODY> ANC_TABLE = T::ANC;

template <class T>
__device__ __forceinline__ int rolled_row_dof(int r, int w) {
  return ROW_TABLE<T>.v[r * T::ROW_W + w];
}
template <class T>
__device__ __forceinline__ int rolled_row_w(int r) {
  return ROW_TABLE<T>.v[T::R * T::ROW_W + r];
}
template <class T>
__device__ __forceinline__ int rolled_ancestor(int b, int k) {
  return ANC_TABLE<T>.v[b * T::NBODY + k];
}

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

// The world body's frame, velocity and acceleration (gravity).
template <class T, class S>
__device__ __forceinline__ void fk_rne_root(const double* __restrict__ P,
                                            S (&xpos)[T::NBODY][3],
                                            S (&xquat)[T::NBODY][4],
                                            S (&cvel)[T::NBODY][6],
                                            S (&cacc)[T::NBODY][6]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) xpos[0][k] = 0.0;
  xquat[0][0] = 1.0; xquat[0][1] = 0.0; xquat[0][2] = 0.0; xquat[0][3] = 0.0;
#pragma unroll
  for (int k = 0; k < 6; ++k) cvel[0][k] = 0.0;
  cacc[0][0] = 0.0; cacc[0][1] = 0.0; cacc[0][2] = 0.0;
#pragma unroll
  for (int k = 0; k < 3; ++k) cacc[0][3 + k] = -P[T::GRAV + k];
}

// Body b's RNE velocity and acceleration from its parent's, its cdof done:
// with fk_body the part of a body's forward sweep that chains down the
// tree.
template <class T, class S>
__device__ __forceinline__ void rne_chain(const S* v, const int b,
                                          const S (&cdof)[T::NV][6],
                                          S (&cvel)[T::NBODY][6],
                                          S (&cacc)[T::NBODY][6]) {
  const int p = T::parent(b);
  const int j0 = T::body_dof(b);
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
}

// Body b's inertia about the world origin from its frame: a body's own
// part of the forward sweep, independent of the other bodies' (b may be a
// runtime index: the cooperative step runs a body per thread).
template <class T, class S>
__device__ __forceinline__ void body_inertia(const double* __restrict__ P,
                                             const int b, const S* xp,
                                             const S* xq, Inertia<S>& I) {
  const double* pb = P + (b - 1) * BODY_STRIDE;
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
}

// Body b's RNE force from its inertia, velocity and acceleration.
template <class S>
__device__ __forceinline__ void body_rne_force(const Inertia<S>& I,
                                               const S* cvel, const S* cacc,
                                               S* cfrc) {
  S Iv[6], Ia[6], cf[6];
  inertia_mul(I, cvel, Iv);
  inertia_mul(I, cacc, Ia);
  cross_force(cvel, Iv, cf);
#pragma unroll
  for (int k = 0; k < 6; ++k) cfrc[k] = Ia[k] + cf[k];
}

// The RNE backward sweep (the bias force) and the composite inertias
// (CRBA's), leaves first.
template <class T, class S>
__device__ __forceinline__ void rne_backward(const S (&cdof)[T::NV][6],
                                             S (&cfrc)[T::NBODY][6],
                                             Inertia<S> (&In)[T::NBODY],
                                             S (&bias)[T::NV]) {
#pragma unroll
  for (int b = T::NBODY - 1; b >= 1; --b) {
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
}

// FK, the body inertias and the RNE forward sweep, with WANT_RES the FK
// residual of the state (q, v) (fk_residual_of, its constants `resc` from
// the task buffer) from the same FK products, then the RNE backward sweep
// (the bias force) and the composite inertias (CRBA's): the part of
// smooth_step before the mass matrix, on one thread, in the order of the
// JAX lane step's body loop.  The cooperative step (warp_step.cuh) runs
// the same parts, body_inertia and body_rne_force one body per thread.
template <class T, bool WANT_RES, class S>
__device__ __forceinline__ void fk_rne(const double* __restrict__ P,
                                       const S* q, const S* v,
                                       const double* tg, const double* resc,
                                       double* res, S (&xpos)[T::NBODY][3],
                                       S (&xquat)[T::NBODY][4],
                                       S (&cdof)[T::NV][6],
                                       Inertia<S> (&In)[T::NBODY],
                                       S (&bias)[T::NV]) {
  constexpr int NB = T::NBODY;
  S cvel[NB][6], cacc[NB][6], cfrc[NB][6];
  fk_rne_root<T>(P, xpos, xquat, cvel, cacc);
#pragma unroll
  for (int b = 1; b < NB; ++b) {
    fk_body<T>(P, q, b, xpos, xquat, cdof);
    body_inertia<T>(P, b, xpos[b], xquat[b], In[b]);
    rne_chain<T>(v, b, cdof, cvel, cacc);
    body_rne_force(In[b], cvel[b], cacc[b], cfrc[b]);
  }
  if constexpr (WANT_RES && fk_residual(T::RES) && !is_dual<S>::value)
    fk_residual_of<T>(resc, xpos, xquat, v, tg, res);
  rne_backward<T>(cdof, cfrc, In, bias);
}

// (q, v, u) -> (qn, vn): FK, RNE bias, CRBA mass matrix, passive and
// actuator forces, the constraint force of the limit rows (K2a) and contact
// rows (K2b), (M + h D) qacc = f, semi-implicit Euler.  With WANT_RES the FK
// residual of the state (q, v) (fk_residual, with its constants `resc`
// from the task buffer) is written to `res`, from the same FK products the
// step uses.  With FK_BIAS the step stops after the
// RNE and writes its FK products and bias force to `out` (fk_bias below).
// K5ad's primal buffer `ad` (constraint.cuh:AdPrimalBuf): with AD_PRIMAL,
// in double, the step stops after the constraint rows and writes K2c's
// values there (the Newton iterate and the gated Hessian's factor,
// constraint.cuh:ad_primal); in dual numbers (K5ad's tangent pass, which
// always gives it) it reads them there instead of computing them again.
template <class T, bool WANT_RES = false, bool FK_BIAS = false,
          class S = double, bool AD_PRIMAL = false>
__device__ void smooth_step(const double* __restrict__ P, const S* q,
                            const S* v, const S* u, S* qn, S* vn,
                            const double* tg = nullptr,
                            const double* resc = nullptr,
                            double* res = nullptr,
                            const FkBiasOut* out = nullptr,
                            const AdPrimalBuf* ad = nullptr) {
  constexpr int NV = T::NV;
  constexpr int NU = T::NU;
  constexpr int NB = T::NBODY;
  S xpos[NB][3], xquat[NB][4];
  S cdof[NV][6];
  Inertia<S> In[NB];
  S bias[NV];
  fk_rne<T, WANT_RES>(P, q, v, tg, resc, res, xpos, xquat, cdof, In, bias);
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
    TRAJOPT_UNROLL
    for (int i = 0; i < NV; ++i)
      TRAJOPT_UNROLL
      for (int k = 0; k < NV; ++k) M[i][k] = 0.0;
    TRAJOPT_UNROLL
    for (int i = 0; i < NV; ++i) {
      const int bi = T::dof_body(i);
      S F[6];
      inertia_mul(In[bi], cdof[i], F);
      M[i][i] = dot6(cdof[i], F) + P[T::DOFB + i * DOF_STRIDE + D_ARM];
      // the body's own earlier dofs (a free joint's), then its ancestors'
      // (parent first); loops of constant trip count with guards, which the
      // unroller folds
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
      for (int n = 0; n < NB - 1; ++n) {
        const int a = T::ancestor(bi, n);
        if (a <= 0) continue;
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
    TRAJOPT_UNROLL
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
      if constexpr (AD_PRIMAL) {
        ad_primal<T>(M, f, rows, *ad);
        return;
      } else {
        constraint_solve<T>(M, f, rows, qc, ad);
      }
      TRAJOPT_UNROLL
      for (int i = 0; i < NV; ++i) f[i] = f[i] + qc[i];
    }
    TRAJOPT_UNROLL
    for (int i = 0; i < NV; ++i)
      M[i][i] += h * P[T::DOFB + i * DOF_STRIDE + D_DAMP];
    chol_factor<NV>(M);
    chol_solve<NV>(M, f);
    TRAJOPT_UNROLL
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
    select_residual<T>(q, v, u, tg, r);
    smooth_step<T>(P, q, v, u, qn, vn);
  } else {
    smooth_step<T, true>(P, q, v, u, qn, vn, tg, resc, r);
  }
}

}  // namespace trajopt
