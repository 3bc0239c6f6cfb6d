// Task residuals as device functions, one per residual kind.  The plain
// twin of each has the same name in trajoptkp_tpu_torch/tasks/.
#pragma once

#include "geometry.cuh"

namespace trajopt {

// Residual kinds (tasks/base.py residual_kind; Topo's RES)
constexpr int RES_JOINT = 0;  // ("joint_space", nj, nr)
constexpr int RES_PUSH = 1;   // ("push", 0): the FK residual below
constexpr int RES_SELECT = 2;  // ("select", rows): selected coordinates
constexpr int PUSH_JOINT5 = 5;  // tasks/pushing.py JOINT5

// tasks/toys.py:joint_space_residual — [q_i - tq_i] (NJ), [v_i - tv_i] (NJ),
// [u_i - tu_i] (NU); targets laid out [pos (NJ), vel (NJ), ctrl (NU)].  NJ
// and NU are the residual's own sizes (reaching: NJ = 7, NU = 0).
template <int NJ, int NU>
__device__ __forceinline__ void joint_space_residual(const double* q,
                                                     const double* v,
                                                     const double* u,
                                                     const double* tg,
                                                     double* r) {
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    r[i] = q[i] - tg[i];
    r[NJ + i] = v[i] - tg[NJ + i];
  }
#pragma unroll
  for (int a = 0; a < NU; ++a) r[2 * NJ + a] = u[a] - tg[2 * NJ + a];
}

// tasks/locomotion.py:select_residual — r_k = x_k - tg_k for the k-th
// selected coordinate of x = [q (NQ), v (NV), u (NU)]: entry k of SELECT (5
// bits each) indexes x.  The walker's residual (torso height and angle,
// forward velocity, the six controls) is this with its selection.
template <int NQ, int NV, int NRES, unsigned long long SELECT>
__device__ __forceinline__ void select_residual(const double* q,
                                                const double* v,
                                                const double* u,
                                                const double* tg, double* r) {
#pragma unroll
  for (int k = 0; k < NRES; ++k) {
    const int i = static_cast<int>((SELECT >> (5 * k)) & 0x1Full);
    const double x = i < NQ ? q[i] : (i < NQ + NV ? v[i - NQ] : u[i - NQ - NV]);
    r[k] = x - tg[k];
  }
}

// sqrt(sum of squares left to right + 1e-12)
template <int N>
__device__ __forceinline__ double norm_eps(const double* x) {
  double s = x[0] * x[0];
#pragma unroll
  for (int k = 1; k < N; ++k) s = s + x[k] * x[k];
  return sqrt(s + 1e-12);
}

// tasks/pushing.py:push_residual — [|goal_xy - tg|, |goal planar velocity|,
// joint-5 velocity, |ee - goal|] from the FK products of the state (the
// step's own, before the step: the JAX lane rollout reads the same);
// `site` holds the end-effector site's position on body T::SITE_BODY.
template <class T>
__device__ __forceinline__ void push_residual(
    const double* __restrict__ site, const double (&xpos)[T::NBODY][3],
    const double (&xquat)[T::NBODY][4], const double* v, const double* tg,
    double* r) {
  const double* goal = xpos[T::GOAL];
  const int gd = T::body_dof(T::GOAL);
  double R[9], ee[3], d[3];
  quat_to_mat(xquat[T::SITE_BODY], R);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    ee[k] = xpos[T::SITE_BODY][k] +
            (R[3 * k] * site[0] + R[3 * k + 1] * site[1] +
             R[3 * k + 2] * site[2]);
  const double g[2] = {goal[0] - tg[0], goal[1] - tg[1]};
  const double gv[2] = {v[gd], v[gd + 1]};
#pragma unroll
  for (int k = 0; k < 3; ++k) d[k] = ee[k] - goal[k];
  r[0] = norm_eps<2>(g);
  r[1] = norm_eps<2>(gv);
  r[2] = v[PUSH_JOINT5];
  r[3] = norm_eps<3>(d);
}

// c = sum_i w_i r_i^2
template <int NRES>
__device__ __forceinline__ double weighted_cost(const double* r,
                                                const double* w) {
  double c = 0.0;
#pragma unroll
  for (int i = 0; i < NRES; ++i) c += w[i] * r[i] * r[i];
  return c;
}

}  // namespace trajopt
