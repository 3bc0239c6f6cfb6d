// Task residuals as device functions, one per residual kind.  The plain
// twin of each has the same name in trajoptkp_tpu_torch/tasks/.
#pragma once

namespace trajopt {

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
