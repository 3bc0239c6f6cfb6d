// K6: the Gauss-Newton cost expansion, one thread per (step, lane).
//
// Replaces the JAX lane cost expansion, trajoptkp_tpu/solver/lanes.py:597
// (jax.jacfwd of the residual over the 2n + nu tangent columns, then two
// einsums).  Plain twin: trajoptkp_tpu_torch/solver/lanes.py:cost_expansion.
//
// Per (t, b): the residual r of (x_t, u_t) and its Jacobian J (NRES x NZ,
// NZ = 2 NDOF + NU) on the tangent space in closed form: a constant
// selection for the joint-space and the selected-coordinate residuals
// (their nonzeros are 1 at (row, the tangent column of its coordinate)),
// and for the FK residuals (pushing, box_sweep, threeD_push) the
// derivatives of their norms through the point Jacobians of the goal and
// the end effector, and threeD_push's tilt through the box rotation's
// tangent, from the step's own FK products (fk_frames, step.cuh).  Then
// l_z = 2 sum_r w_r r_r J_r and, for the (x, x) and (u, u) blocks,
// l_zz = 2 sum_r (w_r J_r) J_r^T, terminal
// weights at t = H-1; every sum runs left to right over r, as the twin's
// `ilqr._contract`, and the build's -fmad=false keeps the products
// unfused, so kernel and twin agree bit for bit.
//
// Bound: bytes.  Per (t, b) it reads the state and control (nq + nv + nu
// doubles) and writes nx + nx^2 + nu + nu^2 doubles (acrobot 22, push_ncl
// 476); its arithmetic is ~NRES NZ (NX + NU + 1) products, plus ~2.5k
// operations of FK for the pushing residual.  Threads run along the lanes
// of a block (64) and the steps of the grid's y axis, so every load and
// store is coalesced across a warp's lanes.  J is indexed by the runtime
// z and y loops of the products and lives in local memory (L1): simple
// first.
#include "instances.cuh"
#include "residuals.cuh"
#include "step.cuh"

namespace trajopt {

// The coordinate residual row k selects, as an index into x = [q (NQ),
// v (NV), u (NU)]: RES_SELECT's table, or RES_JOINT's first NJ qpos, first
// NJ qvel and first NUR controls.
template <class T>
__host__ __device__ constexpr int selected(int k) {
  if constexpr (T::RES == RES_SELECT) {
    return T::select(k);
  } else {
    return k < T::NJ       ? k
           : k < 2 * T::NJ ? T::NQ + k - T::NJ
                           : T::NQ + T::NV + k - 2 * T::NJ;
  }
}

// The tangent column of coordinate i of x: a state dof's position or
// velocity column, a control's column, or -1 when the state vector does
// not hold it.
template <class T>
__host__ __device__ constexpr int tangent_col(int i) {
  if (i >= T::NQ + T::NV) return 2 * T::NDOF + (i - T::NQ - T::NV);
  for (int s = 0; s < T::NDOF; ++s) {
    if (i < T::NQ && T::sv_rot(s) < 0 && T::sv_q(s) == i) return s;
    if (i >= T::NQ && T::sv(s) == i - T::NQ) return T::NDOF + s;
  }
  return -1;
}

// tasks/pushing.py:push_residual_jacobian and tasks/manipulation.py:
// sweep_residual_jacobian, tilt_push_residual_jacobian.  A point p fixed on
// body b moves with a dof j of b's root path at w_j x p + v_j ((w_j, v_j)
// = cdof_j): the goal (the free body's origin) with its translations (its
// rotations give w x p + p x w, exactly 0), the end effector with the
// arm's hinges; d|x|/dx = x / |x|.  Each clutter obstacle's row is that of
// its x and y translations, d_k / |d| for d its xy less its layout point.
// threeD_push's tilt moves with the free rotation's tangent, dq/dz_k =
// 0.5 q (0, e_k).
template <class T, int NZ>
__device__ __forceinline__ void fk_jacobian(const double* __restrict__ P,
                                            const double* __restrict__ site,
                                            const double* q, const double* v,
                                            const double* tg, double* r,
                                            double (*J)[NZ]) {
  constexpr int N = T::NDOF;
  // the rows of |goal_xy - tg|, of the planar velocity and of the reach
  constexpr int RV = T::RES == RES_TILT ? 2 : 1;
  constexpr int RR =
      T::RES == RES_PUSH ? 3 + T::NOBST : (T::RES == RES_SWEEP ? 2 : 6);
  Frames<T> fr;
  fk_frames<T>(P, q, fr);
  fk_residual_of<T>(site, fr.xpos, fr.xquat, v, tg, r);
  const double* goal = fr.xpos[T::GOAL];
  const double* gq = fr.xquat[T::GOAL];
  const int gd = T::body_dof(T::GOAL);
  double ee[3], d[3];
  ee_point<T>(site, fr.xpos, fr.xquat, ee);
#pragma unroll
  for (int k = 0; k < 3; ++k) d[k] = ee[k] - goal[k];
  const double g[2] = {goal[0] - tg[0], goal[1] - tg[1]};
  double gv[2] = {v[gd], v[gd + 1]};
  if constexpr (T::RES == RES_SWEEP) {
    gv[0] = v[gd] - tg[2];
    gv[1] = v[gd + 1] - tg[3];
  }
  for (int i = 0; i < T::NRES; ++i)
    for (int z = 0; z < NZ; ++z) J[i][z] = 0.0;
#pragma unroll
  for (int s = 0; s < N; ++s) {
    const int j = T::sv(s);
    const bool og = T::on_path(T::GOAL, j);
    const bool oe = T::on_path(T::SITE_BODY, j);
    if (og || oe) {
      double pg[3] = {0.0, 0.0, 0.0}, pe[3] = {0.0, 0.0, 0.0}, c[3];
      if (og) {
        cross3(fr.cdof[j], goal, c);
#pragma unroll
        for (int k = 0; k < 3; ++k) pg[k] = c[k] + fr.cdof[j][3 + k];
      }
      if (oe) {
        cross3(fr.cdof[j], ee, c);
#pragma unroll
        for (int k = 0; k < 3; ++k) pe[k] = c[k] + fr.cdof[j][3 + k];
      }
      if constexpr (T::RES == RES_TILT) {
        J[0][s] = pg[0];
        J[1][s] = pg[1];
      } else {
        J[0][s] = (g[0] * pg[0] + g[1] * pg[1]) / r[0];
      }
      J[RR][s] = (d[0] * (pe[0] - pg[0]) + d[1] * (pe[1] - pg[1]) +
                  d[2] * (pe[2] - pg[2])) /
                 r[RR];
    }
    if constexpr (T::RES == RES_TILT) {
      if (j >= gd + 3 && j < gd + 6) {
        // 0.5 q (0, e_k): k = 0 (-x, w, z, -y), 1 (-y, -z, w, x),
        // 2 (-z, y, -x, w)
        const int k = j - gd - 3;
        const double w = gq[0], x = gq[1], y = gq[2], z = gq[3];
        const double dw = 0.5 * (k == 0 ? -x : (k == 1 ? -y : -z));
        const double dx = 0.5 * (k == 0 ? w : (k == 1 ? -z : y));
        const double dy = 0.5 * (k == 0 ? z : (k == 1 ? w : -x));
        const double dz = 0.5 * (k == 0 ? -y : (k == 1 ? x : w));
        J[4][s] = 2.0 * ((dx * z + x * dz) + (dw * y + w * dy));
        J[5][s] = 2.0 * ((dy * z + y * dz) - (dw * x + w * dx));
      }
      if (j == gd)
        J[2][N + s] = 1.0;
      else if (j == gd + 1)
        J[3][N + s] = 1.0;
    } else {
      if (j == gd)
        J[RV][N + s] = gv[0] / r[RV];
      else if (j == gd + 1)
        J[RV][N + s] = gv[1] / r[RV];
    }
    if constexpr (T::RES == RES_PUSH) {
      if (j == PUSH_JOINT5) J[2 + T::NOBST][N + s] = 1.0;
      // |obstacle_i xy - its layout point|: the free body's origin moves
      // with its x and y translations alone (cdof e_x, e_y)
#pragma unroll
      for (int i = 0; i < T::NOBST; ++i) {
        const int od = T::body_dof(T::obstacle(i));
        if (j == od || j == od + 1) {
          const int k = j - od;
          const double dk = fr.xpos[T::obstacle(i)][k] - site[3 + 2 * i + k];
          J[2 + i][s] = dk / r[2 + i];
        }
      }
    }
  }
}

// solver/lanes.py:residual_jacobian: r (NRES) and J (NRES x NZ) at one
// (state, control); `resc` holds the residual's constants (task buffer).
template <class T, int NZ>
__device__ __forceinline__ void residual_jacobian(
    const double* __restrict__ P, const double* __restrict__ resc,
    const double* q, const double* v, const double* u, const double* tg,
    double* r, double (*J)[NZ]) {
  if constexpr (fk_residual(T::RES)) {
    fk_jacobian<T, NZ>(P, resc, q, v, tg, r, J);
  } else {
    if constexpr (T::RES == RES_JOINT)
      joint_space_residual<T::NJ, T::NUR>(q, v, u, tg, r);
    else
      select_residual<T>(q, v, u, tg, r);
    for (int i = 0; i < T::NRES; ++i)
      for (int z = 0; z < NZ; ++z) J[i][z] = 0.0;
#pragma unroll
    for (int i = 0; i < T::NRES; ++i) {
      const int c = tangent_col<T>(selected<T>(i));
      if (c >= 0) J[i][c] = 1.0;
    }
  }
}

template <class T>
__global__ void __launch_bounds__(64)
cost_expansion_kernel(const double* __restrict__ P,
                      const double* __restrict__ W,
                      const double* __restrict__ qpos,
                      const double* __restrict__ qvel,
                      const double* __restrict__ U,
                      const double* __restrict__ tgt,
                      double* __restrict__ l_x, double* __restrict__ l_xx,
                      double* __restrict__ l_u, double* __restrict__ l_uu,
                      int H, int B) {
  constexpr int NQ = T::NQ, NV = T::NV, NU = T::NU, NRES = T::NRES;
  constexpr int NTGT = T::NTGT, NX = T::NX, NZ = T::NX + T::NU;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  if (b >= B) return;
  double q[NQ], v[NV], u[NU], tg[NTGT], r[NRES], J[NRES][NZ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) q[i] = qpos[(size_t(t) * NQ + i) * B + b];
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = qvel[(size_t(t) * NV + i) * B + b];
#pragma unroll
  for (int a = 0; a < NU; ++a) u[a] = U[(size_t(t) * NU + a) * B + b];
#pragma unroll
  for (int k = 0; k < NTGT; ++k) tg[k] = tgt[k * B + b];
  // task buffer: w_run, w_term, lo, hi, the residual's constants
  residual_jacobian<T, NZ>(P, W + 2 * NRES + 2 * NU, q, v, u, tg, r, J);
  const double* w = t == H - 1 ? W + NRES : W;
  double wr[NRES];
#pragma unroll
  for (int i = 0; i < NRES; ++i) wr[i] = w[i] * r[i];
  for (int z = 0; z < NZ; ++z) {
    double s = wr[0] * J[0][z];
#pragma unroll
    for (int i = 1; i < NRES; ++i) s = s + wr[i] * J[i][z];
    if (z < NX)
      l_x[(size_t(t) * NX + z) * B + b] = 2.0 * s;
    else
      l_u[(size_t(t) * NU + (z - NX)) * B + b] = 2.0 * s;
  }
  for (int z = 0; z < NX; ++z)
    for (int y = 0; y < NX; ++y) {
      double s = (w[0] * J[0][z]) * J[0][y];
#pragma unroll
      for (int i = 1; i < NRES; ++i) s = s + (w[i] * J[i][z]) * J[i][y];
      l_xx[((size_t(t) * NX + z) * NX + y) * B + b] = 2.0 * s;
    }
  for (int z = 0; z < NU; ++z)
    for (int y = 0; y < NU; ++y) {
      double s = (w[0] * J[0][NX + z]) * J[0][NX + y];
#pragma unroll
      for (int i = 1; i < NRES; ++i)
        s = s + (w[i] * J[i][NX + z]) * J[i][NX + y];
      l_uu[((size_t(t) * NU + z) * NU + y) * B + b] = 2.0 * s;
    }
}

}  // namespace trajopt

// The steps run along the grid's y axis (at most 65535).
#define TRAJOPT_DEFINE_COST_EXPANSION(tag, ...)                               \
  extern "C" int trajopt_cost_expansion_##tag(                                \
      const double* P, const double* W, const double* qpos,                   \
      const double* qvel, const double* U, const double* tgt, double* l_x,    \
      double* l_xx, double* l_u, double* l_uu, int H, int B, void* stream) {  \
    using T = trajopt::Topo<__VA_ARGS__>;                                     \
    if (B <= 0 || H <= 0) return 0;                                           \
    if (H > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);    \
    const dim3 grid((B + 63) / 64, H);                                        \
    trajopt::cost_expansion_kernel<T>                                         \
        <<<grid, 64, 0, static_cast<cudaStream_t>(stream)>>>(                 \
            P, W, qpos, qvel, U, tgt, l_x, l_xx, l_u, l_uu, H, B);            \
    return static_cast<int>(cudaGetLastError());                              \
  }

TRAJOPT_INSTANCES(TRAJOPT_DEFINE_COST_EXPANSION)
TRAJOPT_DEFINE_ERROR_STRING
