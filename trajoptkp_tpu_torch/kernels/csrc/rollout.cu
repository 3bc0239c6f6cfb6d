// K3: fused rollout, one thread per scene with the time loop inside.
//
// Replaces the JAX lane rollout, trajoptkp_tpu/solver/lanes.py:263
// (a lax.scan of the lane step).  Plain twin:
// trajoptkp_tpu_torch/solver/ilqr.py:rollout.
//
// Per lane: H steps of K1 (step.cuh; with joint limits or contacts the
// constraint solve K2a of constraint.cuh over the rows of K2b, contact.cuh,
// inside it), the task residual at (x_t, u_t) (joint-space, or the FK
// residual from the step's own FK products of x_t) and the weighted cost,
// terminal weights at t = H-1.  Layout is batch last, so each step's loads
// and stores are coalesced across the lanes of a warp.
//
// Bound: ~H x (one step's ~1.3k (acrobot) to ~16k (panda with its limit
// rows) or ~60k (push_ncl with its contact rows) dependent double
// operations) per thread against ~(nq + nv + 1) x 8 bytes written per step:
// latency-bound per thread, and at B = 512 lanes only 8 blocks of 64 threads
// are resident (2 blocks at 128 scenes), so most SMs idle.  A later version
// can split lanes across warps (one warp per lane, bodies across threads) to
// fill the card.
#include "instances.cuh"
#include "residuals.cuh"
#include "step.cuh"

namespace trajopt {

template <class T>
__global__ void __launch_bounds__(64)
rollout_kernel(const double* __restrict__ P, const double* __restrict__ W,
               const double* __restrict__ qp0, const double* __restrict__ qv0,
               const double* __restrict__ U, const double* __restrict__ tgt,
               double* __restrict__ qpos, double* __restrict__ qvel,
               double* __restrict__ costs, int H, int B) {
  constexpr int NQ = T::NQ, NV = T::NV, NU = T::NU, NRES = T::NRES;
  constexpr int NTGT = T::NTGT;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  // task buffer: w_run, w_term, lo, hi, the residual's constants
  const double* resc = W + 2 * NRES + 2 * NU;
  double q[NQ], v[NV], tg[NTGT];
#pragma unroll
  for (int i = 0; i < NQ; ++i) q[i] = qp0[i * B + b];
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = qv0[i * B + b];
#pragma unroll
  for (int r = 0; r < NTGT; ++r) tg[r] = tgt[r * B + b];
  for (int t = 0; t < H; ++t) {
    double u[NU], r[NRES], qn[NQ], vn[NV];
#pragma unroll
    for (int i = 0; i < NQ; ++i) qpos[(size_t(t) * NQ + i) * B + b] = q[i];
#pragma unroll
    for (int i = 0; i < NV; ++i) qvel[(size_t(t) * NV + i) * B + b] = v[i];
#pragma unroll
    for (int a = 0; a < NU; ++a) u[a] = U[(size_t(t) * NU + a) * B + b];
    residual_and_step<T>(P, q, v, u, tg, resc, r, qn, vn);
    costs[size_t(t) * B + b] =
        weighted_cost<NRES>(r, t == H - 1 ? W + NRES : W);
#pragma unroll
    for (int i = 0; i < NQ; ++i) q[i] = qn[i];
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] = vn[i];
  }
#pragma unroll
  for (int i = 0; i < NQ; ++i) qpos[(size_t(H) * NQ + i) * B + b] = q[i];
#pragma unroll
  for (int i = 0; i < NV; ++i) qvel[(size_t(H) * NV + i) * B + b] = v[i];
}

// The FK products and bias force of B lanes (fk_bias, step.cuh), one lane
// per thread: the device half of the pushing tasks' servo, which steps
// through the rollout kernel at H = 1.  Plain twin: dynamics/fk.py:
// forward_kinematics + dynamics/smooth.py:bias_force.
template <class T>
__global__ void __launch_bounds__(64)
fk_bias_kernel(const double* __restrict__ P, const double* __restrict__ qp,
               const double* __restrict__ qv, double* __restrict__ xpos,
               double* __restrict__ xquat, double* __restrict__ cdof,
               double* __restrict__ bias, int B) {
  constexpr int NQ = T::NQ, NV = T::NV;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  double q[NQ], v[NV];
#pragma unroll
  for (int i = 0; i < NQ; ++i) q[i] = qp[i * B + b];
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = qv[i * B + b];
  const FkBiasOut out{xpos, xquat, cdof, bias, B, b};
  fk_bias<T>(P, q, v, out);
}

}  // namespace trajopt

#define TRAJOPT_DEFINE_FK_BIAS(tag, ...)                                      \
  extern "C" int trajopt_fk_bias_##tag(                                       \
      const double* P, const double* qp, const double* qv, double* xpos,      \
      double* xquat, double* cdof, double* bias, int B, void* stream) {       \
    using T = trajopt::Topo<__VA_ARGS__>;                                     \
    if (B <= 0) return 0;                                                     \
    trajopt::fk_bias_kernel<T><<<(B + 63) / 64, 64, 0,                        \
                                 static_cast<cudaStream_t>(stream)>>>(        \
        P, qp, qv, xpos, xquat, cdof, bias, B);                               \
    return static_cast<int>(cudaGetLastError());                              \
  }

TRAJOPT_INSTANCES(TRAJOPT_DEFINE_FK_BIAS)

#define TRAJOPT_DEFINE_ROLLOUT(tag, ...)                                       \
  extern "C" int trajopt_rollout_##tag(                                       \
      const double* P, const double* W, const double* qp0, const double* qv0, \
      const double* U, const double* tgt, double* qpos, double* qvel,         \
      double* costs, int H, int B, void* stream) {                            \
    using T = trajopt::Topo<__VA_ARGS__>;                                     \
    if (B <= 0) return 0;                                                     \
    trajopt::rollout_kernel<T><<<(B + 63) / 64, 64, 0,                        \
                                 static_cast<cudaStream_t>(stream)>>>(        \
        P, W, qp0, qv0, U, tgt, qpos, qvel, costs, H, B);                     \
    return static_cast<int>(cudaGetLastError());                              \
  }

TRAJOPT_INSTANCES(TRAJOPT_DEFINE_ROLLOUT)
TRAJOPT_DEFINE_ERROR_STRING
