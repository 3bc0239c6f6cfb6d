// K8: the MPC replan's apply step, one thread per episode lane.
//
// Replaces the part of the JAX lane replan after the forward pass,
// trajoptkp_tpu/mpc/sync.py:148-177 (_build_lane_replan:100): the accept
// blend of the controls, the replan cost, the num_apply noisy controls
// applied to the episode and the shift-pad of the consumed controls.  Plain
// twin: trajoptkp_tpu_torch/mpc/sync.py:apply_controls.
//
// Per lane, with acc = 1 where the line search was accepted, else 0:
//   U_new[t] = acc U_n[t] + (1 - acc) U[t];  rcost = acc ? best : old
//   for t < num_apply: u = clip(U_new[t] + std z[t], lo, hi), the running
//     cost of the pre-step state (q, v) with u (the task residual of the
//     rollout, running weights), one K1 step (step.cuh), histories;
//   U_shift[t] = U_new[t + num_apply], the last num_apply padded with
//     U_new[H-1].
// The same operations in the same order as the twin (-fmad=false), so the
// two agree bit for bit on the card.
//
// Bound: num_apply steps per lane (one at the walker's MPC setting) against
// reading U and U_n (2 H nu doubles) and writing U_shift (H nu): at B = 1 a
// single thread, bound by the latency of one step; the launch itself is
// most of its time.
#include "instances.cuh"
#include "residuals.cuh"
#include "step.cuh"

namespace trajopt {

template <class T>
__global__ void __launch_bounds__(64)
mpc_apply_kernel(const double* __restrict__ P, const double* __restrict__ W,
                 const double* __restrict__ qp0,
                 const double* __restrict__ qv0,
                 const double* __restrict__ U, const double* __restrict__ Un,
                 const double* __restrict__ acc,
                 const double* __restrict__ best,
                 const double* __restrict__ old,
                 const double* __restrict__ z, const double* __restrict__ std,
                 const double* __restrict__ tgt, double* __restrict__ qp2,
                 double* __restrict__ qv2, double* __restrict__ Ushift,
                 double* __restrict__ qps, double* __restrict__ qvs,
                 double* __restrict__ us, double* __restrict__ cs,
                 double* __restrict__ rcost, int H, int NA, int B) {
  constexpr int NQ = T::NQ, NV = T::NV, NU = T::NU, NRES = T::NRES;
  constexpr int NTGT = T::NTGT;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  // task buffer: w_run, w_term, lo, hi, the residual's constants
  const double* lo = W + 2 * NRES;
  const double* hi = lo + NU;
  const double* resc = hi + NU;
  const double a = acc[b];
  const double na = 1.0 - a;
  rcost[b] = a != 0.0 ? best[b] : old[b];
  for (int t = 0; t < H; ++t) {
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      const size_t i = (size_t(t) * NU + c) * B + b;
      const double un = a * Un[i] + na * U[i];
      if (t >= NA) Ushift[(size_t(t - NA) * NU + c) * B + b] = un;
      if (t == H - 1)
        for (int s = H - NA; s < H; ++s)
          Ushift[(size_t(s) * NU + c) * B + b] = un;
    }
  }
  double q[NQ], v[NV], tg[NTGT];
#pragma unroll
  for (int i = 0; i < NQ; ++i) q[i] = qp0[i * B + b];
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = qv0[i * B + b];
#pragma unroll
  for (int r = 0; r < NTGT; ++r) tg[r] = tgt[r * B + b];
  for (int t = 0; t < NA; ++t) {
    double u[NU], r[NRES], qn[NQ], vn[NV];
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      const size_t i = (size_t(t) * NU + c) * B + b;
      const double un = a * Un[i] + na * U[i];
      u[c] = clip(un + std[c] * z[i], lo[c], hi[c]);
      us[i] = u[c];
    }
#pragma unroll
    for (int i = 0; i < NQ; ++i) qps[(size_t(t) * NQ + i) * B + b] = q[i];
#pragma unroll
    for (int i = 0; i < NV; ++i) qvs[(size_t(t) * NV + i) * B + b] = v[i];
    residual_and_step<T>(P, q, v, u, tg, resc, r, qn, vn);
    cs[size_t(t) * B + b] = weighted_cost<NRES>(r, W);
#pragma unroll
    for (int i = 0; i < NQ; ++i) q[i] = qn[i];
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] = vn[i];
  }
#pragma unroll
  for (int i = 0; i < NQ; ++i) qp2[i * B + b] = q[i];
#pragma unroll
  for (int i = 0; i < NV; ++i) qv2[i * B + b] = v[i];
}

}  // namespace trajopt

#define TRAJOPT_DEFINE_MPC_APPLY(tag, ...)                                     \
  extern "C" int trajopt_mpc_apply_##tag(                                     \
      const double* P, const double* W, const double* qp0,                    \
      const double* qv0, const double* U, const double* Un,                   \
      const double* acc, const double* best, const double* old,               \
      const double* z, const double* std, const double* tgt, double* qp2,     \
      double* qv2, double* Ushift, double* qps, double* qvs, double* us,      \
      double* cs, double* rcost, int H, int NA, int B, void* stream) {        \
    using T = trajopt::Topo<__VA_ARGS__>;                                     \
    if (B <= 0) return 0;                                                     \
    trajopt::mpc_apply_kernel<T><<<(B + 63) / 64, 64, 0,                      \
                                   static_cast<cudaStream_t>(stream)>>>(      \
        P, W, qp0, qv0, U, Un, acc, best, old, z, std, tgt, qp2, qv2, Ushift, \
        qps, qvs, us, cs, rcost, H, NA, B);                                   \
    return static_cast<int>(cudaGetLastError());                              \
  }

TRAJOPT_INSTANCES(TRAJOPT_DEFINE_MPC_APPLY)
TRAJOPT_DEFINE_ERROR_STRING
