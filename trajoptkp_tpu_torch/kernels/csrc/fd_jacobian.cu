// K5: keypoint-slot Jacobians by central FD, one thread per (slot, scene).
//
// Replaces the JAX lane slot Jacobians, trajoptkp_tpu/solver/lanes.py:282
// (_slot_jacobians_chunk, jacfwd of the lane step, used by jacobians_si
// :342).  The port keeps the reference's own semantics instead: central
// differences with eps = 1e-6 in double precision over all 2n + nu tangent
// columns (trajoptkp_tpu/derivs/fd.py:83 fd_job_columns).  Plain twin:
// trajoptkp_tpu_torch/derivs/fd.py:fd_slot_jacobians.
//
// Per lane: for each column c over the state vector's 2 ndof dofs and the
// nu controls, the state or control is perturbed by +-eps (a position as
// q (+) e with integrate_pos at dt 1, which also renormalises a free
// joint's quaternion, as the twin's integrate_pos; a velocity or control by
// adding eps times a 0/1 selector, bit-identical to the JAX engine), two K1
// steps run, and (out+ - out-) / (2 eps) fills J[:, c] over the state
// vector's dofs.  The set_interval lerp between slots stays torch
// (solver/lanes.py:jacobians_si); the adaptive methods' per-column lerp is
// kernel K9b (kp_interp.cu).
//
// Slot times: times[s * ts_s + b * ts_b], so one launch takes the
// set_interval times shared by every lane (ts_s 1, ts_b 0) or per-lane
// times (K_max, B) (ts_s B, ts_b 1) with a live count per lane, as the
// adaptive methods' slot plan (K9a) gives them.  A thread whose slot is past
// its lane's count writes zeros and exits: the JAX program computes its
// padding slots, which nothing reads, and at min_N = 1 (K_max = H) a full
// launch would cost as much as set_interval 1.  With `scatter` (the
// iterative_error rounds, JAX solver/lanes.py:_ie_eval_scatter:431) a live
// slot writes its Jacobian into the full-horizon cache (H, 2n, 2n+nu, B) at
// its time and a dead slot writes nothing (JAX mode="drop").
//
// With joint limits each of those steps runs the constraint solve (K2a),
// whose gates and step-length choices are branches: kernel and twin must
// take the same ones, or a flipped branch's jump is divided by 2 eps.  They
// run the same operations in the same order, and on the card the two agree
// bit for bit at panda width with rows active.
//
// Bound: 2 (2n + nu) steps per lane against (2n)(2n + nu) x 8 bytes written;
// K x B lanes (500 x 512 at acrobot SI_1, 1500 x 128 at reaching, 1000 x
// 128 at push_ncl) fill the card, so it is bound by the double-precision
// instruction rate, with local-memory spills from pentabot width up.
#include "instances.cuh"
#include "step.cuh"

namespace trajopt {

template <class T>
__global__ void __launch_bounds__(64)
fd_jacobian_kernel(const double* __restrict__ P,
                   const double* __restrict__ qpos,
                   const double* __restrict__ qvel,
                   const double* __restrict__ U,
                   const long long* __restrict__ times, long long ts_s,
                   long long ts_b, const int* __restrict__ counts,
                   int scatter, double eps, double* __restrict__ J, int K,
                   int B) {
  constexpr int NQ = T::NQ, NV = T::NV, NU = T::NU, NX = T::NX;
  constexpr int NDOF = T::NDOF, NC = T::NX + T::NU;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= K * B) return;
  const int s = idx / B;
  const int b = idx - s * B;
  if (counts != nullptr && s >= counts[b]) {
    if (!scatter) {
      for (int e = 0; e < NX * NC; ++e) J[(size_t(s) * NX * NC + e) * B + b] = 0.0;
    }
    return;
  }
  const size_t t = static_cast<size_t>(times[s * ts_s + b * ts_b]);
  // the output row: the slot, or in the cache the slot's time
  const size_t o = scatter ? t : size_t(s);
  double q0[NQ], v0[NV], u0[NU];
#pragma unroll
  for (int i = 0; i < NQ; ++i) q0[i] = qpos[(t * NQ + i) * B + b];
#pragma unroll
  for (int i = 0; i < NV; ++i) v0[i] = qvel[(t * NV + i) * B + b];
#pragma unroll
  for (int a = 0; a < NU; ++a) u0[a] = U[(t * NU + a) * B + b];
  const double scale = 2.0 * eps;
#pragma unroll 1
  for (int c = 0; c < NC; ++c) {
    // the perturbed position, velocity and control index of column c
    const int dq = c < NDOF ? T::sv(c) : -1;
    const int dv = (c >= NDOF && c < NX) ? T::sv(c - NDOF) : -1;
    const int du = c >= NX ? c - NX : -1;
    double qp[NQ], vp[NV], up[NU], qm[NQ], vm[NV], um[NU];
    double qP[NQ], vP[NV], qM[NQ], vM[NV];
    if constexpr (T::NQ == T::NV) {
      // hinge and slide joints only: q (+) e is q + e
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        qp[i] = q0[i] + (i == dq ? eps : 0.0);
        qm[i] = q0[i] + (i == dq ? -eps : 0.0);
      }
    } else {
      double ep[NV], em[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        ep[i] = i == dq ? eps : 0.0;
        em[i] = i == dq ? -eps : 0.0;
      }
      integrate_pos<T>(q0, ep, 1.0, qp);
      integrate_pos<T>(q0, em, 1.0, qm);
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      vp[i] = v0[i] + (i == dv ? eps : 0.0);
      vm[i] = v0[i] + (i == dv ? -eps : 0.0);
    }
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      up[a] = u0[a] + (a == du ? eps : 0.0);
      um[a] = u0[a] + (a == du ? -eps : 0.0);
    }
    smooth_step<T>(P, qp, vp, up, qP, vP);
    smooth_step<T>(P, qm, vm, um, qM, vM);
#pragma unroll
    for (int r = 0; r < NDOF; ++r) {
      const int iq = T::sv_q(r), iv = T::sv(r);
      J[((o * NX + r) * NC + c) * B + b] = (qP[iq] - qM[iq]) / scale;
      J[((o * NX + NDOF + r) * NC + c) * B + b] =
          (vP[iv] - vM[iv]) / scale;
    }
  }
}

}  // namespace trajopt

#define TRAJOPT_DEFINE_FD(tag, ...)                                            \
  extern "C" int trajopt_fd_jacobian_##tag(                                   \
      const double* P, const double* qpos, const double* qvel,                \
      const double* U, const long long* times, long long ts_s,               \
      long long ts_b, const int* counts, int scatter, double eps, double* J,  \
      int K, int B, void* stream) {                                           \
    using T = trajopt::Topo<__VA_ARGS__>;                                     \
    const int n = K * B;                                                      \
    if (n <= 0) return 0;                                                     \
    trajopt::fd_jacobian_kernel<T><<<(n + 63) / 64, 64, 0,                    \
                                     static_cast<cudaStream_t>(stream)>>>(    \
        P, qpos, qvel, U, times, ts_s, ts_b, counts, scatter, eps, J, K, B);  \
    return static_cast<int>(cudaGetLastError());                              \
  }

TRAJOPT_INSTANCES(TRAJOPT_DEFINE_FD)
TRAJOPT_DEFINE_ERROR_STRING
