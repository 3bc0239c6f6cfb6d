// K5ad: exact keypoint-slot Jacobians in forward mode, one thread per
// (slot, column, scene), the scene index fastest.
//
// Replaces the JAX lane slot Jacobians, trajoptkp_tpu/solver/lanes.py:282
// (_slot_jacobians_chunk: jacfwd of the lane step, used by jacobians_si
// :342, jacobians_adaptive :363 and the iterative_error rounds
// _ie_eval_scatter :431), with the constraint solve differentiated
// implicitly at its Newton iterate (K2c, csrc/constraint.cuh:
// implicit_tangent; JAX dynamics/lanes.py:1490, :1309).  Plain twin:
// trajoptkp_tpu_torch/derivs/ad.py:ad_slot_jacobians (and ad_lane_slots).
//
// A thread runs one K1 step (step.cuh) in dual numbers (dual.cuh) seeded
// on its column c of the 2n + nu tangent columns: a position column as
// q (+) dz (integrate_pos at dt 1, which also renormalises a free joint's
// quaternion, as the twin's integrate_pos), a velocity or control column
// as qvel + dz or ctrl + dz.  It writes column c of [A|B]: the tangents of
// the next state's positions and velocities at the state vector's dofs
// (hinge, slide and free-translation dofs, whose tangent-space difference
// is the plain one; a free rotation's, the tangent of the log of the
// nominal next quaternion's conjugate times the dual one, the nominal from
// one more double step of the unperturbed inputs).  Branches and gates
// read the values; the Newton iterations of the constraint solve run on
// the values alone.
//
// Slot times, live counts and the iterative_error cache scatter as K5
// (fd_jacobian.cu): times[s * ts_s + b * ts_b]; a slot past its lane's
// count writes zeros (or, with `scatter`, nothing); with `scatter` a live
// slot writes into the full-horizon cache (H, 2n, 2n+nu, B) at its time.
//
// Rounding: every dual operation computes its tangent with PyTorch's
// forward-mode formula for the same operation (dual.cuh), and the step runs
// the twin's operations in its order (-fmad=false), so that the kernel and
// the twin under torch.autograd.forward_ad agree.
//
// Bound: one dual step per thread (about three times the double operations
// of a step, chip_smoke.py:ad_bound) against (2n) x 8 bytes written per
// thread; bound by the double-precision instruction rate.  The dual state
// doubles the per-thread arrays of the step: the rows of push_ncl and the
// walker live in local memory.
#include "instances.cuh"
#include "step.cuh"

namespace trajopt {

template <class T>
__global__ void __launch_bounds__(64)
ad_jacobian_kernel(const double* __restrict__ P,
                   const double* __restrict__ qpos,
                   const double* __restrict__ qvel,
                   const double* __restrict__ U,
                   const long long* __restrict__ times, long long ts_s,
                   long long ts_b, const int* __restrict__ counts,
                   int scatter, double* __restrict__ J, int K, int B) {
  constexpr int NQ = T::NQ, NV = T::NV, NU = T::NU, NX = T::NX;
  constexpr int NDOF = T::NDOF, NC = T::NX + T::NU;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(K) * NC * B) return;
  const int b = static_cast<int>(idx % B);
  const int sc = static_cast<int>(idx / B);
  const int c = sc % NC;
  const int s = sc / NC;
  if (counts != nullptr && s >= counts[b]) {
    if (!scatter) {
#pragma unroll 1
      for (int r = 0; r < NX; ++r)
        J[((size_t(s) * NX + r) * NC + c) * B + b] = 0.0;
    }
    return;
  }
  const size_t t = static_cast<size_t>(times[s * ts_s + b * ts_b]);
  // the output row: the slot, or in the cache the slot's time
  const size_t o = scatter ? t : size_t(s);
  // the perturbed position, velocity and control index of column c
  const int dq = c < NDOF ? T::sv(c) : -1;
  const int dv = (c >= NDOF && c < NX) ? T::sv(c - NDOF) : -1;
  const int du = c >= NX ? c - NX : -1;
  Dual q0[NQ], ez[NV], q[NQ], v[NV], u[NU], qn[NQ], vn[NV];
#pragma unroll
  for (int i = 0; i < NQ; ++i) q0[i] = Dual(qpos[(t * NQ + i) * B + b]);
#pragma unroll
  for (int i = 0; i < NV; ++i) ez[i] = Dual(0.0, i == dq ? 1.0 : 0.0);
  integrate_pos<T>(q0, ez, 1.0, q);
#pragma unroll
  for (int i = 0; i < NV; ++i)
    v[i] = Dual(qvel[(t * NV + i) * B + b]) +
           Dual(0.0, i == dv ? 1.0 : 0.0);
#pragma unroll
  for (int a = 0; a < NU; ++a)
    u[a] = Dual(U[(t * NU + a) * B + b]) + Dual(0.0, a == du ? 1.0 : 0.0);
  smooth_step<T, false, false, Dual>(P, q, v, u, qn, vn);
  // a free rotation's rows: the tangent of log(conj(q_nom) q'), q_nom the
  // next state of the unperturbed inputs in double (the twin's nominal
  // step, whose quaternion may differ from the dual step's value in its
  // last bits: its input is not renormalised)
  double qnom[T::HAS_ROT ? NQ : 1];
  if constexpr (T::HAS_ROT) {
    double q0d[NQ], v0d[NV], u0d[NU], vnom[NV];
#pragma unroll
    for (int i = 0; i < NQ; ++i) q0d[i] = q0[i].v;
#pragma unroll
    for (int i = 0; i < NV; ++i) v0d[i] = qvel[(t * NV + i) * B + b];
#pragma unroll
    for (int a = 0; a < NU; ++a) u0d[a] = U[(t * NU + a) * B + b];
    smooth_step<T>(P, q0d, v0d, u0d, qnom, vnom);
  }
#pragma unroll
  for (int r = 0; r < NDOF; ++r) {
    double dq;
    if constexpr (T::HAS_ROT) {
      if (T::sv_rot(r) >= 0) {
        Dual lg[3];
        quat_sub(qn + T::sv_quat(r), qnom + T::sv_quat(r), lg);
        dq = lg[T::sv_rot(r)].d;
      } else {
        dq = qn[T::sv_q(r)].d;
      }
    } else {
      dq = qn[T::sv_q(r)].d;
    }
    J[((o * NX + r) * NC + c) * B + b] = dq;
    J[((o * NX + NDOF + r) * NC + c) * B + b] = vn[T::sv(r)].d;
  }
}

}  // namespace trajopt

#define TRAJOPT_DEFINE_AD(tag, ...)                                            \
  extern "C" int trajopt_ad_jacobian_##tag(                                   \
      const double* P, const double* qpos, const double* qvel,                \
      const double* U, const long long* times, long long ts_s,               \
      long long ts_b, const int* counts, int scatter, double* J, int K,       \
      int B, void* stream) {                                                  \
    using T = trajopt::Topo<__VA_ARGS__>;                                     \
    const long long n = static_cast<long long>(K) * (T::NX + T::NU) * B;      \
    if (n <= 0) return 0;                                                     \
    trajopt::ad_jacobian_kernel<T>                                            \
        <<<static_cast<unsigned>((n + 63) / 64), 64, 0,                       \
           static_cast<cudaStream_t>(stream)>>>(P, qpos, qvel, U, times,     \
                                                 ts_s, ts_b, counts, scatter, \
                                                 J, K, B);                    \
    return static_cast<int>(cudaGetLastError());                              \
  }

TRAJOPT_INSTANCES(TRAJOPT_DEFINE_AD)
TRAJOPT_DEFINE_ERROR_STRING
