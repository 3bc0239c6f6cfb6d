// K5ad: exact keypoint-slot Jacobians in forward mode, in two passes: the
// primal values once per (slot, scene), then one thread per (slot, column,
// scene), the scene index fastest, for the tangents.
//
// Replaces the JAX lane slot Jacobians, trajoptkp_tpu/solver/lanes.py:282
// (_slot_jacobians_chunk: jacfwd of the lane step, used by jacobians_si
// :342, jacobians_adaptive :363 and the iterative_error rounds
// _ie_eval_scatter :431), with the constraint solve differentiated
// implicitly at its Newton iterate (K2c, csrc/constraint.cuh:
// implicit_tangent; JAX dynamics/lanes.py:1490, :1309).  Plain twin:
// trajoptkp_tpu_torch/derivs/ad.py:ad_slot_jacobians (and ad_lane_slots).
//
// The primal pass (ad_primal_kernel, one thread per live (slot, scene))
// runs the step's values up to the constraint rows in double and writes
// what every column of the slot shares (constraint.cuh:AdLayout): the
// Newton iterate of the constraint solve, the Cholesky factor of K2c's
// gated Hessian at it, and, with a free rotation in the state, the nominal
// next positions from one more double step of the unperturbed inputs (the
// twin's nominal step, whose input is not renormalised).  The dual step's
// input q is q0 (+) 0, renormalised (integrate_pos at dt 1), and its
// velocity and control carry + 0.0, so the primal pass steps those values:
// each dual operation's value is the double operation, so the numbers are
// the dual step's own.
//
// The tangent pass (ad_jacobian_kernel) runs one K1 step (step.cuh) in
// dual numbers (dual.cuh) seeded on its column c of the 2n + nu tangent
// columns: a position column as q (+) dz (integrate_pos at dt 1), a
// velocity or control column as qvel + dz or ctrl + dz, with the Newton
// iterations and the gated Hessian's factor read from the primal pass
// (constraint_solve given the buffer).  It writes column c of [A|B]: the
// tangents of the next state's positions and velocities at the state
// vector's dofs
// (hinge, slide and free-translation dofs, whose tangent-space difference
// is the plain one; a free rotation's, the tangent of the log of the
// nominal next quaternion's conjugate times the dual one).  Branches and
// gates read the values.
//
// Slot times, live counts and the iterative_error cache scatter as K5
// (fd_jacobian.cu): times[s * ts_s + b * ts_b]; a slot past its lane's
// count writes zeros (or, with `scatter`, nothing) and has no primal pass;
// with `scatter` a live slot writes into the full-horizon cache (H, 2n,
// 2n+nu, B) at its time.  The primal buffer (slot, entry, scene) holds
// `chunk` slots, and the C entry runs both passes per chunk of slots.  The
// tangent pass is a programmatic dependent launch: it starts while the
// primal pass runs, steps its dual FK, RNE, mass matrix, rows and a0
// meanwhile, and waits for the primal pass only where it first reads the
// buffer (constraint.cuh:wait_for_primal), so where neither pass fills the
// card (the walker's B=1 replan) the primal's chain overlaps the tangents'
// instead of preceding it.  A model with neither constraint rows nor a
// free rotation (acrobot) has nothing to share: one pass, no buffer.
//
// Rounding: every dual operation computes its tangent with PyTorch's
// forward-mode formula for the same operation (dual.cuh), and the step runs
// the twin's operations in its order (-fmad=false), so that the kernel and
// the twin under torch.autograd.forward_ad agree.
//
// Bound: chip_smoke.py:ad_bound counts per (slot, scene) the primal step
// and K2c's values once (twice the step with a free rotation) and per
// column the tangents of every operation outside the Newton iterations and
// K2c's column solve, against the state read and [A|B] written: bound by
// the double-precision rate.  The primal pass does the once-per-slot part
// once, where a thread per column would repeat it 2n + nu times (3-6x a
// column's work at push_ncl, push_lcl and box_sweep).  The primal buffer
// costs (NV + NV (NV + 1) / 2 [+ NQ]) x 8 bytes per (slot, scene), written
// once and read by every column (the scene index fastest: coalesced).  The dual state doubles the per-thread
// arrays of the step: the rows of push_ncl and the walker live in local
// memory.  No shared memory.
#include "instances.cuh"
#include "step.cuh"

namespace trajopt {

// the primal pass: one thread per (slot, scene) of the chunk from slot s0
template <class T>
__global__ void __launch_bounds__(64)
ad_primal_kernel(const double* __restrict__ P,
                 const double* __restrict__ qpos,
                 const double* __restrict__ qvel,
                 const double* __restrict__ U,
                 const long long* __restrict__ times, long long ts_s,
                 long long ts_b, const int* __restrict__ counts,
                 double* __restrict__ prim, int s0, int n, int B) {
  constexpr int NQ = T::NQ, NV = T::NV, NU = T::NU;
  primal_release_tangents();
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(n) * B) return;
  const int b = static_cast<int>(idx % B);
  const int sl = static_cast<int>(idx / B);
  const int s = s0 + sl;
  if (counts != nullptr && s >= counts[b]) return;
  const size_t t = static_cast<size_t>(times[s * ts_s + b * ts_b]);
  const AdPrimalBuf ad{prim + size_t(sl) * AdLayout<T>::ENTRIES * B + b, B};
  double q0[NQ], v0[NV], u0[NU];
#pragma unroll
  for (int i = 0; i < NQ; ++i) q0[i] = qpos[(t * NQ + i) * B + b];
#pragma unroll
  for (int i = 0; i < NV; ++i) v0[i] = qvel[(t * NV + i) * B + b];
#pragma unroll
  for (int a = 0; a < NU; ++a) u0[a] = U[(t * NU + a) * B + b];
  if constexpr (T::R > 0) {
    // the values of the dual step's inputs (ad_jacobian_kernel)
    double z[NV], q[NQ], v[NV], u[NU];
#pragma unroll
    for (int i = 0; i < NV; ++i) z[i] = 0.0;
    integrate_pos<T>(q0, z, 1.0, q);
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] = v0[i] + 0.0;
#pragma unroll
    for (int a = 0; a < NU; ++a) u[a] = u0[a] + 0.0;
    smooth_step<T, false, false, double, true>(
        P, q, v, u, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
        &ad);
  }
  if constexpr (T::HAS_ROT) {
    double qn[NQ], vn[NV];
    smooth_step<T>(P, q0, v0, u0, qn, vn);
#pragma unroll
    for (int i = 0; i < NQ; ++i)
      ad.p[(AdLayout<T>::QN + i) * ad.stride] = qn[i];
  }
}

// the tangent pass: one thread per (slot, column, scene) of the chunk,
// reading the primal buffer `prim` of the chunk's slots (none where
// AdLayout<T>::ENTRIES is 0)
template <class T>
__global__ void __launch_bounds__(64)
ad_jacobian_kernel(const double* __restrict__ P,
                   const double* __restrict__ qpos,
                   const double* __restrict__ qvel,
                   const double* __restrict__ U,
                   const long long* __restrict__ times, long long ts_s,
                   long long ts_b, const int* __restrict__ counts,
                   int scatter, const double* __restrict__ prim,
                   double* __restrict__ J, int s0, int n, int B) {
  constexpr int NQ = T::NQ, NV = T::NV, NU = T::NU, NX = T::NX;
  constexpr int NDOF = T::NDOF, NC = T::NX + T::NU;
  constexpr int E = AdLayout<T>::ENTRIES;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(n) * NC * B) return;
  const int b = static_cast<int>(idx % B);
  const int sc = static_cast<int>(idx / B);
  const int c = sc % NC;
  const int sl = sc / NC;
  const int s = s0 + sl;
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
  const AdPrimalBuf ad{E > 0 ? const_cast<double*>(prim) +
                                   size_t(sl) * E * B + b
                             : nullptr,
                       B};
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
  smooth_step<T, false, false, Dual>(P, q, v, u, qn, vn, nullptr, nullptr,
                                     nullptr, nullptr, &ad);
  // a free rotation's rows: the tangent of log(conj(q_nom) q'), q_nom the
  // primal pass's next state of the unperturbed inputs (the twin's nominal
  // step, whose input is not renormalised)
  if constexpr (T::HAS_ROT) wait_for_primal();
#pragma unroll
  for (int r = 0; r < NDOF; ++r) {
    double dq;
    if constexpr (T::HAS_ROT) {
      if (T::sv_rot(r) >= 0) {
        double qr[4];
        Dual lg[3];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          qr[m] = ad.p[(AdLayout<T>::QN + T::sv_quat(r) + m) * ad.stride];
        quat_sub(qn + T::sv_quat(r), qr, lg);
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

// The C entry: both passes per chunk of `chunk` slots (at least one) into
// the primal buffer `prim` (chunk x AdLayout<T>::ENTRIES x B doubles), the
// tangent pass launched as the primal pass's programmatic dependent; where
// AdLayout<T>::ENTRIES is 0, one pass over all K slots and no buffer.
// `entries` must be AdLayout<T>::ENTRIES (kernels/ops.py:
// ad_primal_entries), else it refuses (cudaErrorInvalidValue).
template <class T>
int ad_jacobian_entry(const double* P, const double* qpos,
                      const double* qvel, const double* U,
                      const long long* times, long long ts_s, long long ts_b,
                      const int* counts, int scatter, double* prim,
                      int entries, int chunk, double* J, int K, int B,
                      cudaStream_t st) {
  constexpr int NC = T::NX + T::NU;
  constexpr int E = AdLayout<T>::ENTRIES;
  if (entries != E || (E > 0 && (chunk < 1 || prim == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (K <= 0 || B <= 0) return 0;
  if constexpr (E == 0) {
    const long long nt = static_cast<long long>(K) * NC * B;
    ad_jacobian_kernel<T><<<static_cast<unsigned>((nt + 63) / 64), 64, 0,
                            st>>>(P, qpos, qvel, U, times, ts_s, ts_b,
                                  counts, scatter, nullptr, J, 0, K, B);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute early[1];
  early[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early[0].val.programmaticStreamSerializationAllowed = 1;
  for (int s0 = 0; s0 < K; s0 += chunk) {
    const int n = K - s0 < chunk ? K - s0 : chunk;
    const long long np = static_cast<long long>(n) * B;
    ad_primal_kernel<T><<<static_cast<unsigned>((np + 63) / 64), 64, 0,
                          st>>>(P, qpos, qvel, U, times, ts_s, ts_b, counts,
                                prim, s0, n, B);
    const long long nt = static_cast<long long>(n) * NC * B;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>((nt + 63) / 64));
    cfg.blockDim = dim3(64);
    cfg.stream = st;
    cfg.attrs = early;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, ad_jacobian_kernel<T>, P, qpos, qvel, U, times, ts_s, ts_b,
        counts, scatter, static_cast<const double*>(prim), J, s0, n, B);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace trajopt

#define TRAJOPT_DEFINE_AD(tag, ...)                                            \
  extern "C" int trajopt_ad_jacobian_##tag(                                   \
      const double* P, const double* qpos, const double* qvel,                \
      const double* U, const long long* times, long long ts_s,               \
      long long ts_b, const int* counts, int scatter, double* prim,           \
      int entries, int chunk, double* J, int K, int B, void* stream) {        \
    return trajopt::ad_jacobian_entry<trajopt::Topo<__VA_ARGS__>>(            \
        P, qpos, qvel, U, times, ts_s, ts_b, counts, scatter, prim, entries,  \
        chunk, J, K, B, static_cast<cudaStream_t>(stream));                   \
  }

TRAJOPT_INSTANCES(TRAJOPT_DEFINE_AD)
TRAJOPT_DEFINE_ERROR_STRING
