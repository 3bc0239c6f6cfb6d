// K5: keypoint-slot Jacobians by central FD, the columns in parallel: an
// item is one (slot, column, scene), ordered with the scene fastest (item
// n = (s NC + c) B + b), so the warps of a block read one slot's nominal
// through the same L1 lines.
//
// Replaces the JAX lane slot Jacobians, trajoptkp_tpu/solver/lanes.py:282
// (_slot_jacobians_chunk, jacfwd of the lane step, used by jacobians_si
// :342).  The port keeps the reference's own semantics instead: central
// differences with eps = 1e-6 in double precision over all 2n + nu tangent
// columns (trajoptkp_tpu/derivs/fd.py:83 fd_job_columns).  Plain twin:
// trajoptkp_tpu_torch/derivs/fd.py:fd_slot_jacobians.
//
// Per item: the state or control of column c is perturbed by +-eps (a
// position as q (+) e with integrate_pos at dt 1, which also renormalises a
// free joint's quaternion, as the twin's integrate_pos; a velocity or
// control by adding eps times a 0/1 selector, q left as it is,
// bit-identical to the JAX engine), two K1 steps run, and (out+ - out-) /
// (2 eps) fills J[:, c] over the state vector's dofs (a free rotation's
// rows: the log of conj(q-) q+).  The set_interval lerp between slots
// stays torch (solver/lanes.py:jacobians_si); the adaptive methods'
// per-column lerp is kernel K9b (kp_interp.cu).
//
// Geometry (kernels/ops.py:fd_geometry, checked here): an instance with
// constraint rows runs a warp per item (fd_warp_kernel) over the
// cooperative step of warp_step.cuh without the residual: thread 0 forms
// the perturbation where it takes integrate_pos (every other entry is an
// elementwise sum, one thread each), the warp steps the plus and then the
// minus inputs, and one thread per state dof writes the column's two
// entries; `lanes` items a block, WarpLayout<T>::FD_DOUBLES x 8 bytes of
// dynamic shared memory each (the plus step's q and v beside the lane).
// An instance without rows (acrobot) runs a thread per item in blocks of
// 64 (fd_thread_kernel).  The one-thread kernel, at every instance, is
// the reference the warp kernel is held to bit for bit on the host
// (tests/test_torch_step_layout.py).
//
// Slot times: times[s * ts_s + b * ts_b], so one launch takes the
// set_interval times shared by every lane (ts_s 1, ts_b 0) or per-lane
// times (K_max, B) (ts_s B, ts_b 1) with a live count per lane, as the
// adaptive methods' slot plan (K9a) gives them.  An item whose slot is past
// its lane's count writes zeros in its column and exits: the JAX program
// computes its padding slots, which nothing reads, and at min_N = 1 (K_max
// = H) a full launch would cost as much as set_interval 1.  With `scatter`
// (the iterative_error rounds, JAX solver/lanes.py:_ie_eval_scatter:431) a
// live slot writes its Jacobian into the full-horizon cache (H, 2n, 2n+nu,
// B) at its time and a dead slot writes nothing (JAX mode="drop").
//
// With joint limits each of those steps runs the constraint solve (K2a),
// whose gates and step-length choices are branches: kernel and twin must
// take the same ones, or a flipped branch's jump is divided by 2 eps.  They
// run the same operations in the same order (the cooperative step keeps
// every sum in the one-thread order), and agree bit for bit.
//
// Bound: 2 (2n + nu) steps per (slot, lane) against (2n)(2n + nu) x 8
// bytes written.  The CLI's generic solve and the async planner run K5 at
// B = 1, where the items (K (2n + nu): 1350 at the async push_ncl planner)
// are the only parallelism and a step's latency decides the time; the
// warp step's chains are ~NV long per factorisation where one thread's
// are ~NV^3/6.
#include "instances.cuh"
#include "step.cuh"
#include "warp_step.cuh"

namespace trajopt {

// items a block of the warp-per-item kernel may hold
constexpr int FD_MAX_LANES = 8;

// item n -> (slot, column, scene), the scene fastest
struct FdItem {
  int s, c, b;
};

template <class T>
__device__ __forceinline__ FdItem fd_item(long long n, int B) {
  constexpr int NC = T::NX + T::NU;
  const int b = static_cast<int>(n % B);
  const long long m = n / B;
  return FdItem{static_cast<int>(m / NC), static_cast<int>(m % NC), b};
}

// the column's perturbed position, velocity and control index (-1: none)
template <class T>
struct FdColumn {
  int dq, dv, du;
  __device__ explicit FdColumn(int c)
      : dq(c < T::NDOF ? T::sv(c) : -1),
        dv((c >= T::NDOF && c < T::NX) ? T::sv(c - T::NDOF) : -1),
        du(c >= T::NX ? c - T::NX : -1) {}
};

// one thread per item (an instance without constraint rows; on the host
// the reference of the warp kernel at every instance)
template <class T>
__global__ void __launch_bounds__(64)
fd_thread_kernel(const double* __restrict__ P,
                 const double* __restrict__ qpos,
                 const double* __restrict__ qvel,
                 const double* __restrict__ U,
                 const long long* __restrict__ times, long long ts_s,
                 long long ts_b, const int* __restrict__ counts, int scatter,
                 double eps, double* __restrict__ J, int K, int B) {
  constexpr int NQ = T::NQ, NV = T::NV, NU = T::NU, NX = T::NX;
  constexpr int NDOF = T::NDOF, NC = T::NX + T::NU;
  const long long n = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (n >= static_cast<long long>(K) * NC * B) return;
  const FdItem it = fd_item<T>(n, B);
  const int s = it.s, c = it.c, b = it.b;
  if (counts != nullptr && s >= counts[b]) {
    if (!scatter) {
      for (int r = 0; r < NX; ++r)
        J[((size_t(s) * NX + r) * NC + c) * B + b] = 0.0;
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
  const FdColumn<T> col(c);
  double qp[NQ], vp[NV], up[NU], qm[NQ], vm[NV], um[NU];
  double qP[NQ], vP[NV], qM[NQ], vM[NV];
  if constexpr (T::NQ == T::NV) {
    // hinge and slide joints only: q (+) e is q + e
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      qp[i] = q0[i] + (i == col.dq ? eps : 0.0);
      qm[i] = q0[i] + (i == col.dq ? -eps : 0.0);
    }
  } else if (col.dq >= 0) {
    double ep[NV], em[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      ep[i] = i == col.dq ? eps : 0.0;
      em[i] = i == col.dq ? -eps : 0.0;
    }
    integrate_pos<T>(q0, ep, 1.0, qp);
    integrate_pos<T>(q0, em, 1.0, qm);
  } else {
    // a velocity or control column keeps q as it is, as the twin does: q
    // (+) 0 would renormalise a free joint's quaternion, whose last bits
    // then reach its rows
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      qp[i] = q0[i];
      qm[i] = q0[i];
    }
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    vp[i] = v0[i] + (i == col.dv ? eps : 0.0);
    vm[i] = v0[i] + (i == col.dv ? -eps : 0.0);
  }
#pragma unroll
  for (int a = 0; a < NU; ++a) {
    up[a] = u0[a] + (a == col.du ? eps : 0.0);
    um[a] = u0[a] + (a == col.du ? -eps : 0.0);
  }
  smooth_step<T>(P, qp, vp, up, qP, vP);
  smooth_step<T>(P, qm, vm, um, qM, vM);
#pragma unroll
  for (int r = 0; r < NDOF; ++r) {
    const int iv = T::sv(r);
    double dq;
    if (T::sv_rot(r) >= 0) {
      // a free rotation's row: the log of conj(q-) q+ (differentiate_pos)
      double lg[3];
      quat_sub(qP + T::sv_quat(r), qM + T::sv_quat(r), lg);
      dq = lg[T::sv_rot(r)];
    } else {
      dq = qP[T::sv_q(r)] - qM[T::sv_q(r)];
    }
    J[((o * NX + r) * NC + c) * B + b] = dq / scale;
    J[((o * NX + NDOF + r) * NC + c) * B + b] = (vP[iv] - vM[iv]) / scale;
  }
}

// a warp per item over the cooperative step, `lanes` items a block, each
// item's arrays in the block's dynamic shared memory (WarpLayout, with
// FD_DOUBLES a lane)
template <class T>
__global__ void __launch_bounds__(WARP* FD_MAX_LANES)
fd_warp_kernel(const double* __restrict__ P, const double* __restrict__ qpos,
               const double* __restrict__ qvel, const double* __restrict__ U,
               const long long* __restrict__ times, long long ts_s,
               long long ts_b, const int* __restrict__ counts, int scatter,
               double eps, double* __restrict__ J, int K, int B, int lanes) {
  constexpr int NQ = T::NQ, NV = T::NV, NU = T::NU, NX = T::NX;
  constexpr int NDOF = T::NDOF, NC = T::NX + T::NU;
  using LY = WarpLayout<T>;
  extern __shared__ double smem[];
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const long long n = static_cast<long long>(blockIdx.x) * lanes + warp;
  warp_tables_load<T>();
  if (n >= static_cast<long long>(K) * NC * B) return;
  const FdItem it = fd_item<T>(n, B);
  const int s = it.s, c = it.c, b = it.b;
  if (counts != nullptr && s >= counts[b]) {
    if (!scatter) {
      for (int r = lane; r < NX; r += WARP)
        J[((size_t(s) * NX + r) * NC + c) * B + b] = 0.0;
    }
    return;
  }
  const size_t t = static_cast<size_t>(times[s * ts_s + b * ts_b]);
  const size_t o = scatter ? t : size_t(s);
  double* sm = smem + size_t(warp) * LY::FD_DOUBLES;
  double* q = sm + LY::Q;
  double* v = sm + LY::V;
  double* u = sm + LY::U;
  double* qP = sm + LY::FDP;
  double* vP = qP + NQ;
  const FdColumn<T> col(c);
#pragma unroll 1
  for (int side = 0; side < 2; ++side) {
    const double e = side == 0 ? eps : -eps;
    // the nominal and the column's perturbation, as fd_thread_kernel forms
    // them: elementwise one entry a thread, integrate_pos on thread 0
    for (int i = lane; i < NQ; i += WARP) {
      const double qi = qpos[(t * NQ + i) * B + b];
      q[i] = T::NQ == T::NV ? qi + (i == col.dq ? e : 0.0) : qi;
    }
    for (int i = lane; i < NV; i += WARP)
      v[i] = qvel[(t * NV + i) * B + b] + (i == col.dv ? e : 0.0);
    for (int a = lane; a < NU; a += WARP)
      u[a] = U[(t * NU + a) * B + b] + (a == col.du ? e : 0.0);
    if constexpr (T::NQ != T::NV) {
      if (col.dq >= 0) {
        __syncwarp();
        if (lane == 0) {
          double ev[NV];
#pragma unroll
          for (int i = 0; i < NV; ++i) ev[i] = i == col.dq ? e : 0.0;
          integrate_pos<T>(q, ev, 1.0, q);
        }
      }
    }
    __syncwarp();
    warp_step<T, false>(P, sm, nullptr, lane);
    if (side == 0) {
      for (int i = lane; i < NQ; i += WARP) qP[i] = q[i];
      for (int i = lane; i < NV; i += WARP) vP[i] = v[i];
      __syncwarp();
    }
  }
  const double scale = 2.0 * eps;
  // the column's rows, one thread per state dof (a free rotation's log on
  // its thread)
#pragma unroll 1
  for (int r = lane; r < NDOF; r += WARP) {
    const int iv = T::sv(r);
    double dq;
    if (T::HAS_ROT && T::sv_rot(r) >= 0) {
      double lg[3];
      quat_sub(qP + T::sv_quat(r), q + T::sv_quat(r), lg);
      dq = lg[T::sv_rot(r)];
    } else {
      dq = qP[T::sv_q(r)] - q[T::sv_q(r)];
    }
    J[((o * NX + r) * NC + c) * B + b] = dq / scale;
    J[((o * NX + NDOF + r) * NC + c) * B + b] = (vP[iv] - v[iv]) / scale;
  }
}

}  // namespace trajopt

// The C entry: `threads` a block, `lanes` items a block and `smem` bytes of
// dynamic shared memory (kernels/ops.py:fd_geometry); a geometry the
// instance's kernel does not run is refused (cudaErrorInvalidValue): 64
// threads, 64 items and no shared memory without constraint rows, else 32
// threads an item, 1..FD_MAX_LANES items and WarpLayout<T>::FD_DOUBLES x 8
// bytes an item.
#define TRAJOPT_DEFINE_FD(tag, ...)                                            \
  extern "C" int trajopt_fd_jacobian_##tag(                                   \
      const double* P, const double* qpos, const double* qvel,                \
      const double* U, const long long* times, long long ts_s,                \
      long long ts_b, const int* counts, int scatter, double eps, double* J,  \
      int K, int B, int threads, int lanes, int smem, void* stream) {         \
    using T = trajopt::Topo<__VA_ARGS__>;                                     \
    const long long n = static_cast<long long>(K) * (T::NX + T::NU) * B;      \
    const cudaStream_t st = static_cast<cudaStream_t>(stream);                \
    if constexpr (T::R == 0) {                                                \
      if (threads != 64 || lanes != 64 || smem != 0)                          \
        return static_cast<int>(cudaErrorInvalidValue);                       \
      if (n <= 0) return 0;                                                   \
      trajopt::fd_thread_kernel<T>                                            \
          <<<static_cast<unsigned>((n + 63) / 64), 64, 0, st>>>(              \
              P, qpos, qvel, U, times, ts_s, ts_b, counts, scatter, eps, J,   \
              K, B);                                                          \
    } else {                                                                  \
      constexpr int per_lane = trajopt::WarpLayout<T>::FD_DOUBLES * 8;        \
      if (lanes < 1 || lanes > trajopt::FD_MAX_LANES ||                       \
          threads != trajopt::WARP * lanes || smem != per_lane * lanes)       \
        return static_cast<int>(cudaErrorInvalidValue);                       \
      if (n <= 0) return 0;                                                   \
      /* past 48 KB with the static tables: opt in */                         \
      if (smem + static_cast<int>(sizeof(trajopt::WarpTables<T>)) >           \
          48 * 1024) {                                                        \
        const cudaError_t e = cudaFuncSetAttribute(                           \
            trajopt::fd_warp_kernel<T>,                                       \
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);               \
        if (e != cudaSuccess) return static_cast<int>(e);                     \
      }                                                                       \
      trajopt::fd_warp_kernel<T>                                              \
          <<<static_cast<unsigned>((n + lanes - 1) / lanes), threads, smem,   \
             st>>>(P, qpos, qvel, U, times, ts_s, ts_b, counts, scatter, eps, \
                   J, K, B, lanes);                                           \
    }                                                                         \
    return static_cast<int>(cudaGetLastError());                              \
  }

TRAJOPT_INSTANCES(TRAJOPT_DEFINE_FD)
TRAJOPT_DEFINE_ERROR_STRING
