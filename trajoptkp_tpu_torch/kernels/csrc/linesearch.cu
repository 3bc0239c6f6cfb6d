// K4: line-search rollouts of every (alpha, scene) lane.
//
// Replaces the JAX lane forward pass, trajoptkp_tpu/solver/lanes.py:750
// (a scan over H of the lane step with lanes = alphas x scenes).  Plain
// twin: trajoptkp_tpu_torch/solver/ilqr.py:forward_pass_rollouts.
//
// Per lane: u_t = clip(u_nom,t + alpha k_t + K_t dx_t) with dx_t the tangent
// difference of the rolled state from the nominal over the state vector's
// dofs (hinge, slide, free translation: plain differences; a free
// rotation: the log of the nominal's conjugate times the quaternion,
// geometry.cuh:quat_sub, as the twin's differentiate_pos), then the K3
// body: residual, weighted cost, K1 step.  All alphas' trajectories are
// written; the argmin over alphas and the accept test stay torch
// (solver/lanes.py:forward_pass).
//
// Geometry (kernels/ops.py:linesearch_geometry, checked here): an
// instance with constraint rows runs a warp per lane (linesearch_warp_
// kernel) and the cooperative step of warp_step.cuh, the lanes ordered
// scene-major (lane = b A + a), so the A alphas of a scene sit side by side
// and read their scene's K_t, k_t, U_t and nominal through one SM's L1;
// `lanes` lanes a block, WarpLayout<T>::DOUBLES x 8 bytes of dynamic
// shared memory each (25.1 KB at push_lcl: 6 lanes of one scene take 151
// KB, one block per SM, B = 128 scenes one wave on 132 SMs).  The
// controls' sums run one thread per control, the state difference one
// thread per state dof.  An instance without rows (acrobot) keeps one
// thread per lane in blocks of 64 (linesearch_kernel): its step is ~1.3k
// operations and 6 x 512 lanes fill the card.
//
// Bound (chip_smoke.py:linesearch_bound): H x A x B steps of step_ops
// double operations plus the control law, against the nominal, gains and
// trajectories read and written once; the kernel is bound by the latency
// of one step's dependent chains (warp_step.cuh), which the warp per lane
// shortens from ~NV^3/6 per factorisation to ~NV columns, and no SM takes
// more than a few lanes.
#include "instances.cuh"
#include "residuals.cuh"
#include "step.cuh"
#include "warp_step.cuh"
namespace trajopt {

// lanes a block of the warp-per-lane kernel may hold
constexpr int LS_MAX_LANES = 8;

// one thread per lane (an instance without constraint rows)
template <class T>
__global__ void __launch_bounds__(64)
linesearch_kernel(const double* __restrict__ P, const double* __restrict__ W,
                  const double* __restrict__ qnom,
                  const double* __restrict__ vnom,
                  const double* __restrict__ U, const double* __restrict__ kff,
                  const double* __restrict__ Kfb,
                  const double* __restrict__ alphas,
                  const double* __restrict__ tgt, double* __restrict__ qpos,
                  double* __restrict__ qvel, double* __restrict__ ctrl,
                  double* __restrict__ costs, int H, int A, int B) {
  constexpr int NQ = T::NQ, NV = T::NV, NU = T::NU, NX = T::NX;
  constexpr int NDOF = T::NDOF, NRES = T::NRES, NTGT = T::NTGT;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= A * B) return;
  const int a = idx / B;
  const int b = idx - a * B;
  const double alpha = alphas[a];
  const double* lo = W + 2 * NRES;
  const double* hi = lo + NU;
  const double* resc = hi + NU;  // the residual's constants
  double q[NQ], v[NV], tg[NTGT];
#pragma unroll
  for (int i = 0; i < NQ; ++i) q[i] = qnom[i * B + b];
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = vnom[i * B + b];
#pragma unroll
  for (int r = 0; r < NTGT; ++r) tg[r] = tgt[r * B + b];
  for (int t = 0; t < H; ++t) {
    double dx[NX], u[NU], r[NRES], qn[NQ], vn[NV];
#pragma unroll
    for (int i = 0; i < NQ; ++i)
      qpos[((size_t(t) * NQ + i) * A + a) * B + b] = q[i];
#pragma unroll
    for (int i = 0; i < NV; ++i)
      qvel[((size_t(t) * NV + i) * A + a) * B + b] = v[i];
#pragma unroll
    for (int k = 0; k < NDOF; ++k) {
      const int iv = T::sv(k);
      if (T::sv_rot(k) >= 0) {
        const int qa = T::sv_quat(k);
        double qr[4], lg[3];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          qr[m] = qnom[(size_t(t) * NQ + qa + m) * B + b];
        quat_sub(q + qa, qr, lg);
        dx[k] = lg[T::sv_rot(k)];
      } else {
        const int iq = T::sv_q(k);
        dx[k] = q[iq] - qnom[(size_t(t) * NQ + iq) * B + b];
      }
      dx[NDOF + k] = v[iv] - vnom[(size_t(t) * NV + iv) * B + b];
    }
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      const size_t tc = size_t(t) * NU + c;
      double fb = 0.0;
#pragma unroll
      for (int j = 0; j < NX; ++j) fb += Kfb[(tc * NX + j) * B + b] * dx[j];
      u[c] = clip(U[tc * B + b] + alpha * kff[tc * B + b] + fb, lo[c], hi[c]);
      ctrl[(tc * A + a) * B + b] = u[c];
    }
    residual_and_step<T>(P, q, v, u, tg, resc, r, qn, vn);
    costs[(size_t(t) * A + a) * B + b] =
        weighted_cost<NRES>(r, t == H - 1 ? W + NRES : W);
#pragma unroll
    for (int i = 0; i < NQ; ++i) q[i] = qn[i];
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] = vn[i];
  }
#pragma unroll
  for (int i = 0; i < NQ; ++i)
    qpos[((size_t(H) * NQ + i) * A + a) * B + b] = q[i];
#pragma unroll
  for (int i = 0; i < NV; ++i)
    qvel[((size_t(H) * NV + i) * A + a) * B + b] = v[i];
}


// a warp per lane, `lanes` lanes a block, the lane's arrays in the block's
// dynamic shared memory (WarpLayout)
template <class T>
__global__ void __launch_bounds__(WARP* LS_MAX_LANES)
linesearch_warp_kernel(const double* __restrict__ P,
                       const double* __restrict__ W,
                       const double* __restrict__ qnom,
                       const double* __restrict__ vnom,
                       const double* __restrict__ U,
                       const double* __restrict__ kff,
                       const double* __restrict__ Kfb,
                       const double* __restrict__ alphas,
                       const double* __restrict__ tgt,
                       double* __restrict__ qpos, double* __restrict__ qvel,
                       double* __restrict__ ctrl, double* __restrict__ costs,
                       int H, int A, int B, int lanes) {
  constexpr int NQ = T::NQ, NV = T::NV, NU = T::NU, NX = T::NX;
  constexpr int NDOF = T::NDOF, NRES = T::NRES, NTGT = T::NTGT;
  using LY = WarpLayout<T>;
  extern __shared__ double smem[];
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int L = blockIdx.x * lanes + warp;
  warp_tables_load<T>();
  if (L >= A * B) return;
  const int b = L / A;
  const int a = L - b * A;
  double* sm = smem + size_t(warp) * LY::DOUBLES;
  double* q = sm + LY::Q;
  double* v = sm + LY::V;
  double* u = sm + LY::U;
  double* dx = sm + LY::DXS;
  const double alpha = alphas[a];
  const double* lo = W + 2 * NRES;
  const double* hi = lo + NU;
  const double* resc = hi + NU;  // the residual's constants
  for (int i = lane; i < NQ; i += WARP) q[i] = qnom[i * B + b];
  for (int i = lane; i < NV; i += WARP) v[i] = vnom[i * B + b];
  for (int r = lane; r < NTGT; r += WARP) sm[LY::TG + r] = tgt[r * B + b];
  __syncwarp();
#pragma unroll 1
  for (int t = 0; t < H; ++t) {
    WARP_MARK_START();
    for (int i = lane; i < NQ; i += WARP)
      qpos[((size_t(t) * NQ + i) * A + a) * B + b] = q[i];
    for (int i = lane; i < NV; i += WARP)
      qvel[((size_t(t) * NV + i) * A + a) * B + b] = v[i];
#pragma unroll 1
    for (int k = lane; k < NDOF; k += WARP) {
      const int iv = T::sv(k);
      if (T::HAS_ROT && T::sv_rot(k) >= 0) {
        const int qa = T::sv_quat(k);
        double qr[4], lg[3];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          qr[m] = qnom[(size_t(t) * NQ + qa + m) * B + b];
        quat_sub(q + qa, qr, lg);
        dx[k] = lg[T::sv_rot(k)];
      } else {
        const int iq = T::sv_q(k);
        dx[k] = q[iq] - qnom[(size_t(t) * NQ + iq) * B + b];
      }
      dx[NDOF + k] = v[iv] - vnom[(size_t(t) * NV + iv) * B + b];
    }
    __syncwarp();
#pragma unroll 1
    for (int c = lane; c < NU; c += WARP) {
      const size_t tc = size_t(t) * NU + c;
      double fb = 0.0;
#pragma unroll
      for (int j = 0; j < NX; ++j) fb += Kfb[(tc * NX + j) * B + b] * dx[j];
      const double uc =
          clip(U[tc * B + b] + alpha * kff[tc * B + b] + fb, lo[c], hi[c]);
      u[c] = uc;
      ctrl[(tc * A + a) * B + b] = uc;
    }
    __syncwarp();
    WARP_MARK(0);
    warp_step<T, true>(P, sm, resc, lane);
    if (lane == 0)
      costs[(size_t(t) * A + a) * B + b] =
          weighted_cost<NRES>(sm + LY::RES, t == H - 1 ? W + NRES : W);
  }
  for (int i = lane; i < NQ; i += WARP)
    qpos[((size_t(H) * NQ + i) * A + a) * B + b] = q[i];
  for (int i = lane; i < NV; i += WARP)
    qvel[((size_t(H) * NV + i) * A + a) * B + b] = v[i];
}

}  // namespace trajopt

// The C entry: `threads` a block, `lanes` lanes a block and `smem` bytes
// of dynamic shared memory (kernels/ops.py:linesearch_geometry); a
// geometry the instance's kernel does not run is refused
// (cudaErrorInvalidValue): 64 threads, 64 lanes and no shared memory
// without constraint rows, else 32 threads a lane, 1..LS_MAX_LANES lanes
// and WarpLayout<T>::DOUBLES x 8 bytes a lane.
#define TRAJOPT_DEFINE_LINESEARCH(tag, ...)                                    \
  extern "C" int trajopt_linesearch_##tag(                                    \
      const double* P, const double* W, const double* qnom,                   \
      const double* vnom, const double* U, const double* kff,                 \
      const double* Kfb, const double* alphas, const double* tgt,             \
      double* qpos, double* qvel, double* ctrl, double* costs, int H, int A,  \
      int B, int threads, int lanes, int smem, void* stream) {                \
    using T = trajopt::Topo<__VA_ARGS__>;                                     \
    const int n = A * B;                                                      \
    const cudaStream_t st = static_cast<cudaStream_t>(stream);                \
    if constexpr (T::R == 0) {                                                \
      if (threads != 64 || lanes != 64 || smem != 0)                          \
        return static_cast<int>(cudaErrorInvalidValue);                       \
      if (n <= 0) return 0;                                                   \
      trajopt::linesearch_kernel<T><<<(n + 63) / 64, 64, 0, st>>>(            \
          P, W, qnom, vnom, U, kff, Kfb, alphas, tgt, qpos, qvel, ctrl,       \
          costs, H, A, B);                                                    \
    } else {                                                                  \
      constexpr int per_lane = trajopt::WarpLayout<T>::DOUBLES * 8;           \
      if (lanes < 1 || lanes > trajopt::LS_MAX_LANES ||                       \
          threads != trajopt::WARP * lanes || smem != per_lane * lanes)       \
        return static_cast<int>(cudaErrorInvalidValue);                      \
      if (n <= 0) return 0;                                                   \
      if (smem > 48 * 1024) {                                                 \
        const cudaError_t e = cudaFuncSetAttribute(                           \
            trajopt::linesearch_warp_kernel<T>,                               \
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);               \
        if (e != cudaSuccess) return static_cast<int>(e);                     \
      }                                                                       \
      trajopt::linesearch_warp_kernel<T>                                      \
          <<<(n + lanes - 1) / lanes, threads, smem, st>>>(                   \
              P, W, qnom, vnom, U, kff, Kfb, alphas, tgt, qpos, qvel, ctrl,   \
              costs, H, A, B, lanes);                                         \
    }                                                                         \
    return static_cast<int>(cudaGetLastError());                              \
  }

TRAJOPT_INSTANCES(TRAJOPT_DEFINE_LINESEARCH)

#ifdef TRAJOPT_WARP_MARKS
// copies out and zeroes the phase marks of warp_step.cuh
extern "C" int trajopt_warp_marks_read(unsigned long long* out) {
  const unsigned long long zero[16] = {};
  cudaMemcpyFromSymbol(out, trajopt::trajopt_warp_marks, sizeof(zero));
  cudaMemcpyToSymbol(trajopt::trajopt_warp_marks, zero, sizeof(zero));
  return static_cast<int>(cudaGetLastError());
}
#endif
TRAJOPT_DEFINE_ERROR_STRING
