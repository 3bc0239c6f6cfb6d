// K4: line-search rollouts, one thread per (alpha, scene).
//
// Replaces the JAX lane forward pass, trajoptkp_tpu/solver/lanes.py:750
// (a scan over H of the lane step with lanes = alphas x scenes).  Plain
// twin: trajoptkp_tpu_torch/solver/ilqr.py:forward_pass_rollouts.
//
// Per lane: u_t = clip(u_nom,t + alpha k_t + K_t dx_t) with dx_t the tangent
// difference of the rolled state from the nominal over the state vector's
// dofs (hinge, slide, free translation: plain differences), then the K3
// body: residual, weighted cost, K1 step.  All
// alphas' trajectories are written; the argmin over alphas and the accept
// test stay torch (solver/lanes.py:forward_pass).
//
// Bound: as K3, latency per thread; A x B lanes fill 48 blocks at acrobot's
// 6 x 512 and 12 at reaching's 6 x 128.  Reading K_t (nu x 2n per step)
// dominates the bytes.
#include "instances.cuh"
#include "residuals.cuh"
#include "step.cuh"

namespace trajopt {

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
      const int iq = T::sv_q(k), iv = T::sv(k);
      dx[k] = q[iq] - qnom[(size_t(t) * NQ + iq) * B + b];
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

}  // namespace trajopt

#define TRAJOPT_DEFINE_LINESEARCH(tag, ...)                                    \
  extern "C" int trajopt_linesearch_##tag(                                    \
      const double* P, const double* W, const double* qnom,                   \
      const double* vnom, const double* U, const double* kff,                 \
      const double* Kfb, const double* alphas, const double* tgt,             \
      double* qpos, double* qvel, double* ctrl, double* costs, int H, int A,  \
      int B, void* stream) {                                                  \
    using T = trajopt::Topo<__VA_ARGS__>;                                     \
    const int n = A * B;                                                      \
    if (n <= 0) return 0;                                                     \
    trajopt::linesearch_kernel<T><<<(n + 63) / 64, 64, 0,                     \
                                    static_cast<cudaStream_t>(stream)>>>(     \
        P, W, qnom, vnom, U, kff, Kfb, alphas, tgt, qpos, qvel, ctrl, costs,  \
        H, A, B);                                                             \
    return static_cast<int>(cudaGetLastError());                              \
  }

TRAJOPT_INSTANCES(TRAJOPT_DEFINE_LINESEARCH)
TRAJOPT_DEFINE_ERROR_STRING
