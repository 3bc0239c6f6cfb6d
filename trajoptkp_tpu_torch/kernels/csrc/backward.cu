// K7: Riccati backward pass with the λ retry, one thread per scene.
//
// Replaces the JAX lane backward pass and λ loop,
// trajoptkp_tpu/solver/lanes.py:632-746 (backward_pass, bp_lambda_loop).
// Plain twin: trajoptkp_tpu_torch/solver/ilqr.py:backward_pass_lambda_loop.
//
// Per lane, for t = H-1 .. 0: the Q blocks from [A|B]^T V and
// [A|B]^T V_xx [A|B], an unrolled nu x nu Cholesky of Q_uu + λ I, the gains
// k = -Q_uu^-1 Q_u and K = -Q_uu^-1 Q_ux, the symmetrised V update and ΔJ.
// The λ retry runs per lane with the generic semantics of
// trajoptkp_tpu/solver/ilqr.py:380: a lane sweeps again only while its own
// gains are not finite (the JAX lane solver reruns every lane while any lane
// is invalid, a difference held by tests/test_torch_ilqr.py and logged in
// ROADMAP Queue 3).
//
// Bound: ~H (2n)^2 (2n + nu) x 4 double operations per lane against the
// (2n)(3n + nu) + (nu)(nu + 1) + ... x 8 bytes of A, B and the cost terms it
// reads once per sweep: bytes-light and latency-bound per thread; V_xx and
// the Q blocks live in local memory from pentabot width up (a 14 KB stack
// frame at reaching's nx 14, nu 7, whose fully unrolled sweep also takes
// nvcc about a minute to compile).
#include "instances.cuh"
#include "linalg.cuh"

namespace trajopt {

// One sweep at λ; writes k, K and returns whether every gain is finite.
template <int NX, int NU>
__device__ bool riccati_sweep(const double* __restrict__ A,
                              const double* __restrict__ Bm,
                              const double* __restrict__ lx,
                              const double* __restrict__ lxx,
                              const double* __restrict__ lu,
                              const double* __restrict__ luu, double lam,
                              double* __restrict__ kout,
                              double* __restrict__ Kout, double& dJ, int H,
                              int B, int b) {
  constexpr int NC = NX + NU;
  double Vx[NX], Vxx[NX][NX];
  const size_t T1 = size_t(H - 1);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    Vx[i] = lx[(T1 * NX + i) * B + b];
#pragma unroll
    for (int j = 0; j < NX; ++j) Vxx[i][j] = lxx[((T1 * NX + i) * NX + j) * B + b];
  }
  bool valid = true;
  dJ = 0.0;
  for (int t = H - 1; t >= 0; --t) {
    const size_t tt = size_t(t);
    // column c of [A|B], row j
    auto AB = [&](int j, int c) -> double {
      return c < NX ? A[((tt * NX + j) * NX + c) * B + b]
                    : Bm[((tt * NX + j) * NU + (c - NX)) * B + b];
    };
    double W[NX][NC];  // V_xx [A|B]
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        double s = 0.0;
#pragma unroll
        for (int j = 0; j < NX; ++j) s += Vxx[i][j] * AB(j, c);
        W[i][c] = s;
      }
    double Qx[NX], Qu[NU], Quu[NU][NU], Qux[NU][NX];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      double g = 0.0;
#pragma unroll
      for (int j = 0; j < NX; ++j) g += AB(j, c) * Vx[j];
      if (c < NX) Qx[c] = lx[(tt * NX + c) * B + b] + g;
      else Qu[c - NX] = lu[(tt * NU + c - NX) * B + b] + g;
    }
    // Q_xx overwrites V_xx (no longer needed once W is formed)
#pragma unroll
    for (int c1 = 0; c1 < NC; ++c1)
#pragma unroll
      for (int c2 = 0; c2 < NC; ++c2) {
        if (c1 < NX && c2 >= NX) continue;
        double G = 0.0;
#pragma unroll
        for (int j = 0; j < NX; ++j) G += AB(j, c1) * W[j][c2];
        if (c1 < NX)
          Vxx[c1][c2] = lxx[((tt * NX + c1) * NX + c2) * B + b] + G;
        else if (c2 < NX)
          Qux[c1 - NX][c2] = G;
        else
          Quu[c1 - NX][c2 - NX] =
              luu[((tt * NU + c1 - NX) * NU + c2 - NX) * B + b] + G;
      }
    double L[NU][NU];
#pragma unroll
    for (int i = 0; i < NU; ++i)
#pragma unroll
      for (int j = 0; j < NU; ++j) L[i][j] = Quu[i][j] + (i == j ? lam : 0.0);
    chol_factor<NU>(L);
    double k[NU], K[NU][NX];
#pragma unroll
    for (int a = 0; a < NU; ++a) k[a] = Qu[a];
    chol_solve<NU>(L, k);
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      k[a] = -k[a];
      valid = valid && isfinite(k[a]);
      kout[(tt * NU + a) * B + b] = k[a];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      double col[NU];
#pragma unroll
      for (int a = 0; a < NU; ++a) col[a] = Qux[a][i];
      chol_solve<NU>(L, col);
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        K[a][i] = -col[a];
        valid = valid && isfinite(K[a][i]);
        Kout[((tt * NU + a) * NX + i) * B + b] = K[a][i];
      }
    }
    double Quuk[NU], QuuK[NU][NX];
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      double s = 0.0;
#pragma unroll
      for (int c = 0; c < NU; ++c) s += Quu[a][c] * k[c];
      Quuk[a] = s;
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        double m = 0.0;
#pragma unroll
        for (int c = 0; c < NU; ++c) m += Quu[a][c] * K[c][i];
        QuuK[a][i] = m;
      }
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      double s1 = 0.0, s2 = 0.0, s3 = 0.0;
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        s1 += K[a][i] * Quuk[a];
        s2 += K[a][i] * Qu[a];
        s3 += Qux[a][i] * k[a];
      }
      Vx[i] = Qx[i] + s1 + s2 + s3;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        double s1 = 0.0, s2 = 0.0, s3 = 0.0;
#pragma unroll
        for (int a = 0; a < NU; ++a) {
          s1 += K[a][i] * QuuK[a][j];
          s2 += K[a][i] * Qux[a][j];
          s3 += Qux[a][i] * K[a][j];
        }
        Vxx[i][j] = Vxx[i][j] + s1 + s2 + s3;
      }
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = i + 1; j < NX; ++j) {
        const double s = 0.5 * (Vxx[i][j] + Vxx[j][i]);
        Vxx[i][j] = s;
        Vxx[j][i] = s;
      }
    double d1 = 0.0, d2 = 0.0;
#pragma unroll
    for (int a = 0; a < NU; ++a) {
      d1 += k[a] * Qu[a];
      d2 += k[a] * Quuk[a];
    }
    dJ = dJ + (d1 + d2);
  }
  return valid;
}

template <int NX, int NU>
__global__ void __launch_bounds__(64)
backward_kernel(const double* __restrict__ A, const double* __restrict__ Bm,
                const double* __restrict__ lx, const double* __restrict__ lxx,
                const double* __restrict__ lu, const double* __restrict__ luu,
                const double* __restrict__ lam_in,
                const double* __restrict__ sched, double* __restrict__ kout,
                double* __restrict__ Kout, double* __restrict__ dJout,
                double* __restrict__ lam_out,
                unsigned char* __restrict__ exit_out, int H, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const double factor = sched[0], lmin = sched[1], lmax = sched[2];
  double lam = lam_in[b];
  double dJ = 0.0;
  bool valid = false, exited = false;
  for (;;) {
    valid = riccati_sweep<NX, NU>(A, Bm, lx, lxx, lu, luu, lam, kout, Kout,
                                  dJ, H, B, b);
    const double next = valid ? lam / factor : lam * factor;
    exited = next > lmax;
    lam = clip(next, lmin, lmax);
    if (valid || exited) break;
  }
  dJout[b] = dJ;
  lam_out[b] = lam;
  exit_out[b] = (exited && !valid) ? 1 : 0;
}

}  // namespace trajopt

#define TRAJOPT_DEFINE_BACKWARD(NX, NU)                                       \
  extern "C" int trajopt_backward_nx##NX##_nu##NU(                            \
      const double* A, const double* Bm, const double* lx, const double* lxx, \
      const double* lu, const double* luu, const double* lam_in,              \
      const double* sched, double* kout, double* Kout, double* dJ,            \
      double* lam_out, unsigned char* exit_out, int H, int B, void* stream) { \
    if (B <= 0) return 0;                                                     \
    trajopt::backward_kernel<NX, NU><<<(B + 63) / 64, 64, 0,                  \
                                       static_cast<cudaStream_t>(stream)>>>(  \
        A, Bm, lx, lxx, lu, luu, lam_in, sched, kout, Kout, dJ, lam_out,      \
        exit_out, H, B);                                                      \
    return static_cast<int>(cudaGetLastError());                              \
  }

TRAJOPT_BP_BUILT(TRAJOPT_DEFINE_BACKWARD)
TRAJOPT_DEFINE_ERROR_STRING
