// K7: Riccati backward pass with the λ retry, one thread per scene.
//
// Replaces the JAX lane backward pass and λ loop,
// trajoptkp_tpu/solver/lanes.py:632-746 (backward_pass, bp_lambda_loop).
// Plain twin: trajoptkp_tpu_torch/solver/ilqr.py:backward_pass_lambda_loop.
//
// Per lane, for t = H-1 .. 0: the Q blocks from [A|B]^T V and
// [A|B]^T V_xx [A|B], an unrolled nu x nu Cholesky of Q_uu + λ I, the gains
// k = -Q_uu^-1 Q_u and K = -Q_uu^-1 Q_ux, the symmetrised V update and ΔJ.
// The λ retry is the JAX lane solver's coupled loop (bp_lambda_loop,
// trajoptkp_tpu/solver/lanes.py:720-746): while any lane is invalid and not
// exited, every lane sweeps again at its updated λ (a valid lane's λ keeps
// falling), and a lane's λ-exit is `exited & ~valid` of its last sweep.  At
// B = 1 this is the generic loop (solver/ilqr.py:380).  The host reads no
// flag: the wrapper makes 1 + bp_rounds launches (solver/ilqr.py:
// bp_rounds, log_factor(max λ / min λ) + 2, which also caps a lane's
// sweeps at 1 + bp_rounds); a launch whose target the lanes have already
// reached returns at once.
//
// Past nx 26 (kernels/build.py ROLL_NX, TRAJOPT_ROLL_LOOPS) the outer loops
// over the state and the columns run rolled and only the innermost sums are
// unrolled: unrolled whole, nx 38 would keep nvcc for tens of minutes (nx 26
// took ~230 s); every sum keeps its order.
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
  const size_t T1 = size_t(H > 0 ? H - 1 : 0);  // H = 0: no steps
  TRAJOPT_UNROLL
  for (int i = 0; i < NX; ++i) {
    Vx[i] = lx[(T1 * NX + i) * B + b];
    TRAJOPT_UNROLL
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
    TRAJOPT_UNROLL
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        double s = 0.0;
#pragma unroll
        for (int j = 0; j < NX; ++j) s += Vxx[i][j] * AB(j, c);
        W[i][c] = s;
      }
    double Qx[NX], Qu[NU], Quu[NU][NU], Qux[NU][NX];
    TRAJOPT_UNROLL
    for (int c = 0; c < NC; ++c) {
      double g = 0.0;
#pragma unroll
      for (int j = 0; j < NX; ++j) g += AB(j, c) * Vx[j];
      if (c < NX) Qx[c] = lx[(tt * NX + c) * B + b] + g;
      else Qu[c - NX] = lu[(tt * NU + c - NX) * B + b] + g;
    }
    // Q_xx overwrites V_xx (no longer needed once W is formed)
    TRAJOPT_UNROLL
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
    TRAJOPT_UNROLL
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
    TRAJOPT_UNROLL
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
    TRAJOPT_UNROLL
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
    TRAJOPT_UNROLL
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

// The coupled λ loop in launches.  Launch 0: each lane sweeps from lam_in
// until it is valid or exited (at most `cap` sweeps) and proposes as
// target the sweeps it made.  Launch k >= 1: each lane sweeps on at its
// updated λ until it has made target[k - 1] sweeps, the most any lane
// made; one still invalid and not exited after them proposes one sweep
// more for the next launch.  A lane's λ, validity and gains after s sweeps
// depend on its own sequence alone, so once the target stops growing every
// lane holds the state the batch loop leaves after that many rounds.
// `exit_out` holds the last sweep's raw exit flag; the wrapper reports
// exited & ~valid.  A lane with no sweep to make runs one over no steps
// (H = 0) and keeps its state.  Register allocation: with any path that
// may skip the sweep (an early return, a loop that may not run, a
// data-dependent step count) ptxas gave the nx 10 and 14 kernels 32
// registers and ran them ~2.5x slower unless told that one block per SM
// will do (the second launch bound).
template <int NX, int NU>
__global__ void __launch_bounds__(64, 1)
backward_kernel(const double* __restrict__ A, const double* __restrict__ Bm,
                const double* __restrict__ lx, const double* __restrict__ lxx,
                const double* __restrict__ lu, const double* __restrict__ luu,
                const double* __restrict__ lam_in,
                const double* __restrict__ sched, double* __restrict__ kout,
                double* __restrict__ Kout, double* __restrict__ dJout,
                double* __restrict__ lam_out,
                unsigned char* __restrict__ exit_out,
                unsigned char* __restrict__ valid_out, int* __restrict__ count,
                int* __restrict__ target, int launch, int cap, int H,
                int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const double factor = sched[0], lmin = sched[1], lmax = sched[2];
  int n = launch == 0 ? 0 : count[b];
  const int goal = launch == 0 ? cap : target[launch - 1];
  double lam = launch == 0 ? lam_in[b] : lam_out[b];
  double dJ = 0.0;
  bool valid = false, exited = false;
  for (;;) {
    const int Hs = n < goal ? H : 0;
    valid = riccati_sweep<NX, NU>(A, Bm, lx, lxx, lu, luu, lam, kout, Kout,
                                  dJ, Hs, B, b);
    if (Hs == 0) {
      valid = valid_out[b] != 0;
      exited = exit_out[b] != 0;
      dJ = dJout[b];
      break;
    }
    ++n;
    const double next = valid ? lam / factor : lam * factor;
    exited = next > lmax;
    lam = clip(next, lmin, lmax);
    if (n >= goal || (launch == 0 && (valid || exited))) break;
  }
  count[b] = n;
  dJout[b] = dJ;
  lam_out[b] = lam;
  exit_out[b] = exited ? 1 : 0;
  valid_out[b] = valid ? 1 : 0;
  atomicMax(target + launch, (!valid && !exited && n < cap) ? n + 1 : n);
}

}  // namespace trajopt

#define TRAJOPT_DEFINE_BACKWARD(NX, NU)                                       \
  extern "C" int trajopt_backward_nx##NX##_nu##NU(                            \
      const double* A, const double* Bm, const double* lx, const double* lxx, \
      const double* lu, const double* luu, const double* lam_in,              \
      const double* sched, double* kout, double* Kout, double* dJ,            \
      double* lam_out, unsigned char* exit_out, unsigned char* valid_out,     \
      int* count, int* target, int launch, int cap, int H, int B,             \
      void* stream) {                                                         \
    if (B <= 0) return 0;                                                     \
    trajopt::backward_kernel<NX, NU><<<(B + 63) / 64, 64, 0,                  \
                                       static_cast<cudaStream_t>(stream)>>>(  \
        A, Bm, lx, lxx, lu, luu, lam_in, sched, kout, Kout, dJ, lam_out,      \
        exit_out, valid_out, count, target, launch, cap, H, B);               \
    return static_cast<int>(cudaGetLastError());                              \
  }

TRAJOPT_BP_BUILT(TRAJOPT_DEFINE_BACKWARD)
TRAJOPT_DEFINE_ERROR_STRING
