// K7: Riccati backward pass with the λ retry, a thread block per lane.
//
// Replaces the JAX lane backward pass and λ loop,
// trajoptkp_tpu/solver/lanes.py:632-746 (backward_pass, bp_lambda_loop).
// Plain twin: trajoptkp_tpu_torch/solver/ilqr.py:backward_pass_lambda_loop.
//
// Per lane, for t = H-1 .. 0: W = V_xx [A|B], g = [A|B]^T V_x and
// G = [A|B]^T W give the Q blocks; a nu x nu Cholesky of Q_uu + λ I, the
// gains k = -Q_uu^-1 Q_u and K = -Q_uu^-1 Q_ux, the symmetrised V update
// and ΔJ.  The λ retry is the JAX lane solver's coupled loop (bp_lambda_loop,
// trajoptkp_tpu/solver/lanes.py:720-746): while any lane is invalid and not
// exited, every lane sweeps again at its updated λ (a valid lane's λ keeps
// falling), and a lane's λ-exit is `exited & ~valid` of its last sweep.  At
// B = 1 this is the generic loop (solver/ilqr.py:380).  The host reads no
// flag: the wrapper makes 1 + bp_rounds launches (solver/ilqr.py:
// bp_rounds, log_factor(max λ / min λ) + 2, which also caps a lane's
// sweeps at 1 + bp_rounds); a launch whose target the lanes have already
// reached returns at once.
//
// Bound (chip_smoke.py:backward_bound): per step and sweep ~2 n^2 (n + nu)
// for W, 2 n (n^2 + nu (n + nu)) for the Q blocks, ~6 n^2 nu for the V
// update and the nu x nu Cholesky with its n + 1 solves (n = nx, the
// tangent state; ~330k double operations at nx 38, nu 7), against the
// 8 (n (n + nu) + n^2 + n + nu + nu^2) bytes of A, B and the cost terms a
// sweep reads per step and the 8 nu (n + 1) of k and K it writes: at
// B = 128 and one sweep the two are of one size on an H100 (push_lcl's
// 1.28 ms by operations).  But a lane's steps are a chain: each waits for
// the last one's V, and inside a step the Cholesky of Q_uu + λ I and the
// solves are a chain of nu square roots, nu reciprocals and 2 nu
// divisions (each a dependent sequence of a few hundred cycles as the
// card rounds it).  So the kernel spreads a lane's entries over an SM's
// threads and keeps the rest of a step off that chain.
//
// Design: a thread block owns a lane (from nx 14; below it a warp owns a
// lane and a block holds several, kernels/ops.py:backward_geometry, which
// also picks the block size and the dynamic shared memory).  V_x, V_xx
// (overwritten in place by Q_xx), W, the Q blocks, k, K, Q_uu k and Q_uu K
// live in the lane's shared memory.  Each entry of W, g, G and the new V
// is computed by one thread, whose sum runs left to right over its index
// exactly as the twin's `_contract` does (built with -fmad=false), so
// kernel and twin agree bit for bit; the threads stride over the entries
// at run time and only the inner sums are unrolled over NX, so no instance
// needs rolled loops.  Each of the n + 1 right-hand sides (k and the
// columns of K) is one thread's: it factors Q_uu + λ I in registers with
// the forward substitution beside the factorisation (chol_factor_forward:
// linalg.cuh's operations in their order), then substitutes backward.  A
// step is four phases between lane barriers: W and g; Q_ux and Q_uu; the
// solves; the V update.  Where a block owns the lane, the warps that solve
// nothing form Q_xx while the gains are solved (named barrier 1: once the
// solving warps hold their operands), then load the inputs of the next
// step but one (8-byte elements: one lane's values lie B apart) into
// shared memory by cp.async (named barrier 2: once Q_xx has read them), so
// that neither lies on the chain and the scattered loads do not queue
// ahead of the chain's reads; two input buffers, two steps ahead (an
// instance whose two do not fit in a block is refused).  k and K go
// straight to device memory in their batch-last layout.  dJ, λ, the exit
// flag and the count are one thread's, in the order of the one-thread
// kernel this replaces; validity is an AND over the lane's threads.
//
// Shared memory per lane, in doubles: n^2 + n (n + nu) + 2 n + 3 nu n +
// nu^2 + 3 nu (the work arrays) plus twice n (n + nu) + n^2 + n + nu + nu^2
// (the two input buffers), and 2 bytes per upper-triangle pair of V_xx for
// the block's pair table (kernels/ops.py:backward_smem_bytes mirrors
// BpLayout): 86.2 KB at nx 38, nu 7, 212.7 KB at nx 62.
#include "instances.cuh"
#include "linalg.cuh"

// With TRAJOPT_BP_MARKS (bench_kernels.py --backward --marks) thread 0 of
// block 0 reads clock64() at the four lane barriers of each step and sums
// the SM cycles of each phase over its steps: W and g; Q_ux and Q_uu; the
// solves (Q_xx and the next loads beside them); the V update with the
// wait for the inputs.  trajopt_bp_marks_read copies out and zeroes the
// sums and the count of steps.  Built without it, the marks are nothing.
#ifdef TRAJOPT_BP_MARKS
__device__ unsigned long long trajopt_bp_marks[5];
#define BP_MARKS_BEGIN                                       \
  const bool marked_ = blockIdx.x == 0 && threadIdx.x == 0; \
  long long spent_[5] = {0, 0, 0, 0, 0}, last_ = clock64();
#define BP_MARK(k)                     \
  if (marked_) {                       \
    const long long now_ = clock64(); \
    spent_[k] += now_ - last_;         \
    last_ = now_;                      \
  }
#define BP_MARKS_END                                                   \
  if (marked_) {                                                       \
    for (int k = 1; k < 5; ++k)                                        \
      atomicAdd(&trajopt_bp_marks[k],                                  \
                static_cast<unsigned long long>(spent_[k]));           \
    atomicAdd(&trajopt_bp_marks[0], static_cast<unsigned long long>(H)); \
  }
extern "C" int trajopt_bp_marks_read(unsigned long long* out) {
  const unsigned long long zero[5] = {0, 0, 0, 0, 0};
  cudaMemcpyFromSymbol(out, trajopt_bp_marks, sizeof(zero));
  cudaMemcpyToSymbol(trajopt_bp_marks, zero, sizeof(zero));
  return static_cast<int>(cudaGetLastError());
}
#else
#define BP_MARKS_BEGIN
#define BP_MARK(k)
#define BP_MARKS_END
#endif

namespace trajopt {

// Offsets (in doubles) of one lane's arrays in shared memory.
template <int NX, int NU>
struct BpLayout {
  static constexpr int NC = NX + NU;
  // work arrays
  static constexpr int VX = 0;                 // V_x [NX]
  static constexpr int VXX = VX + NX;          // V_xx, then Q_xx [NX][NX]
  static constexpr int W = VXX + NX * NX;      // V_xx [A|B] [NX][NC]
  static constexpr int Q = W + NX * NC;        // Q_x | Q_u [NC]
  static constexpr int QUX = Q + NC;           // [NU][NX]
  static constexpr int QUU = QUX + NU * NX;    // [NU][NU]
  static constexpr int KV = QUU + NU * NU;     // k [NU]
  static constexpr int KM = KV + NU;           // K [NU][NX]
  static constexpr int QUUK = KM + NU * NX;    // Q_uu k [NU]
  static constexpr int QUUKM = QUUK + NU;      // Q_uu K [NU][NX]
  static constexpr int WORK = QUUKM + NU * NX;
  // one input buffer: a step's [A|B], l_x, l_xx, l_u, l_uu
  static constexpr int AB = 0;                 // [NX][NC]
  static constexpr int LX = AB + NX * NC;      // [NX]
  static constexpr int LXX = LX + NX;          // [NX][NX]
  static constexpr int LU = LXX + NX * NX;     // [NU]
  static constexpr int LUU = LU + NU;          // [NU][NU]
  static constexpr int IN = LUU + NU * NU;
  static constexpr int NPAIR = NX * (NX + 1) / 2;

  static constexpr int LANE = WORK + 2 * IN;   // two input buffers

  // the lanes' doubles, then the pair table, to a multiple of 16 bytes
  __host__ __device__ static constexpr int smem_bytes(int lanes) {
    return (8 * lanes * LANE + 2 * NPAIR + 15) / 16 * 16;
  }
};

// 8 bytes from device memory into shared memory, asynchronously (a plain
// copy where no device code is generated: a host build of the kernel body)
__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}
__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// The barrier and the AND over one lane's threads: the block, or the warp
// where a block holds several lanes.
__device__ __forceinline__ void lane_sync(int lanes) {
  if (lanes == 1)
    __syncthreads();
  else
    __syncwarp();
}
__device__ __forceinline__ bool lane_all(int lanes, bool v) {
  return lanes == 1 ? __syncthreads_and(v) != 0 : __all_sync(0xffffffffu, v);
}

// sum_j x[j * sx] * y[j * sy], left to right from the first product, as
// the twin's `_contract`
template <int N>
__device__ __forceinline__ double dot(const double* x, int sx, const double* y,
                                      int sy) {
  double s = x[0] * y[0];
#pragma unroll
  for (int j = 1; j < N; ++j) s = s + x[j * sx] * y[j * sy];
  return s;
}

// linalg.cuh's chol_factor with the forward half of chol_solve folded in:
// row j of L y = b as soon as column j of L is known, so that the forward
// substitution runs beside the factorisation instead of after it (the same
// operations on the same values)
template <int N>
__device__ __forceinline__ void chol_factor_forward(double (&A)[N][N],
                                                    double (&b)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    double s = A[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= A[j][k] * A[j][k];
    A[j][j] = sqrt(s);
    const double inv = recip(A[j][j]);
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      double t = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t -= A[i][k] * A[j][k];
      A[i][j] = t * inv;
    }
    double y = b[j];
#pragma unroll
    for (int k = 0; k < j; ++k) y -= A[j][k] * b[k];
    b[j] = y / A[j][j];
  }
}

// the backward half of chol_solve: L^T x = y in place
template <int N>
__device__ __forceinline__ void chol_backward(const double (&L)[N][N],
                                              double (&b)[N]) {
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    double s = b[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) s -= L[k][i] * b[k];
    b[i] = s / L[i][i];
  }
}

// Named barrier `id` (1 or 2; 0 is __syncthreads) over n threads: arrive
// without waiting, or wait for the others.  A host build of the kernel
// body (no device code) has to supply its own.
__device__ __forceinline__ void named_arrive(int id, int n) {
#ifdef __CUDA_ARCH__
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
#endif
}
__device__ __forceinline__ void named_sync(int id, int n) {
#ifdef __CUDA_ARCH__
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
#endif
}

// Copy step t's [A|B], l_x, l_xx, l_u and l_uu of lane b into `in`.
template <int NX, int NU>
__device__ __forceinline__ void load_step(
    double* in, const double* __restrict__ A, const double* __restrict__ Bm,
    const double* __restrict__ lx, const double* __restrict__ lxx,
    const double* __restrict__ lu, const double* __restrict__ luu, int t,
    int B, int b, int tid, int group) {
  using L = BpLayout<NX, NU>;
  const size_t tt = size_t(t), BB = size_t(B);
  for (int e = tid; e < NX * NX; e += group)
    cp_async8(in + L::AB + (e / NX) * L::NC + e % NX,
              A + (tt * NX * NX + e) * BB + b);
  for (int e = tid; e < NX * NU; e += group)
    cp_async8(in + L::AB + (e / NU) * L::NC + NX + e % NU,
              Bm + (tt * NX * NU + e) * BB + b);
  for (int e = tid; e < NX * NX; e += group)
    cp_async8(in + L::LXX + e, lxx + (tt * NX * NX + e) * BB + b);
  for (int e = tid; e < NX; e += group)
    cp_async8(in + L::LX + e, lx + (tt * NX + e) * BB + b);
  for (int e = tid; e < NU; e += group)
    cp_async8(in + L::LU + e, lu + (tt * NU + e) * BB + b);
  for (int e = tid; e < NU * NU; e += group)
    cp_async8(in + L::LUU + e, luu + (tt * NU * NU + e) * BB + b);
}

// One sweep of lane b at λ by the lane's `group` threads (this one is
// `tid`); writes k, K, returns whether every gain is finite (on every
// thread) and leaves ΔJ in the last thread's dJ.
template <int NX, int NU>
__device__ bool riccati_sweep(const double* __restrict__ A,
                              const double* __restrict__ Bm,
                              const double* __restrict__ lx,
                              const double* __restrict__ lxx,
                              const double* __restrict__ lu,
                              const double* __restrict__ luu, double lam,
                              double* __restrict__ kout,
                              double* __restrict__ Kout, double& dJ, int H,
                              int B, int b, double* sm,
                              const unsigned short* pairs, int tid, int group,
                              int lanes) {
  using L = BpLayout<NX, NU>;
  constexpr int NC = L::NC;
  double* Vx = sm + L::VX;
  double* Vxx = sm + L::VXX;
  double* W = sm + L::W;
  double* Q = sm + L::Q;
  double* Qux = sm + L::QUX;
  double* Quu = sm + L::QUU;
  double* kv = sm + L::KV;
  double* Km = sm + L::KM;
  double* Quuk = sm + L::QUUK;
  double* QuuK = sm + L::QUUKM;
  // the input buffers are offsets from `sm`: a pointer array would go to
  // local memory and its reads of shared memory become generic loads
  const size_t BB = size_t(B);
  bool valid = true;
  if (tid == group - 1) dJ = 0.0;
  if (H <= 0) return true;
  // the inputs of step t go to buffer (H - 1 - t) & 1, loaded two steps
  // ahead; one commit group per step, so that a step's end waits for its
  // successor's inputs alone
  {
    const size_t T1 = size_t(H - 1);
    for (int e = tid; e < NX * NX; e += group)
      cp_async8(Vxx + e, lxx + (T1 * NX * NX + e) * BB + b);
    for (int e = tid; e < NX; e += group)
      cp_async8(Vx + e, lx + (T1 * NX + e) * BB + b);
    load_step<NX, NU>(sm + L::WORK, A, Bm, lx, lxx, lu, luu, H - 1, B, b,
                      tid, group);
    cp_async_commit();
    if (H > 1)
      load_step<NX, NU>(sm + L::WORK + L::IN, A, Bm, lx, lxx, lu, luu, H - 2,
                        B, b, tid, group);
    cp_async_commit();
    cp_async_wait<1>();
    lane_sync(lanes);
  }
  BP_MARKS_BEGIN
  for (int t = H - 1; t >= 0; --t) {
    const size_t tt = size_t(t);
    double* in = sm + L::WORK + ((H - 1 - t) & 1 ? L::IN : 0);
    const double* AB = in + L::AB;
    // W = V_xx [A|B]; g = [A|B]^T V_x, Q_x = l_x + g, Q_u = l_u + g
    for (int e = tid; e < NX * NC + NC; e += group) {
      if (e < NX * NC) {
        const int i = e / NC, c = e % NC;
        W[e] = dot<NX>(Vxx + i * NX, 1, AB + c, NC);
      } else {
        const int c = e - NX * NC;
        const double g = dot<NX>(AB + c, NC, Vx, 1);
        Q[c] = (c < NX ? in[L::LX + c] : in[L::LU + c - NX]) + g;
      }
    }
    lane_sync(lanes);
    BP_MARK(1);
    // G = [A|B]^T W: Q_xx = l_xx + G over V_xx (read only above), Q_ux,
    // Q_uu = l_uu + G.  Where a block owns the lane, Q_xx waits for the
    // solve below (only the V update reads it)
    const int qxx = lanes == 1 ? 0 : NX * NX;
    for (int e = tid + NX * NX - qxx; e < NX * NX + NU * NC; e += group) {
      if (e < NX * NX) {
        const int c1 = e / NX, c2 = e % NX;
        Vxx[e] = in[L::LXX + e] + dot<NX>(AB + c1, NC, W + c2, NC);
      } else {
        const int a = (e - NX * NX) / NC, c2 = (e - NX * NX) % NC;
        const double G = dot<NX>(AB + NX + a, NC, W + c2, NC);
        if (c2 < NX)
          Qux[a * NX + c2] = G;
        else
          Quu[a * NU + c2 - NX] = in[L::LUU + a * NU + c2 - NX] + G;
      }
    }
    lane_sync(lanes);
    BP_MARK(2);
    // Right-hand side r = tid: k (r = 0) or column r - 1 of K.  Its thread
    // takes Q_uu + λ I and its column into registers, factors and solves
    // there (the forward substitution beside the factorisation), then
    // forms its column of Q_uu k or Q_uu K.  Once the solving warps have
    // their operands (named barrier 1), the other warps form Q_xx and then
    // fill `in`, read no more in this step, with the inputs of step t - 2
    // (a warp that owns a lane: its idle threads load).
    const bool rhs = tid <= NX;
    double Lm[NU][NU], x[NU];
    if (rhs) {
#pragma unroll
      for (int i = 0; i < NU; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j)
          Lm[i][j] = Quu[i * NU + j] + (i == j ? lam : 0.0);
#pragma unroll
      for (int a = 0; a < NU; ++a)
        x[a] = tid == 0 ? Q[NX + a] : Qux[a * NX + tid - 1];
    }
    const int solvers = lanes == 1 ? 32 * ((NX + 32) / 32) : group;
    if (tid < solvers) {
      if (lanes == 1) named_arrive(1, group);
    } else {
      named_sync(1, group);
      // the other warps form Q_xx meanwhile, then load (barrier 2: every
      // read of `in` done)
      for (int e = tid - solvers; e < NX * NX; e += group - solvers) {
        const int c1 = e / NX, c2 = e % NX;
        Vxx[e] = in[L::LXX + e] + dot<NX>(AB + c1, NC, W + c2, NC);
      }
      named_sync(2, group - solvers);
    }
    if (lanes > 1) __syncwarp();
    if (!rhs && t >= 2) {
      const int first = lanes == 1 ? solvers : NX + 1;
      if (tid >= first)
        load_step<NX, NU>(in, A, Bm, lx, lxx, lu, luu, t - 2, B, b,
                          tid - first, group - first);
    }
    cp_async_commit();
    if (rhs) {
      chol_factor_forward<NU>(Lm, x);
      chol_backward<NU>(Lm, x);
#pragma unroll
      for (int a = 0; a < NU; ++a) {
        x[a] = -x[a];
        valid = valid && isfinite(x[a]);
      }
      if (tid == 0) {
#pragma unroll
        for (int a = 0; a < NU; ++a) {
          kv[a] = x[a];
          kout[(tt * NU + a) * BB + b] = x[a];
          Quuk[a] = dot<NU>(Quu + a * NU, 1, x, 1);
        }
      } else {
        const int i = tid - 1;
#pragma unroll
        for (int a = 0; a < NU; ++a) {
          Km[a * NX + i] = x[a];
          Kout[((tt * NU + a) * NX + i) * BB + b] = x[a];
          QuuK[a * NX + i] = dot<NU>(Quu + a * NU, 1, x, 1);
        }
      }
    }
    lane_sync(lanes);
    BP_MARK(3);
    // V_x; V_xx = Q_xx + K^T Q_uu K + K^T Q_ux + Q_ux^T K, symmetrised, by
    // the owner of each pair (i <= j); ΔJ
    for (int e = tid; e < L::NPAIR + NX; e += group) {
      if (e < L::NPAIR) {
        const int i = pairs[e] >> 8, j = pairs[e] & 0xff;
        const double vij =
            ((Vxx[i * NX + j] + dot<NU>(Km + i, NX, QuuK + j, NX)) +
             dot<NU>(Km + i, NX, Qux + j, NX)) +
            dot<NU>(Qux + i, NX, Km + j, NX);
        const double vji =
            i == j ? vij
                   : ((Vxx[j * NX + i] + dot<NU>(Km + j, NX, QuuK + i, NX)) +
                      dot<NU>(Km + j, NX, Qux + i, NX)) +
                         dot<NU>(Qux + j, NX, Km + i, NX);
        const double s = 0.5 * (vij + vji);
        Vxx[i * NX + j] = s;
        Vxx[j * NX + i] = s;
      } else {
        const int i = e - L::NPAIR;
        Vx[i] = ((Q[i] + dot<NU>(Km + i, NX, Quuk, 1)) +
                 dot<NU>(Km + i, NX, Q + NX, 1)) +
                dot<NU>(Qux + i, NX, kv, 1);
      }
    }
    if (tid == group - 1)  // most often a thread without a pair
      dJ = dJ + (dot<NU>(kv, 1, Q + NX, 1) + dot<NU>(kv, 1, Quuk, 1));
    cp_async_wait<1>();
    lane_sync(lanes);
    BP_MARK(4);
  }
  BP_MARKS_END
  return lane_all(lanes, valid);
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
// exited & ~valid.  Every thread of a lane runs the loop's control on the
// same values; the last thread writes the lane's state.
template <int NX, int NU>
__global__ void __launch_bounds__(512)
backward_kernel(const double* __restrict__ A, const double* __restrict__ Bm,
                const double* __restrict__ lx, const double* __restrict__ lxx,
                const double* __restrict__ lu, const double* __restrict__ luu,
                const double* __restrict__ lam_in,
                const double* __restrict__ sched, double* __restrict__ kout,
                double* __restrict__ Kout, double* __restrict__ dJout,
                double* __restrict__ lam_out,
                unsigned char* __restrict__ exit_out,
                unsigned char* __restrict__ valid_out, int* __restrict__ count,
                int* __restrict__ target, int launch, int cap, int H, int B,
                int lanes) {
  using L = BpLayout<NX, NU>;
  extern __shared__ double smem[];
  const int group = blockDim.x / lanes;
  const int tid = threadIdx.x % group;
  const int b = blockIdx.x * lanes + threadIdx.x / group;
  unsigned short* pairs =
      reinterpret_cast<unsigned short*>(smem + lanes * L::LANE);
  for (int e = threadIdx.x; e < NX * NX; e += blockDim.x) {
    const int i = e / NX, j = e % NX;
    if (i <= j)
      pairs[i * NX - i * (i - 1) / 2 + j - i] =
          static_cast<unsigned short>((i << 8) | j);
  }
  __syncthreads();
  if (b >= B) return;  // a lane past B: a whole warp (lanes > 1 only)
  double* sm = smem + (threadIdx.x / group) * L::LANE;
  const double factor = sched[0], lmin = sched[1], lmax = sched[2];
  int n = launch == 0 ? 0 : count[b];
  const int goal = launch == 0 ? cap : target[launch - 1];
  double lam = launch == 0 ? lam_in[b] : lam_out[b];
  double dJ = 0.0;
  bool valid = false, exited = false;
  for (;;) {
    if (n >= goal) {  // no sweep to make: the lane keeps its state
      valid = valid_out[b] != 0;
      exited = exit_out[b] != 0;
      dJ = dJout[b];
      break;
    }
    valid = riccati_sweep<NX, NU>(A, Bm, lx, lxx, lu, luu, lam, kout, Kout,
                                  dJ, H, B, b, sm, pairs, tid, group, lanes);
    ++n;
    const double next = valid ? lam / factor : lam * factor;
    exited = next > lmax;
    lam = clip(next, lmin, lmax);
    if (n >= goal || (launch == 0 && (valid || exited))) break;
  }
  lane_sync(lanes);  // every thread has read the lane's state
  if (tid != group - 1) return;  // the thread that summed dJ
  count[b] = n;
  dJout[b] = dJ;
  lam_out[b] = lam;
  exit_out[b] = exited ? 1 : 0;
  valid_out[b] = valid ? 1 : 0;
  atomicMax(target + launch, (!valid && !exited && n < cap) ? n + 1 : n);
}

}  // namespace trajopt

// The launch takes its geometry from the wrapper (kernels/ops.py:
// backward_geometry): `threads` per block, `lanes` per block (1, or one a
// warp with threads = 32 lanes) and `smem` bytes, which must equal
// BpLayout's count; anything else is refused.
#define TRAJOPT_DEFINE_BACKWARD(NX, NU)                                       \
  extern "C" int trajopt_backward_nx##NX##_nu##NU(                            \
      const double* A, const double* Bm, const double* lx, const double* lxx, \
      const double* lu, const double* luu, const double* lam_in,              \
      const double* sched, double* kout, double* Kout, double* dJ,            \
      double* lam_out, unsigned char* exit_out, unsigned char* valid_out,     \
      int* count, int* target, int launch, int cap, int H, int B,             \
      int threads, int lanes, int smem, void* stream) {                       \
    using L = trajopt::BpLayout<NX, NU>;                                      \
    if (B <= 0) return 0;                                                     \
    if (threads < 32 || threads > 512 || threads % 32 != 0 || lanes < 1 ||    \
        (lanes > 1 && threads != 32 * lanes) || (lanes == 1 && threads < 64) || \
        threads / lanes <= NX + 1 ||                                          \
        (lanes == 1 && threads < 32 * ((NX + 32) / 32) + 32) ||               \
        smem != L::smem_bytes(lanes))                                         \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    auto kernel = trajopt::backward_kernel<NX, NU>;                           \
    if (smem > 48 * 1024) {                                                   \
      const cudaError_t e = cudaFuncSetAttribute(                             \
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);         \
      if (e != cudaSuccess) return static_cast<int>(e);                       \
    }                                                                         \
    kernel<<<(B + lanes - 1) / lanes, threads, smem,                          \
             static_cast<cudaStream_t>(stream)>>>(                            \
        A, Bm, lx, lxx, lu, luu, lam_in, sched, kout, Kout, dJ, lam_out,      \
        exit_out, valid_out, count, target, launch, cap, H, B, lanes);        \
    return static_cast<int>(cudaGetLastError());                              \
  }

TRAJOPT_BP_BUILT(TRAJOPT_DEFINE_BACKWARD)
TRAJOPT_DEFINE_ERROR_STRING
