// K9b: the per-column gather and lerp of slot Jacobians to the full
// horizon, one thread per (step, column, lane); and K9c: the
// iterative_error bisection test, one thread per (node, dof, lane).
//
// K9b replaces trajoptkp_tpu/solver/lanes.py:415-428 (jacobians_adaptive's
// J_full = J_p + w (J_n - J_p), J_p and J_n gathered per column at the
// previous and next slot of the dof the column follows) and :477
// (_ie_interp, the same on the iterative_error cache, whose slots are
// times).  Column c follows dof col_dof[c]: j mod n for a state column,
// min(c, n-1) for a control column.  Plain twin:
// trajoptkp_tpu_torch/keypoints/interpolate.py:lerp_columns.  Bound:
// bytes, per output entry two gathered reads and one write of 8 bytes
// (the gathers hit the K slots again and again, so mostly through L2);
// the thread loops over the 2n rows, so neighbouring threads (lanes) read
// and write neighbouring addresses.
//
// K9c replaces trajoptkp_tpu/solver/lanes.py:_ie_node_mse:459: at each
// open node (s, mid, e) and dof d, the mean over the n velocity rows of
// the squared difference between A's columns d and n + d at mid and the
// mean of their values at s and e, averaged over the two columns.  The
// sums run left to right over the rows and the means multiply by 1/n (the
// JAX program's folded division), as the twin
// (kernels/ops.py:ie_node_mse_plain) does, so the split decision
// mse >= threshold is the same on both paths.  Bound: bytes, 6 n reads per
// output.
#include <cuda_runtime.h>

namespace trajopt {

__global__ void __launch_bounds__(256)
kp_interp_kernel(const double* __restrict__ J, const int* __restrict__ pslot,
                 const int* __restrict__ nslot, const double* __restrict__ w,
                 const int* __restrict__ col_dof, int H, int n, int NX, int C,
                 int B, double* __restrict__ A, double* __restrict__ Bm) {
  const size_t idx = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= size_t(H) * C * B) return;
  const int b = int(idx % B);
  const int c = int((idx / B) % C);
  const int t = int(idx / (size_t(B) * C));
  const size_t k = (size_t(t) * n + col_dof[c]) * B + b;
  const size_t p = pslot[k], q = nslot[k];
  const double wt = w[k];
  const int NU = C - NX;
#pragma unroll 4
  for (int r = 0; r < NX; ++r) {
    const double jp = J[((p * NX + r) * C + c) * B + b];
    const double jn = J[((q * NX + r) * C + c) * B + b];
    const double v = jp + wt * (jn - jp);
    if (c < NX) {
      A[((size_t(t) * NX + r) * NX + c) * B + b] = v;
    } else {
      Bm[((size_t(t) * NX + r) * NU + (c - NX)) * B + b] = v;
    }
  }
}

__global__ void __launch_bounds__(256)
ie_mse_kernel(const double* __restrict__ cache, const int* __restrict__ s,
              const int* __restrict__ mid, const int* __restrict__ e, int m,
              int n, int C, int B, double inv_n, double* __restrict__ out) {
  const size_t idx = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= size_t(m) * n * B) return;
  const int b = int(idx % B);
  const int d = int((idx / B) % n);
  const int j = int(idx / (size_t(B) * n));
  const int NX = 2 * n;
  const size_t ts = s[j], tm = mid[j], te = e[j];
  double s0 = 0.0, s1 = 0.0;
#pragma unroll 1
  for (int r = n; r < NX; ++r) {
    const double* xs = cache + (ts * NX + r) * C * B;
    const double* xm = cache + (tm * NX + r) * C * B;
    const double* xe = cache + (te * NX + r) * C * B;
    const double d0 = xm[size_t(d) * B + b]
        - 0.5 * (xs[size_t(d) * B + b] + xe[size_t(d) * B + b]);
    const double d1 = xm[size_t(n + d) * B + b]
        - 0.5 * (xs[size_t(n + d) * B + b] + xe[size_t(n + d) * B + b]);
    s0 = s0 + d0 * d0;
    s1 = s1 + d1 * d1;
  }
  out[idx] = 0.5 * (s0 * inv_n + s1 * inv_n);
}

}  // namespace trajopt

extern "C" int trajopt_kp_interp(const double* J, const int* pslot,
                                 const int* nslot, const double* w,
                                 const int* col_dof, int K, int H, int n,
                                 int NX, int C, int B, double* A, double* Bm,
                                 void* stream) {
  const size_t total = size_t(H) * C * B;
  if (total == 0) return 0;
  if (K < 1 || NX != 2 * n || C < NX) return int(cudaErrorInvalidValue);
  trajopt::kp_interp_kernel<<<unsigned((total + 255) / 256), 256, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      J, pslot, nslot, w, col_dof, H, n, NX, C, B, A, Bm);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int trajopt_ie_mse(const double* cache, const int* s,
                              const int* mid, const int* e, int m, int n,
                              int C, int B, double inv_n, double* out,
                              void* stream) {
  const size_t total = size_t(m) * n * B;
  if (total == 0) return 0;
  trajopt::ie_mse_kernel<<<unsigned((total + 255) / 256), 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      cache, s, mid, e, m, n, C, B, inv_n, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trajopt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
