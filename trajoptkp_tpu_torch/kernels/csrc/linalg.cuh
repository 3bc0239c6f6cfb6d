// Small per-thread linear algebra shared by the step (step.cuh), the
// constraint solve (constraint.cuh) and the backward pass (backward.cu).
// The plain twins are trajoptkp_tpu_torch/utils/linalg.py:chol_unrolled and
// chol_solve_unrolled, operation for operation.  The functions take the
// scalar type as a template argument: double, or Dual (dual.cuh) in the
// forward-mode step of K5ad.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <utility>

#include "dual.cuh"

// TRAJOPT_ROLL_LOOPS (kernels/build.py:rolled: the instances past ROLL_NV
// dofs): the loops over dofs and rows that the other instances unroll
// whole run rolled, so that nvcc finishes in minutes; each iteration does
// the same operations in the same order, so a rolled kernel rounds as an
// unrolled one would.
#ifdef TRAJOPT_ROLL_LOOPS
#define TRAJOPT_UNROLL _Pragma("unroll 1")
#else
#define TRAJOPT_UNROLL _Pragma("unroll")
#endif

namespace trajopt {

#ifdef TRAJOPT_ROLL_LOOPS
constexpr bool ROLL_LOOPS = true;
#else
constexpr bool ROLL_LOOPS = false;
#endif

// clamp that keeps NaN, as torch.clamp and jnp.clip do (fmin/fmax drop it)
template <class S>
__device__ __forceinline__ S clip(S x, double lo, double hi) {
  return x < lo ? S(lo) : (x > hi ? S(hi) : x);
}

// max(x, lo) that keeps NaN, as torch.clamp(min=) and jnp.maximum do
template <class S>
__device__ __forceinline__ S at_least(S x, double lo) {
  return x < lo ? S(lo) : x;
}

// Loops whose index must be a compile-time constant: f(integral_constant<
// int, I>) for I = 0..N-1 in order (a fold over the comma operator), so a
// lookup by I is a constant expression, whatever its table.
template <class F, int... I>
__device__ __forceinline__ void static_for_impl(
    F&& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}
template <int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_impl(f, std::make_integer_sequence<int, N>{});
}

// the index for_rows passes (device code may not call integral_constant's
// host conversion)
__host__ __device__ constexpr int row_index(int r) { return r; }
template <int R>
__host__ __device__ constexpr int row_index(std::integral_constant<int, R>) {
  return R;
}

// f(r) for r = 0..N-1 in order: at compile time (static_for, r an
// integral_constant), or under TRAJOPT_ROLL_LOOPS as a loop (r an int)
template <int N, class F>
__device__ __forceinline__ void for_rows(F&& f) {
  if constexpr (ROLL_LOOPS) {
#pragma unroll 1
    for (int r = 0; r < N; ++r) f(r);
  } else {
    static_for<N>(f);
  }
}

// In-place lower Cholesky factor of SPD A (NaN where A is not PD).
template <int N, class S>
__device__ __forceinline__ void chol_factor(S (&A)[N][N]) {
  TRAJOPT_UNROLL
  for (int j = 0; j < N; ++j) {
    S s = A[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= A[j][k] * A[j][k];
    A[j][j] = sqrt(s);
    const S inv = recip(A[j][j]);
    TRAJOPT_UNROLL
    for (int i = j + 1; i < N; ++i) {
      S t = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t -= A[i][k] * A[j][k];
      A[i][j] = t * inv;
    }
  }
}

// Solve L L^T x = b in place, L from chol_factor.
template <int N, class S>
__device__ __forceinline__ void chol_solve(const S (&L)[N][N], S (&b)[N]) {
  TRAJOPT_UNROLL
  for (int i = 0; i < N; ++i) {
    S s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * b[k];
    b[i] = s / L[i][i];
  }
  TRAJOPT_UNROLL
  for (int i = N - 1; i >= 0; --i) {
    S s = b[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) s -= L[k][i] * b[k];
    b[i] = s / L[i][i];
  }
}

// chol_solve with L packed row by row in global memory (entry (i, k <= i)
// at L[(i (i + 1) / 2 + k) * stride]): the same operations in the same
// order.
template <int N>
__device__ __forceinline__ void chol_solve_packed(const double* L,
                                                  long long stride,
                                                  double (&b)[N]) {
  TRAJOPT_UNROLL
  for (int i = 0; i < N; ++i) {
    double s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[(i * (i + 1) / 2 + k) * stride] * b[k];
    b[i] = s / L[(i * (i + 1) / 2 + i) * stride];
  }
  TRAJOPT_UNROLL
  for (int i = N - 1; i >= 0; --i) {
    double s = b[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k)
      s -= L[(k * (k + 1) / 2 + i) * stride] * b[k];
    b[i] = s / L[(i * (i + 1) / 2 + i) * stride];
  }
}

}  // namespace trajopt
