"""Small SPD solves, unrolled (counterpart of `trajoptkp_tpu/utils/linalg.py:22-90`).

Matrices are (n, n, *L) with the batch axes last; n is small and static
(nv <= ~10 on this slice), so the factorisation is unrolled into elementwise
tensor arithmetic over the lanes.  These are the plain twins of the
Cholesky that the kernels run per thread.
"""

from __future__ import annotations

import torch


def chol_unrolled(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD A (n, n, *L); NaN where A is not PD."""
    n = A.shape[0]
    L = [[None] * n for _ in range(n)]
    zero = torch.zeros_like(A[0, 0])
    for j in range(n):
        s = A[j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(s)
        inv = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    return torch.stack([
        torch.stack([L[i][j] if j <= i else zero for j in range(n)])
        for i in range(n)
    ])


def chol_solve_unrolled(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given L = chol(A); b is (n, *R) with R broadcasting
    against L's batch axes (a vector rhs (n, *L) or a matrix (n, m, *L) —
    for the matrix form L's factors are broadcast over the m axis)."""
    n = L.shape[0]
    extra = b.dim() - (L.dim() - 1)  # rhs axes between n and the lanes

    def l(i, k):
        x = L[i, k]
        return x.reshape((1,) * extra + tuple(x.shape)) if extra else x

    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - l(i, k) * y[k]
        y[i] = s / l(i, i)
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l(k, i) * x[k]
        x[i] = s / l(i, i)
    return torch.stack(x)


def sym_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve SPD A x = b by the unrolled Cholesky."""
    return chol_solve_unrolled(chol_unrolled(A), b)
