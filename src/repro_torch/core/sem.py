"""Spectral-element method (SEM) 1-D building blocks.

Gauss-Lobatto-Legendre (GLL) nodes/weights and the spectral differentiation
matrix, exactly as used by Nekbone/Nek5000 (``zwgll`` / ``dgll`` in speclib).

Everything here is tiny (n <= ~32) and computed once at setup time, so it is
done in float64 numpy for accuracy and cast to the requested dtype by callers.
"""
from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "legendre",
    "gll_points_weights",
    "derivative_matrix",
    "SEMOperators",
]


def legendre(N: int, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Legendre polynomial P_N and derivative P'_N at points ``x``.

    Uses the three-term recurrence; stable for the small N used in SEM.
    """
    x = np.asarray(x, dtype=np.float64)
    p0 = np.ones_like(x)
    if N == 0:
        return p0, np.zeros_like(x)
    p1 = x
    for k in range(1, N):
        p0, p1 = p1, ((2 * k + 1) * x * p1 - k * p0) / (k + 1)
    # derivative from the standard identity (1-x^2) P_N' = N (P_{N-1} - x P_N)
    with np.errstate(divide="ignore", invalid="ignore"):
        dp = N * (p0 - x * p1) / (1.0 - x * x)
    # endpoints: P_N'(+-1) = (+-1)^{N-1} N(N+1)/2
    endval = N * (N + 1) / 2.0
    dp = np.where(x == 1.0, endval, dp)
    dp = np.where(x == -1.0, (-1.0) ** (N - 1) * endval, dp)
    return p1, dp


@functools.lru_cache(maxsize=64)
def gll_points_weights(n: int) -> tuple[np.ndarray, np.ndarray]:
    """``n`` GLL points (degree N = n-1) and quadrature weights on [-1, 1].

    Points are the roots of (1-x^2) P'_N(x); weights w_i = 2/(N(N+1) P_N(x_i)^2).
    """
    if n < 2:
        raise ValueError(f"GLL rule needs n >= 2, got {n}")
    N = n - 1
    # Chebyshev-Gauss-Lobatto initial guess, then Newton on q(x) = P'_N(x).
    x = -np.cos(np.pi * np.arange(n) / N)
    for _ in range(100):
        p, dp = legendre(N, x)
        # q = (1-x^2) P'_N ; interior roots are roots of P'_N.
        # Newton for P'_N: P''_N from the Legendre ODE:
        # (1-x^2) P''_N = 2x P'_N - N(N+1) P_N
        with np.errstate(divide="ignore", invalid="ignore"):
            d2p = (2.0 * x * dp - N * (N + 1) * p) / (1.0 - x * x)
        dx = np.zeros_like(x)
        interior = slice(1, n - 1)
        dx[interior] = dp[interior] / d2p[interior]
        x = x - dx
        if np.max(np.abs(dx)) < 1e-15:
            break
    x[0], x[-1] = -1.0, 1.0
    p, _ = legendre(N, x)
    w = 2.0 / (N * (N + 1) * p * p)
    return x, w


@functools.lru_cache(maxsize=64)
def derivative_matrix(n: int) -> np.ndarray:
    """Spectral differentiation matrix D on the n GLL points.

    ``D[i, j] = dl_j/dx (x_i)`` where l_j are the Lagrange cardinal functions,
    i.e. ``(du/dx)(x_i) = sum_j D[i, j] u(x_j)`` — Nekbone's ``dxm1``.
    """
    x, _ = gll_points_weights(n)
    N = n - 1
    p, _ = legendre(N, x)
    D = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        for j in range(n):
            if i != j:
                D[i, j] = p[i] / (p[j] * (x[i] - x[j]))
    D[0, 0] = -N * (N + 1) / 4.0
    D[N, N] = N * (N + 1) / 4.0
    return D


class SEMOperators:
    """Bundle of per-degree SEM reference operators (numpy, float64).

    Attributes:
      n:      GLL points per direction (= degree + 1)
      z, w:   1-D GLL nodes and weights, shape (n,)
      D:      differentiation matrix, shape (n, n)  (Nekbone dxm1)
      Dt:     D transpose (Nekbone dxtm1)
      w3:     3-D quadrature weights w_i w_j w_k, shape (n, n, n)
    """

    def __init__(self, n: int):
        self.n = int(n)
        self.z, self.w = gll_points_weights(self.n)
        self.D = derivative_matrix(self.n)
        self.Dt = self.D.T.copy()
        self.w3 = (
            self.w[:, None, None] * self.w[None, :, None] * self.w[None, None, :]
        )

    def __repr__(self) -> str:  # pragma: no cover - debug nicety
        return f"SEMOperators(n={self.n})"
