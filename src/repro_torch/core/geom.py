"""Nekbone box-mesh geometry: elements, geometric factors, masks.

Nekbone discretizes the Poisson equation on a rectangular box split into a
structured ``EX x EY x EZ`` grid of hexahedral elements, each holding
``n^3`` GLL nodes.  All per-element fields use layout ``(E, k, j, i)`` with
``i`` the x-direction (fastest), matching Nekbone's Fortran ``u(i,j,k,e)``
(reversed index order, same memory order).

The Poisson operator needs the 6 unique entries of the symmetric metric
``G = w3 * J * (d xi / d x) (d xi / d x)^T`` per node; for affine box elements
only the diagonal (rr, ss, tt) entries are non-zero.  Entry order follows the
paper's Listing 1: ``(rr, rs, rt, ss, st, tt)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.sem import SEMOperators

__all__ = ["BoxMesh", "random_spd_metric", "axis_mask_factor",
           "axis_mult_factor", "box_axis_factors", "box_outer", "GEOM_RR",
           "GEOM_RS", "GEOM_RT", "GEOM_SS", "GEOM_ST", "GEOM_TT"]

GEOM_RR, GEOM_RS, GEOM_RT, GEOM_SS, GEOM_ST, GEOM_TT = range(6)


def axis_mask_factor(ne: int, n: int) -> np.ndarray:
    """Per-direction Dirichlet factor, shape ``(ne, n)``.

    The box mask is the outer product of these three factors: a node is
    masked iff it sits on the domain boundary in *some* direction, and 0/1
    products realize exactly that.  The v2 kernels (kernels/csrc/) rebuild
    the full mask from them per node — three ``(extent, n)`` arrays instead
    of an ``(E, n^3)`` device-memory stream.
    """
    m = np.ones((ne, n), dtype=np.float64)
    m[0, 0] = 0.0
    m[-1, -1] = 0.0
    return m


def axis_mult_factor(ne: int, n: int) -> np.ndarray:
    """Per-direction node multiplicity, shape ``(ne, n)``.

    A node on an interior element face is shared by 2 elements along that
    direction; multiplicities multiply across directions, so the full
    multiplicity field is the outer product of the three factors.
    """
    m = np.ones((ne, n), dtype=np.float64)
    if ne > 1:
        m[:-1, -1] = 2.0
        m[1:, 0] = 2.0
    return m


def box_axis_factors(shape: tuple[int, int, int], n: int):
    """Per-axis mask and ``c = mask/mult`` factors of the structured box.

    Returns ``((mx, my, mz), (cx, cy, cz))``, each ``(extent, n)`` float64;
    outer products over (z, y, x) reproduce :meth:`BoxMesh.dirichlet_mask`
    and ``mask/multiplicity`` bitwise (every value is an exact binary
    fraction).  The single source of the factorization the v2 kernels
    rebuild per node.
    """
    masks = tuple(axis_mask_factor(ne, n) for ne in shape)
    cs = tuple(axis_mask_factor(ne, n) / axis_mult_factor(ne, n)
               for ne in shape)
    return masks, cs


def box_outer(fz, fy, fx):
    """Outer product of per-axis ``(extent, n)`` factors over the box.

    Returns ``(EZ, EY, EX, n, n, n)`` indexed ``(ez, ey, ex, k, j, i)`` —
    the element-grid view of :meth:`BoxMesh.grid_view`.  Pure broadcasting,
    so it accepts numpy arrays and torch tensors alike; reshape
    ``(-1, n, n, n)`` for the flat element layout.
    """
    return (fz[:, None, None, :, None, None]
            * fy[None, :, None, None, :, None]
            * fx[None, None, :, None, None, :])


@dataclasses.dataclass(frozen=True)
class BoxMesh:
    """Structured box of spectral elements.

    Attributes:
      n:       GLL points per direction per element.
      shape:   element-grid extents ``(EX, EY, EZ)``.
      lengths: physical box size ``(Lx, Ly, Lz)``.
    """

    n: int
    shape: tuple[int, int, int]
    lengths: tuple[float, float, float] = (1.0, 1.0, 1.0)

    # ---- basic sizes -----------------------------------------------------
    @property
    def nelt(self) -> int:
        ex, ey, ez = self.shape
        return ex * ey * ez

    @property
    def nxyz(self) -> int:
        return self.n ** 3

    @property
    def ndof(self) -> int:
        """Element-local (duplicated) degrees of freedom, Nekbone's ``D``."""
        return self.nelt * self.nxyz

    @property
    def nunique(self) -> int:
        """Globally unique grid points."""
        ex, ey, ez = self.shape
        N = self.n - 1
        return (ex * N + 1) * (ey * N + 1) * (ez * N + 1)

    @property
    def element_size(self) -> tuple[float, float, float]:
        ex, ey, ez = self.shape
        lx, ly, lz = self.lengths
        return lx / ex, ly / ey, lz / ez

    @property
    def ops(self) -> SEMOperators:
        return SEMOperators(self.n)

    # ---- element-grid view ----------------------------------------------
    def grid_view(self, u: np.ndarray) -> np.ndarray:
        """Reshape ``(E, n, n, n)`` -> ``(EZ, EY, EX, n, n, n)`` (e = z-major)."""
        ex, ey, ez = self.shape
        return u.reshape((ez, ey, ex) + u.shape[1:])

    # ---- geometry --------------------------------------------------------
    def geometric_factors(self) -> np.ndarray:
        """Metric ``G`` for the Poisson operator, shape ``(E, 6, n, n, n)``.

        For an affine element of physical size (hx, hy, hz):
          J = hx hy hz / 8,  d r/d x = 2/hx (etc., diagonal), so
          G_rr = w3 * J * (2/hx)^2 = w3 * hy*hz / (2*hx),   off-diagonals 0.
        """
        hx, hy, hz = self.element_size
        w3 = self.ops.w3  # (n, n, n), indexed (k, j, i)
        g = np.zeros((self.nelt, 6, self.n, self.n, self.n), dtype=np.float64)
        g[:, GEOM_RR] = w3 * (hy * hz) / (2.0 * hx)
        g[:, GEOM_SS] = w3 * (hx * hz) / (2.0 * hy)
        g[:, GEOM_TT] = w3 * (hx * hy) / (2.0 * hz)
        return g

    def mass(self) -> np.ndarray:
        """Diagonal (lumped) mass matrix entries, shape ``(E, n, n, n)``.

        ``B = w_i w_j w_k * J`` — exact for the GLL-collocated SEM mass.
        """
        hx, hy, hz = self.element_size
        jac = hx * hy * hz / 8.0
        b = np.broadcast_to(self.ops.w3 * jac,
                            (self.nelt, self.n, self.n, self.n))
        return np.ascontiguousarray(b)

    def coords(self) -> np.ndarray:
        """Physical node coordinates, shape ``(E, n, n, n, 3)``."""
        ex, ey, ez = self.shape
        hx, hy, hz = self.element_size
        z1 = (self.ops.z + 1.0) / 2.0  # reference -> [0,1]
        xs = np.zeros((ez, ey, ex, self.n, self.n, self.n, 3))
        for e_z in range(ez):
            for e_y in range(ey):
                for e_x in range(ex):
                    x = (e_x + z1) * hx
                    y = (e_y + z1) * hy
                    z = (e_z + z1) * hz
                    xs[e_z, e_y, e_x, ..., 0] = x[None, None, :]
                    xs[e_z, e_y, e_x, ..., 1] = y[None, :, None]
                    xs[e_z, e_y, e_x, ..., 2] = z[:, None, None]
        return xs.reshape(self.nelt, self.n, self.n, self.n, 3)

    def dirichlet_mask(self) -> np.ndarray:
        """1.0 on interior nodes, 0.0 on the domain boundary, ``(E, n, n, n)``.

        Outer product of the three :func:`axis_mask_factor` arrays — the
        factorization the slab kernels exploit to avoid streaming the mask.
        """
        ex, ey, ez = self.shape
        m = box_outer(axis_mask_factor(ez, self.n),
                      axis_mask_factor(ey, self.n),
                      axis_mask_factor(ex, self.n))
        return np.ascontiguousarray(m.reshape(self.nelt, self.n, self.n, self.n))

    def multiplicity(self) -> np.ndarray:
        """Number of elements sharing each node, ``(E, n, n, n)``.

        Computed structurally: outer product of the three
        :func:`axis_mult_factor` arrays (faces -> 2, edges -> 4,
        corners -> 8).
        """
        ex, ey, ez = self.shape
        m = box_outer(axis_mult_factor(ez, self.n),
                      axis_mult_factor(ey, self.n),
                      axis_mult_factor(ex, self.n))
        return np.ascontiguousarray(m.reshape(self.nelt, self.n, self.n, self.n))


def random_spd_metric(rng: np.random.Generator, nelt: int, n: int,
                      jitter: float = 0.2) -> np.ndarray:
    """Random symmetric-positive-definite metric, shape ``(E, 6, n, n, n)``.

    Used by property tests: the Poisson operator built from any SPD metric
    must itself be symmetric positive semi-definite.
    """
    # Build G = L L^T + eps*I from a random L per node, then scale.
    L = rng.normal(size=(nelt, 3, 3, n, n, n)) * jitter
    L = L + np.eye(3)[None, :, :, None, None, None]
    G = np.einsum("eab...,ecb...->eac...", L, L)
    out = np.empty((nelt, 6, n, n, n))
    out[:, GEOM_RR] = G[:, 0, 0]
    out[:, GEOM_RS] = G[:, 0, 1]
    out[:, GEOM_RT] = G[:, 0, 2]
    out[:, GEOM_SS] = G[:, 1, 1]
    out[:, GEOM_ST] = G[:, 1, 2]
    out[:, GEOM_TT] = G[:, 2, 2]
    return out
