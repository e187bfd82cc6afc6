"""Uniform tensor-product spectral-element grid + C0 global numbering.

Capability parity with the reference's discretization layer (reference
Solvers/SEM.py:11-167): coordinate maps, element/global node constructions,
local→global numbering, gather/scatter.  The key design decisions:

* A global field is stored as a flat vector of length ``N = Ngx·Ngy`` in
  x-major order — exactly the reference's ``global_index`` ordering
  (reference SEM.py:110: ``g = (m·P+i)·(N_ey·P+1) + (n·P+j)``) — which means
  it reshapes *losslessly* to "grid form" ``(Ngx, Ngy)``.  In grid form every
  *linear* global operator is a pair of dense 1D matmuls (see
  ``sem_jax.operators``), a matmul-shaped formulation.
* The local↔global map is a precomputed int32 index array; gather is a single
  ``take`` and C0 assembly (the duplicate-sum of reference SEM.py:123-146) is
  one ``jax.ops.segment_sum`` — both shardable across a device mesh.
* ``Grid2D`` is hashable by its configuration so it can be passed to
  ``jax.jit`` as a static argument; its NumPy constants become compile-time
  constants of the kernels.
"""
from __future__ import annotations

import functools

import numpy as np

from sem_jax import gll

__all__ = ["Grid2D", "xi2x", "x2xi"]


def xi2x(e, xi, dx: float):
    """Physical coordinate from standard coordinate ξ∈[-1,1] in element ``e``.

    Parity with reference SEM.py:11-20 (vectorized; raises on out-of-range ξ).
    """
    xi = np.asarray(xi)
    if np.any(xi > 1) or np.any(xi < -1):
        raise ValueError("xi out of range [-1, 1]")
    return dx / 2 * (xi + 1) + dx * np.asarray(e)


def x2xi(x, dx: float, N_e: int = None):
    """Element number and standard coordinate from physical coordinate.

    Parity with reference SEM.py:23-36 including the boundary-ownership shift
    (e, ξ=-1) → (e-1, ξ=+1) for e>0, so a point on an element interface (and
    the right domain endpoint) belongs to the element on its left.

    :param N_e: optional element count; when given, ``x`` is validated to lie
        inside [0, N_e·dx] (the guardrail the reference enforces through
        ``xi2x``'s range check, reference SEM.py:18-19 — its ``x2xi`` would
        silently hand an out-of-range ξ to downstream evaluation)
    :return: (e int array, xi float array)
    """
    x = np.asarray(x, dtype=np.float64)
    if N_e is not None:
        L = N_e * dx
        tol = 1e-12 * max(1.0, L)
        if np.any(x < -tol) or np.any(x > L + tol):
            raise ValueError(
                f"x out of range [0, {L}]: "
                f"[{float(np.min(x))}, {float(np.max(x))}]")
    frac, e = np.modf(x / dx)
    xi = 2.0 * frac - 1.0
    own = np.isclose(xi, -1.0) & (e > 0)
    e = np.where(own, e - 1, e)
    xi = np.where(own, 1.0, xi)
    return e.astype(int), xi


class Grid2D:
    """Uniform Cartesian spectral-element grid on [0,L_x]×[0,L_y].

    :param P:    polynomial order (same in both directions)
    :param N_ex: number of elements in x
    :param N_ey: number of elements in y
    :param L_x:  domain length in x
    :param L_y:  domain length in y

    Notable attributes (all NumPy, host-resident):

    * ``x_1d``/``y_1d`` — global 1D node coordinates, shapes ``(Ngx,)``/``(Ngy,)``
    * ``gidx`` — local→global index array ``(N_e, P+1, P+1)`` (int32)
    * ``m1x``/``m1y`` — assembled 1D mass vectors (with dx/2, dy/2 metrics)
    * ``K1x``/``K1y`` — assembled 1D stiffness matrices (with 2/dx metric), dense
    * ``G1x``/``G1y`` — assembled 1D weak-gradient matrices (metric-free: the
      2/dx of d/dx cancels the dx/2 of ∫dx, cf. reference SEM.py:221)

    The tensor identity behind the dense-1D operator path: because the mesh,
    the numbering, and every element operator are tensor products, the global
    assembled operator factorizes, e.g. global stiffness
    ``K = K1x ⊗ diag(m1y) + diag(m1x) ⊗ K1y`` (cf. reference SEM.py:186-203
    which assembles the same operator element-by-element into CSR).
    """

    def __init__(self, P: int, N_ex: int, N_ey: int, L_x: float, L_y: float):
        if P < 1 or N_ex < 1 or N_ey < 1:
            raise ValueError("require P >= 1, N_ex >= 1, N_ey >= 1")
        self.P = int(P)
        self.N_ex = int(N_ex)
        self.N_ey = int(N_ey)
        self.L_x = float(L_x)
        self.L_y = float(L_y)
        self.basis = gll.basis(P)

        self.dx = self.L_x / self.N_ex
        self.dy = self.L_y / self.N_ey
        self.Ngx = self.N_ex * P + 1
        self.Ngy = self.N_ey * P + 1
        self.N = self.Ngx * self.Ngy
        self.N_e = self.N_ex * self.N_ey

        # ---- 1D global nodes (shared interface nodes appear once) ----
        self.x_1d = self._global_nodes_1d(self.N_ex, self.dx)
        self.y_1d = self._global_nodes_1d(self.N_ey, self.dy)

        # ---- local -> global numbering ----
        m = np.arange(self.N_ex)[:, None, None, None]
        n = np.arange(self.N_ey)[None, :, None, None]
        i = np.arange(P + 1)[None, None, :, None]
        j = np.arange(P + 1)[None, None, None, :]
        g = (m * P + i) * self.Ngy + (n * P + j)
        self.gidx = g.reshape(self.N_e, P + 1, P + 1).astype(np.int32)
        self.gidx_flat = self.gidx.reshape(-1)

        # ---- assembled 1D operators (dense; sizes <= ~1k at north-star) ----
        w = self.basis.weights
        self.m1x = self._assemble_1d_diag(self.N_ex, self.dx / 2 * w)
        self.m1y = self._assemble_1d_diag(self.N_ey, self.dy / 2 * w)
        self.K1x = self._assemble_1d_mat(self.N_ex, 2 / self.dx * self.basis.K)
        self.K1y = self._assemble_1d_mat(self.N_ey, 2 / self.dy * self.basis.K)
        self.G1x = self._assemble_1d_mat(self.N_ex, self.basis.G)
        self.G1y = self._assemble_1d_mat(self.N_ey, self.basis.G)

        # quadrature-weight outer product per element (ŵᵢŵⱼ), reused by the
        # convection kernels
        self.wq2d = np.multiply.outer(w, w)

        for a in (self.x_1d, self.y_1d, self.gidx, self.m1x, self.m1y,
                  self.K1x, self.K1y, self.G1x, self.G1y, self.wq2d):
            a.setflags(write=False)

    # ------------------------------------------------------------------ #
    def _global_nodes_1d(self, N_e: int, d: float) -> np.ndarray:
        P = self.P
        x = np.empty(N_e * P + 1)
        elem = d / 2 * (self.basis.nodes + 1)
        x[0] = 0.0
        for m in range(N_e):
            x[m * P + 1:(m + 1) * P + 1] = elem[1:] + m * d
        return x

    def _assemble_1d_diag(self, N_e: int, diag_elem: np.ndarray) -> np.ndarray:
        P = self.P
        out = np.zeros(N_e * P + 1)
        for m in range(N_e):
            out[m * P:m * P + P + 1] += diag_elem
        return out

    def _assemble_1d_mat(self, N_e: int, A_elem: np.ndarray) -> np.ndarray:
        P = self.P
        out = np.zeros((N_e * P + 1,) * 2)
        for m in range(N_e):
            out[m * P:m * P + P + 1, m * P:m * P + P + 1] += A_elem
        return out

    # ------------------------------------------------------------------ #
    @functools.cached_property
    def points(self) -> np.ndarray:
        """Global node coordinates ``(2, N)`` in x-major flat order.

        Parity with reference SEM.py:82-94 (``global_nodes``).
        """
        X, Y = np.meshgrid(self.x_1d, self.y_1d, indexing="ij")
        return np.stack([X.reshape(-1), Y.reshape(-1)])

    @functools.cached_property
    def points_e(self) -> np.ndarray:
        """Element node coordinates ``(2, N_ex, N_ey, P+1, P+1)``.

        Parity with reference SEM.py:63-79 (``element_nodes``).
        """
        pts = self.points.reshape(2, self.Ngx, self.Ngy)
        out = np.empty((2, self.N_ex, self.N_ey, self.P + 1, self.P + 1))
        flat = pts.reshape(2, -1)[:, self.gidx_flat]
        return flat.reshape(out.shape)

    @functools.cached_property
    def mass_diag(self) -> np.ndarray:
        """Diagonal of the global (lumped) mass matrix, flat ``(N,)``."""
        return np.multiply.outer(self.m1x, self.m1y).reshape(-1)

    @functools.cached_property
    def KG1x(self) -> np.ndarray:
        """Stacked ``[K1x; G1x]`` (2·Ngx, Ngx): one left matmul computes both
        the stiffness and weak-gradient x-applies — SEM-sized matmuls are
        latency-bound, so fusing applies into fewer, larger matmuls pays."""
        return np.vstack([self.K1x, self.G1x])

    @functools.cached_property
    def KG1yT(self) -> np.ndarray:
        """Stacked ``[K1yᵀ, G1yᵀ]`` (Ngy, 2·Ngy) — right-side analog of
        :attr:`KG1x`."""
        return np.hstack([self.K1y.T, self.G1y.T])

    @functools.cached_property
    def stiff_diag(self) -> np.ndarray:
        """Diagonal of the global stiffness matrix, flat ``(N,)``:
        ``diag(K) = diag(K1x)⊗m1y + m1x⊗diag(K1y)`` (Jacobi scaling)."""
        kx = np.diag(self.K1x)
        ky = np.diag(self.K1y)
        return (np.multiply.outer(kx, self.m1y)
                + np.multiply.outer(self.m1x, ky)).reshape(-1)

    @functools.cached_property
    def multiplicity(self) -> np.ndarray:
        """Number of elements sharing each global node, flat ``(N,)``."""
        out = np.zeros(self.N)
        np.add.at(out, self.gidx_flat, 1.0)
        return out

    # ---- boundary masks (index-based; the grid owns exact coordinates) ---- #
    def side_mask(self, side: str) -> np.ndarray:
        """Boolean mask (flat ``(N,)``) of global nodes on a domain side.

        ``side`` ∈ {'W','E','S','N'} (x=0, x=L_x, y=0, y=L_y).  Equivalent to
        the reference's coordinate matching with ``np.isclose``
        (reference ConvectionDiffusion_Solver.py:62-71) but exact.
        """
        ix = np.arange(self.Ngx)
        iy = np.arange(self.Ngy)
        IX, IY = np.meshgrid(ix, iy, indexing="ij")
        if side == "W":
            m = IX == 0
        elif side == "E":
            m = IX == self.Ngx - 1
        elif side == "S":
            m = IY == 0
        elif side == "N":
            m = IY == self.Ngy - 1
        else:
            raise ValueError(f"unknown side {side!r}")
        return m.reshape(-1)

    @functools.cached_property
    def boundary_mask(self) -> np.ndarray:
        """Mask of all domain-boundary nodes, flat ``(N,)``."""
        return (self.side_mask("W") | self.side_mask("E")
                | self.side_mask("S") | self.side_mask("N"))

    # ------------------------------------------------------------------ #
    def _config(self):
        return (self.P, self.N_ex, self.N_ey, self.L_x, self.L_y)

    def __hash__(self):
        return hash(("Grid2D",) + self._config())

    def __eq__(self, other):
        return isinstance(other, Grid2D) and other._config() == self._config()

    def __repr__(self):
        return (f"Grid2D(P={self.P}, N_ex={self.N_ex}, N_ey={self.N_ey}, "
                f"L_x={self.L_x}, L_y={self.L_y}; N={self.N})")

    @property
    def tag(self) -> str:
        """Compact config string for program labels / cache keys."""
        return f"P{self.P}_{self.N_ex}x{self.N_ey}"
