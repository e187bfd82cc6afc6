"""Explicit global operator assembly — interop/debugging parity layer.

The framework's compute path is matrix-free (see ``sem_jax.operators``), but
the reference exposes explicit assembled operators (reference SEM.py:113-245:
``assemble``, ``global_mass_matrix``, ``global_stiffness_matrix``,
``global_gradient_matrices``, ``global_convection_matrices``) and users may
rely on them for inspection, interop with SciPy tooling, or custom BCs.  This
module provides the same capability:

* :func:`assemble` — the generic duplicate-summing assembler: a per-element
  array becomes a global vector (4-d input), a SciPy CSR matrix (6-d), or a
  rank-3 sparse object (8-d), matching the reference's shape conventions.
* ``global_*_matrix`` constructors mirroring reference SEM.py:170-245.
* The convection "3-tensors" are returned as a :class:`ConvectionTensor`
  wrapper around the assembled weak-gradient matrix — by the super-diagonal
  GLL product identity (see ``sem_jax.operators.apply_convection``) the
  rank-3 tensor satisfies ``C[a,b,c] = δ_ab·G[a,c]``, so both contraction
  slots the reference uses (left velocity slot, right transported slot,
  reference SEM.py:230-231) are exact sparse products without ever storing
  O(N³) data.

Not used anywhere in the solve path; complexity is O(nnz) host work.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from sem_jax.mesh import Grid2D

__all__ = [
    "assemble",
    "global_mass_matrix",
    "global_stiffness_matrix",
    "global_gradient_matrices",
    "global_convection_matrices",
    "ConvectionTensor",
]


def assemble(grid: Grid2D, A_e: np.ndarray, as_pydata_sparse: bool = False):
    """Duplicate-summing assembly of a per-element array.

    :param A_e: element array with leading dims ``(N_ex, N_ey)`` and one
        (vector), two (matrix), or three (rank-3) local ``(P+1, P+1)`` index
        pairs — the reference's 4-d / 6-d / 8-d conventions
        (reference SEM.py:113-146).
    :param as_pydata_sparse: 8-d case only — return a PyData ``sparse.COO``
        (the reference's return type, reference SEM.py:139-145; duplicate
        coordinates sum, as there) instead of the canonical dict.  Raises
        ``ImportError`` when the optional ``sparse`` package is absent.
    :return: NumPy vector (4-d), SciPy CSR (6-d), or a COO-triple dict
        ``{"coords": (3, nnz), "data": (nnz,), "shape": (N, N, N)}`` with
        duplicate coordinates left unsummed (8-d; one canonical type
        regardless of which optional packages are importable)
    """
    P1 = grid.P + 1
    expect = (grid.N_ex, grid.N_ey)
    if A_e.shape[:2] != expect or any(s != P1 for s in A_e.shape[2:]):
        raise ValueError(f"element array shape {A_e.shape} does not match "
                         f"grid {expect} with P+1={P1}")
    g = grid.gidx.reshape(grid.N_ex, grid.N_ey, P1, P1)

    if A_e.ndim == 4:
        out = np.zeros(grid.N)
        np.add.at(out, g.reshape(-1), A_e.reshape(-1))
        return out
    if A_e.ndim == 6:
        rows = np.broadcast_to(g[:, :, :, :, None, None], A_e.shape)
        cols = np.broadcast_to(g[:, :, None, None, :, :], A_e.shape)
        return sp.coo_matrix(
            (A_e.reshape(-1), (rows.reshape(-1), cols.reshape(-1))),
            shape=(grid.N, grid.N)).tocsr()
    if A_e.ndim == 8:
        i1 = np.broadcast_to(g[:, :, :, :, None, None, None, None], A_e.shape)
        i2 = np.broadcast_to(g[:, :, None, None, :, :, None, None], A_e.shape)
        i3 = np.broadcast_to(g[:, :, None, None, None, None, :, :], A_e.shape)
        nz = A_e != 0
        coords = np.stack([i1[nz], i2[nz], i3[nz]])
        data, shape = A_e[nz], (grid.N,) * 3
        if as_pydata_sparse:
            import sparse  # optional dependency; ImportError is the caller's

            return sparse.COO(coords, data, shape=shape)
        return {"coords": coords, "data": data, "shape": shape}
    raise ValueError("element array must be 4-, 6-, or 8-dimensional")


def global_mass_matrix(grid: Grid2D) -> sp.csr_matrix:
    """Assembled (diagonal) global mass matrix (reference SEM.py:170-183)."""
    return sp.diags(grid.mass_diag).tocsr()


def global_stiffness_matrix(grid: Grid2D) -> sp.csr_matrix:
    """Assembled global stiffness matrix (reference SEM.py:186-203), built
    from the 1D tensor-product factorization."""
    Mx = sp.diags(grid.m1x)
    My = sp.diags(grid.m1y)
    return (sp.kron(sp.csr_matrix(grid.K1x), My)
            + sp.kron(Mx, sp.csr_matrix(grid.K1y))).tocsr()


def global_gradient_matrices(grid: Grid2D):
    """Assembled weak-gradient matrices (reference SEM.py:206-223)."""
    Mx = sp.diags(grid.m1x)
    My = sp.diags(grid.m1y)
    Gx = sp.kron(sp.csr_matrix(grid.G1x), My).tocsr()
    Gy = sp.kron(Mx, sp.csr_matrix(grid.G1y)).tocsr()
    return Gx, Gy


class ConvectionTensor:
    """The assembled rank-3 convection tensor ``C[a,b,c] = δ_ab · G[a,c]``.

    Exposes the two contractions the reference performs with PyData-sparse
    tensordots (reference ConvectionDiffusion_Solver.py:82-83, :101-102)
    without storing O(N³) data.
    """

    def __init__(self, G: sp.csr_matrix):
        self.G = G
        self.shape = (G.shape[0],) * 3

    def left(self, u: np.ndarray) -> sp.csr_matrix:
        """``tensordot(C, u, (1, 0))`` → the matrix ``diag(u) @ G``."""
        return sp.diags(u) @ self.G

    def right(self, f: np.ndarray) -> sp.csr_matrix:
        """``tensordot(C, f, (2, 0))`` → the diagonal matrix ``diag(G f)``."""
        return sp.diags(self.G @ f)


def global_convection_matrices(grid: Grid2D):
    """Assembled convection 3-tensors (reference SEM.py:226-245) as
    :class:`ConvectionTensor` wrappers."""
    Gx, Gy = global_gradient_matrices(grid)
    return ConvectionTensor(Gx), ConvectionTensor(Gy)
