"""Field evaluation at arbitrary tensor-product points + cross-mesh transfer.

Replaces the reference's per-element ``eval_interpolation`` loop (reference
SEM.py:248-273) and the per-call re-interpolation inside the coupling
components (reference ConvectionDiffusion_Component.py:23-36) with
*precomputed global 1D evaluation matrices*: for tensor-product query points
``(xq ⊗ yq)`` the evaluation of a SEM field ``U`` (grid form) is::

    U_plot = Ex @ U @ Eyᵀ

where ``Ex[a, m·P+j] = ℓⱼ(ξ(xq[a]))`` places each query point's Lagrange row
into the columns of the element that owns it (ownership per the reference's
``x2xi`` boundary shift, reference SEM.py:33-35).  Building ``Ex/Ey`` is a
one-time host-side cost; each apply is two dense matmuls — this also makes the
CD↔NS cross-mesh transfer a pair of static matrices (a genuine upgrade over
the reference, which re-interpolated through Python loops on every coupling
residual evaluation).
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from sem_jax import gll
from sem_jax.mesh import Grid2D, x2xi

__all__ = ["eval_matrix_1d", "eval_field", "transfer_matrices", "apply_transfer"]


def eval_matrix_1d(P: int, N_e: int, d: float, xq: np.ndarray) -> np.ndarray:
    """Global 1D evaluation matrix ``(len(xq), N_e·P+1)``.

    Row ``a`` evaluates a 1D SEM interpolant at ``xq[a]``: locate the owning
    element, evaluate the order-P Lagrange basis at the local coordinate, and
    scatter into that element's global columns.
    """
    xq = np.asarray(xq, dtype=np.float64)
    e, xi = x2xi(xq, d, N_e=N_e)   # validates xq ∈ [0, N_e·d]
    e = np.clip(e, 0, N_e - 1)
    S = gll.standard_evaluation_matrix(P, xi)  # (nq, P+1) rows at local ξ
    E = np.zeros((xq.size, N_e * P + 1))
    for a in range(xq.size):
        E[a, e[a] * P:e[a] * P + P + 1] = S[a]
    return E


class PointEvaluator:
    """Precomputed evaluator of grid fields at fixed tensor-product points.

    :param grid: source grid
    :param points_plot: ``(X, Y)`` ij-indexed meshgrid arrays (the reference's
        plotting-points convention, reference SEM.py:253)
    """

    def __init__(self, grid: Grid2D, points_plot):
        X, Y = points_plot
        X = np.asarray(X)
        Y = np.asarray(Y)
        self.shape = X.shape
        self._Ex = eval_matrix_1d(grid.P, grid.N_ex, grid.dx, X[:, 0])
        self._Ey = eval_matrix_1d(grid.P, grid.N_ey, grid.dy, Y[0, :])
        self._grid = grid

    @functools.partial(jax.jit, static_argnums=0)
    def _apply(self, f: jax.Array) -> jax.Array:
        U = f.reshape(self._grid.Ngx, self._grid.Ngy)
        Ex = jnp.asarray(self._Ex.astype(f.dtype))
        Ey = jnp.asarray(self._Ey.astype(f.dtype))
        hi = jax.lax.Precision.HIGHEST
        return jnp.matmul(jnp.matmul(Ex, U, precision=hi), Ey.T,
                          precision=hi)

    def __call__(self, f) -> np.ndarray:
        return np.asarray(self._apply(jnp.asarray(f)))

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


def eval_field(grid: Grid2D, f, points_plot) -> np.ndarray:
    """One-shot evaluation (builds the evaluator; prefer PointEvaluator for
    repeated use).  Parity with reference SEM.py:248-273."""
    return PointEvaluator(grid, points_plot)(f)


@functools.lru_cache(maxsize=None)
def transfer_matrices(src: Grid2D, dst: Grid2D):
    """1D transfer matrices re-basing a field from ``src`` onto ``dst`` nodes.

    The linear map behind the reference's ``change_inputs`` cross-mesh
    coupling (reference ConvectionDiffusion_Component.py:23-36,
    NavierStokes_Component.py:23-33), which lets the disciplines run at
    different (P, N_e).  Returns ``(Ex, Ey)`` with shapes
    ``(dst.Ngx, src.Ngx)``, ``(dst.Ngy, src.Ngy)``.
    """
    Ex = eval_matrix_1d(src.P, src.N_ex, src.dx, dst.x_1d)
    Ey = eval_matrix_1d(src.P, src.N_ey, src.dy, dst.y_1d)
    return Ex, Ey


@functools.partial(jax.jit, static_argnums=(0, 1))
def apply_transfer(src: Grid2D, dst: Grid2D, f: jax.Array) -> jax.Array:
    """Re-basis a flat global vector from ``src`` to ``dst`` (linear map)."""
    Ex, Ey = transfer_matrices(src, dst)
    U = f.reshape(src.Ngx, src.Ngy)
    Exj = jnp.asarray(Ex.astype(f.dtype))
    Eyj = jnp.asarray(Ey.astype(f.dtype))
    hi = jax.lax.Precision.HIGHEST
    return jnp.matmul(jnp.matmul(Exj, U, precision=hi), Eyj.T,
                      precision=hi).reshape(-1)
