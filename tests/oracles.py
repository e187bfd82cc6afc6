"""Independent dense NumPy oracles for operator tests.

These build the global Galerkin operators *densely and naively from the
mathematical definition* (loop over elements, accumulate into dense global
matrices via the local→global map).  They deliberately share no code with
``sem_jax.operators`` (which uses tensor-product factorizations and
segment-sums), so agreement is a real cross-check.
"""
import numpy as np

from sem_jax import gll
from sem_jax.mesh import Grid2D


def local_to_global(grid: Grid2D, m, n, i, j):
    return (m * grid.P + i) * grid.Ngy + (n * grid.P + j)


def dense_mass(grid: Grid2D):
    P, w = grid.P, grid.basis.weights
    A = np.zeros((grid.N, grid.N))
    for m in range(grid.N_ex):
        for n in range(grid.N_ey):
            for i in range(P + 1):
                for j in range(P + 1):
                    g = local_to_global(grid, m, n, i, j)
                    A[g, g] += (grid.dx / 2 * w[i]) * (grid.dy / 2 * w[j])
    return A


def dense_stiffness(grid: Grid2D):
    P, w = grid.P, grid.basis.weights
    Ks = grid.basis.K
    A = np.zeros((grid.N, grid.N))
    for m in range(grid.N_ex):
        for n in range(grid.N_ey):
            for i in range(P + 1):
                for j in range(P + 1):
                    gi = local_to_global(grid, m, n, i, j)
                    for k in range(P + 1):
                        # x-derivative part: (2/dx)Ks_ik * (dy/2)w_j δ_jl
                        gk = local_to_global(grid, m, n, k, j)
                        A[gi, gk] += (2 / grid.dx) * Ks[i, k] * (grid.dy / 2) * w[j]
                        # y-derivative part: (dx/2)w_i δ_ik * (2/dy)Ks_jl
                        gl = local_to_global(grid, m, n, i, k)
                        A[gi, gl] += (grid.dx / 2) * w[i] * (2 / grid.dy) * Ks[j, k]
    return A


def dense_grad_x(grid: Grid2D):
    P, w = grid.P, grid.basis.weights
    Gs = grid.basis.G
    A = np.zeros((grid.N, grid.N))
    for m in range(grid.N_ex):
        for n in range(grid.N_ey):
            for i in range(P + 1):
                for j in range(P + 1):
                    gi = local_to_global(grid, m, n, i, j)
                    for k in range(P + 1):
                        gk = local_to_global(grid, m, n, k, j)
                        A[gi, gk] += Gs[i, k] * (grid.dy / 2) * w[j]
    return A


def dense_grad_y(grid: Grid2D):
    P, w = grid.P, grid.basis.weights
    Gs = grid.basis.G
    A = np.zeros((grid.N, grid.N))
    for m in range(grid.N_ex):
        for n in range(grid.N_ey):
            for i in range(P + 1):
                for j in range(P + 1):
                    gi = local_to_global(grid, m, n, i, j)
                    for k in range(P + 1):
                        gk = local_to_global(grid, m, n, i, k)
                        A[gi, gk] += (grid.dx / 2) * w[i] * Gs[j, k]
    return A


def dense_convection_tensors(grid: Grid2D):
    """Global rank-3 convection tensors C_x, C_y as dense (N,N,N) arrays.

    C_x[a,b,c] = ∫ φ_a φ_b ∂x φ_c ; C_y likewise with ∂y.  Tiny grids only.
    """
    P, w = grid.P, grid.basis.weights
    D = grid.basis.D
    Cx = np.zeros((grid.N,) * 3)
    Cy = np.zeros((grid.N,) * 3)
    for m in range(grid.N_ex):
        for n in range(grid.N_ey):
            for i in range(P + 1):
                for j in range(P + 1):
                    ga = local_to_global(grid, m, n, i, j)
                    for k in range(P + 1):
                        # x: w_i w_j (dy/2) δ(a,b) D_ik at column (k,j)
                        gc = local_to_global(grid, m, n, k, j)
                        Cx[ga, ga, gc] += w[i] * w[j] * (grid.dy / 2) * D[i, k]
                        gc = local_to_global(grid, m, n, i, k)
                        Cy[ga, ga, gc] += w[i] * w[j] * (grid.dx / 2) * D[j, k]
    return Cx, Cy


def lagrange_value(P: int, j: int, xi: float) -> float:
    """ℓ_j(ξ) by the direct product formula (independent of gll internals)."""
    nodes = gll.nodes_weights(P)[0]
    val = 1.0
    for k in range(P + 1):
        if k != j:
            val *= (xi - nodes[k]) / (nodes[j] - nodes[k])
    return val
