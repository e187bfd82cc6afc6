"""Tests of the jit GMRES/CG solvers and the fast-diagonalization solver."""
import numpy as np
import pytest
import jax.numpy as jnp

from sem_jax import operators as ops
from sem_jax.fdm import FDM2D
from sem_jax.krylov import cg, gmres
from sem_jax.mesh import Grid2D
from tests import oracles

RNG = np.random.default_rng(42)


def _random_system(n, sym=False, cond=50.0):
    Q, _ = np.linalg.qr(RNG.standard_normal((n, n)))
    d = np.linspace(1.0, cond, n)
    if sym:
        A = (Q * d) @ Q.T
    else:
        Q2, _ = np.linalg.qr(RNG.standard_normal((n, n)))
        A = (Q * d) @ Q2.T
    x = RNG.standard_normal(n)
    return A, x, A @ x


@pytest.mark.parametrize("sym", [False, True])
def test_gmres_full_window(sym):
    """Full-window GMRES is a direct method: converges in <= n iterations."""
    A, x_true, b = _random_system(80, sym=sym)
    Aj = jnp.asarray(A)
    x, info = gmres(lambda v: Aj @ v, jnp.asarray(b), atol=1e-10,
                    restart=85, maxiter=300)
    assert bool(info.converged)
    assert int(info.iterations) <= 80
    np.testing.assert_allclose(np.asarray(x), x_true, rtol=1e-7, atol=1e-8)
    # true residual really is below the tolerance
    assert np.linalg.norm(A @ np.asarray(x) - b) <= 1e-9


def test_gmres_restarted():
    """Restarted GMRES on a diagonally-dominant (well-behaved) system."""
    n = 120
    A = 10.0 * np.eye(n) + RNG.standard_normal((n, n)) / np.sqrt(n)
    x_true = RNG.standard_normal(n)
    b = A @ x_true
    Aj = jnp.asarray(A)
    x, info = gmres(lambda v: Aj @ v, jnp.asarray(b), atol=1e-10,
                    restart=15, maxiter=500)
    assert bool(info.converged)
    np.testing.assert_allclose(np.asarray(x), x_true, rtol=1e-8, atol=1e-9)


def test_gmres_preconditioned_converges_fast():
    A, x_true, b = _random_system(120, sym=False, cond=1e4)
    Aj = jnp.asarray(A)
    Minv = jnp.asarray(np.linalg.inv(A))  # perfect preconditioner
    x, info = gmres(lambda v: Aj @ v, jnp.asarray(b), atol=1e-10,
                    restart=20, maxiter=500, precon=lambda r: Minv @ r)
    assert bool(info.converged)
    assert int(info.iterations) <= 3
    np.testing.assert_allclose(np.asarray(x), x_true, rtol=1e-8)


def test_gmres_warm_start_and_zero_rhs():
    A, x_true, b = _random_system(50)
    Aj = jnp.asarray(A)
    # exact warm start: converges immediately
    x, info = gmres(lambda v: Aj @ v, jnp.asarray(b),
                    x0=jnp.asarray(x_true), atol=1e-9, restart=10, maxiter=100)
    assert bool(info.converged)
    assert int(info.iterations) == 0
    # zero RHS: returns zero
    x, info = gmres(lambda v: Aj @ v, jnp.zeros(50), atol=1e-12,
                    restart=10, maxiter=100)
    assert bool(info.converged)
    np.testing.assert_allclose(np.asarray(x), 0.0, atol=1e-12)


def test_gmres_maxiter_flags_nonconvergence():
    A, _, b = _random_system(60, cond=1e6)
    Aj = jnp.asarray(A)
    x, info = gmres(lambda v: Aj @ v, jnp.asarray(b), atol=1e-14,
                    restart=5, maxiter=8)
    assert not bool(info.converged)
    # exits either at maxiter or earlier via stagnation detection
    assert int(info.iterations) <= 8
    assert bool(info.stalled) or int(info.iterations) == 8


def test_gmres_dgks_eta_controls_resweeps():
    """The DGKS threshold bounds the resweep count: η→∞-like (1.0+) resweeps
    every iteration, η=0 never does, and both still converge on a
    well-conditioned system (orthogonality loss only costs iterations);
    ``KrylovInfo.resweeps`` reports the count."""
    n = 60
    A = 10.0 * np.eye(n) + RNG.standard_normal((n, n)) / np.sqrt(n)
    x_true = RNG.standard_normal(n)
    b = A @ x_true
    Aj = jnp.asarray(A)

    x1, i1 = gmres(lambda v: Aj @ v, jnp.asarray(b), atol=1e-10,
                   restart=20, maxiter=300, dgks_eta=2.0)
    assert int(i1.resweeps) == int(i1.iterations)
    x0, i0 = gmres(lambda v: Aj @ v, jnp.asarray(b), atol=1e-10,
                   restart=20, maxiter=300, dgks_eta=0.0)
    assert int(i0.resweeps) == 0
    for x, info in ((x1, i1), (x0, i0)):
        assert bool(info.converged)
        np.testing.assert_allclose(np.asarray(x), x_true, rtol=1e-7,
                                   atol=1e-8)


def test_fgmres_basis_dtype_and_varying_precon():
    """fgmres honors basis_dtype (bf16 Arnoldi basis, f32 arithmetic and
    flexible basis) and converges under a deliberately VARYING right
    preconditioner — the contract the row-scaled flexible chunks rely on."""
    from sem_jax.krylov import fgmres

    n = 96
    A = 10.0 * np.eye(n) + RNG.standard_normal((n, n)) / np.sqrt(n)
    x_true = RNG.standard_normal(n)
    b = (A @ x_true).astype(np.float32)
    Aj = jnp.asarray(A, jnp.float32)

    def precon(r):
        # varies per application: alternating damping (nonlinear in call
        # order, linear per call) — plain GMRES would break on this
        return r / 10.0 * (1.0 + 0.3 * jnp.sin(jnp.sum(jnp.abs(r))))

    x, info, _ = fgmres(lambda v: Aj @ v, jnp.asarray(b), atol=1e-4,
                        restart=30, maxiter=300, precon=precon,
                        basis_dtype=jnp.bfloat16)
    assert bool(info.converged)
    got = np.asarray(x, np.float64)
    assert np.linalg.norm(A @ got - np.asarray(b, np.float64)) <= 1e-4
    np.testing.assert_allclose(got, x_true, rtol=2e-4, atol=2e-4)


def test_cg_spd():
    A, x_true, b = _random_system(90, sym=True)
    Aj = jnp.asarray(A)
    x, info = cg(lambda v: Aj @ v, jnp.asarray(b), atol=1e-10, maxiter=2000)
    assert bool(info.converged)
    np.testing.assert_allclose(np.asarray(x), x_true, rtol=1e-7, atol=1e-8)


# ------------------------- FDM direct solver ------------------------- #

@pytest.fixture(scope="module")
def grid():
    return Grid2D(P=4, N_ex=3, N_ey=2, L_x=1.0, L_y=1.4)


def masked_dense_stiffness(grid, dx_mask, dy_mask):
    """Dense masked Laplacian oracle: identity rows on Dirichlet nodes."""
    K = oracles.dense_stiffness(grid)
    ix = np.arange(grid.Ngx)
    iy = np.arange(grid.Ngy)
    IX, IY = np.meshgrid(ix, iy, indexing="ij")
    bm = np.zeros((grid.Ngx, grid.Ngy), dtype=bool)
    if dx_mask[0]:
        bm |= IX == 0
    if dx_mask[1]:
        bm |= IX == grid.Ngx - 1
    if dy_mask[0]:
        bm |= IY == 0
    if dy_mask[1]:
        bm |= IY == grid.Ngy - 1
    bmf = bm.reshape(-1)
    K[bmf, :] = 0.0
    K[bmf, bmf] = 1.0
    return K


@pytest.mark.parametrize("dx_mask,dy_mask", [
    ((True, True), (True, True)),     # all-Dirichlet (velocity blocks)
    ((True, True), (False, False)),   # W/E Dirichlet, N/S Neumann (CD example)
    ((False, True), (True, False)),   # mixed corners
])
def test_fdm_exact_inverse(grid, dx_mask, dy_mask):
    K = masked_dense_stiffness(grid, dx_mask, dy_mask)
    fdm = FDM2D(grid, dirichlet_x=dx_mask, dirichlet_y=dy_mask)
    r = RNG.standard_normal(grid.N)
    x = np.asarray(fdm.solve(jnp.asarray(r)))
    np.testing.assert_allclose(K @ x, r, rtol=1e-9, atol=1e-9)


def test_fdm_with_mass_shift(grid):
    """FDM inverts (K + αM) exactly as well."""
    alpha = 3.7
    K = masked_dense_stiffness(grid, (True, True), (True, True))
    M = oracles.dense_mass(grid)
    bm = grid.boundary_mask
    A = K.copy()
    A[~bm, :] += alpha * M[~bm, :]
    fdm = FDM2D(grid, alpha=alpha)
    r = RNG.standard_normal(grid.N)
    x = np.asarray(fdm.solve(jnp.asarray(r)))
    np.testing.assert_allclose(A @ x, r, rtol=1e-9, atol=1e-9)


def test_fdm_pure_neumann_pseudoinverse(grid):
    """No Dirichlet side: pseudo-inverse on the complement of constants."""
    fdm = FDM2D(grid, dirichlet_x=(False, False), dirichlet_y=(False, False))
    r = RNG.standard_normal(grid.N)
    # project RHS onto range(K): K is symmetric with constant nullspace, so
    # solvability requires 1ᵀr = 0
    r = r - r.mean()
    x = np.asarray(fdm.solve(jnp.asarray(r)))
    got = np.asarray(ops.apply_stiffness(grid, jnp.asarray(x)))
    np.testing.assert_allclose(got, r, rtol=1e-8, atol=1e-9)


def test_fdm_as_poisson_solver(grid):
    """Solve -∇²u = f with u=g on all walls, manufactured solution."""
    x, y = grid.points
    u_exact = np.sin(np.pi * x) * np.cos(2 * y) + x * y
    # weak-form RHS: K u_exact (interior rows), boundary rows carry u values
    Ku = np.asarray(ops.apply_stiffness(grid, jnp.asarray(u_exact)))
    bm = grid.boundary_mask
    rhs = np.where(bm, u_exact, Ku)
    fdm = FDM2D(grid)
    u = np.asarray(fdm.solve(jnp.asarray(rhs)))
    np.testing.assert_allclose(u, u_exact, rtol=1e-10, atol=1e-10)
