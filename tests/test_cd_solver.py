"""Convection-diffusion solver tests: dense-oracle parity + manufactured
solutions with spectral convergence (SURVEY.md §7.2 step 5 acceptance)."""
import numpy as np
import pytest
import jax.numpy as jnp

from sem_jax import ConvectionDiffusionSolver
from tests import oracles

RNG = np.random.default_rng(7)


def dense_cd_system(cd, u, v):
    """Dense masked system matrix + RHS oracle for the CD problem."""
    g = cd.grid
    K = oracles.dense_stiffness(g)
    Cx, Cy = oracles.dense_convection_tensors(g)
    Sys = cd._Pe * (np.einsum("abc,b->ac", Cx, u)
                    + np.einsum("abc,b->ac", Cy, v)) + K
    mask = np.asarray(cd._mask_dir)
    A = Sys.copy()
    A[mask, :] = 0.0
    A[mask, mask] = 1.0
    b = np.zeros(g.N)
    b[mask] = np.asarray(cd._dirichlet)[mask]
    return A, b


def test_cd_matches_dense_direct_solve():
    """Full matrix-free solve == dense masked direct solve (tiny grid)."""
    cd = ConvectionDiffusionSolver(1.0, 1.3, Pe=5.0, P=3, N_ex=2, N_ey=2,
                                   T_W=0.5, T_E=-0.5, T_S=None, T_N=1.0,
                                   mtol=1e-12)
    u = RNG.standard_normal(cd.N) * 0.3
    v = RNG.standard_normal(cd.N) * 0.3
    A, b = dense_cd_system(cd, u, v)
    T_dense = np.linalg.solve(A, b)
    T = np.asarray(cd._get_solution(jnp.asarray(u), jnp.asarray(v)))
    np.testing.assert_allclose(T, T_dense, rtol=1e-8, atol=1e-9)


def test_cd_residual_and_jacobian_consistency():
    """_get_dresiduals is the exact linearization of _get_residuals."""
    cd = ConvectionDiffusionSolver(1.0, 1.0, Pe=3.0, P=3, N_ex=2, N_ey=3,
                                   T_W=0.0, T_E=1.0)
    T = RNG.standard_normal(cd.N)
    u = RNG.standard_normal(cd.N)
    v = RNG.standard_normal(cd.N)
    dT = RNG.standard_normal(cd.N)
    du = RNG.standard_normal(cd.N)
    dv = RNG.standard_normal(cd.N)
    r0 = np.asarray(cd._get_residuals(T, u, v))
    cd._calc_jacobians(T)
    dres = np.asarray(cd._get_dresiduals(dT, du, dv))
    # the residual is linear in T (for fixed u,v) and bilinear overall, so the
    # directional derivative equals the finite difference exactly up to the
    # second-order (du,dv)x(dT) cross term
    eps = 1e-6
    r1 = np.asarray(cd._get_residuals(T + eps * dT, u + eps * du,
                                      v + eps * dv))
    fd = (r1 - r0) / eps
    np.testing.assert_allclose(dres, fd, rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("P", [4, 8])
def test_cd_boundary_layer_spectral_accuracy(P):
    """Manufactured 1D solution: Pe·U0·T_x = T_xx on [0,1], T(0)=0, T(1)=1
    has T(x) = (e^{Pe·U0·x} - 1)/(e^{Pe·U0} - 1); y-direction Neumann."""
    PeU = 8.0
    cd = ConvectionDiffusionSolver(1.0, 1.0, Pe=PeU, P=P, N_ex=4, N_ey=2,
                                   T_W=0.0, T_E=1.0, mtol=1e-12)
    T = np.asarray(cd._get_solution(jnp.ones(cd.N), jnp.zeros(cd.N)))
    x = cd.points[0]
    T_exact = np.expm1(PeU * x) / np.expm1(PeU)
    err = np.max(np.abs(T - T_exact))
    # spectral convergence: P=4 coarse, P=8 near machine precision
    assert err < (2e-3 if P == 4 else 5e-9), f"err={err:.2e}"


def test_cd_interpolation_reproduces_polynomials():
    cd = ConvectionDiffusionSolver(2.0, 1.0, Pe=1.0, P=3, N_ex=3, N_ey=2,
                                   T_W=0.0)
    x, y = cd.points
    f = 2.0 + x**3 - 1.5 * y**2 + x * y
    xq, yq = np.meshgrid(np.linspace(0, 2.0, 13), np.linspace(0, 1.0, 7),
                         indexing="ij")
    got = cd._get_interpol(jnp.asarray(f), (xq, yq))
    expect = 2.0 + xq**3 - 1.5 * yq**2 + xq * yq
    np.testing.assert_allclose(got, expect, rtol=1e-11, atol=1e-12)


def test_cd_neumann_sides_conserve():
    """With zero velocity and N/S Neumann, solution is linear in x."""
    cd = ConvectionDiffusionSolver(1.0, 1.0, Pe=10.0, P=4, N_ex=3, N_ey=3,
                                   T_W=1.0, T_E=0.0, mtol=1e-12)
    T = np.asarray(cd._get_solution(jnp.zeros(cd.N), jnp.zeros(cd.N)))
    np.testing.assert_allclose(T, 1.0 - cd.points[0], atol=1e-9)


def test_lgmres_iter_prints_per_iteration(capsys):
    """'LGMRES_iter' emits the reference's per-iteration residual lines
    (reference ConvectionDiffusion_Solver.py:139-144)."""
    from sem_jax import ConvectionDiffusionSolver
    import jax.numpy as jnp
    cd = ConvectionDiffusionSolver(1.0, 1.0, Pe=5.0, P=3, N_ex=2, N_ey=2,
                                   T_W=0.5, T_E=-0.5, mtol=1e-10,
                                   iprint=["LGMRES_iter"])
    z = jnp.zeros(cd.N)
    cd._get_solution(z, z)
    out = capsys.readouterr().out
    lines = [l for l in out.splitlines()
             if l.startswith("ConvectionDiffusion LGMRES: ")]
    assert len(lines) >= 2
    # residuals decrease overall: last printed < first printed
    first = float(lines[0].split("\t")[1])
    last = float(lines[-1].split("\t")[1])
    assert last < first
