"""Tests of the explicit assembly interop layer vs the dense oracles and the
matrix-free operators."""
import numpy as np
import pytest
import jax.numpy as jnp

from sem_jax import assemble as asm
from sem_jax import operators as ops
from sem_jax.mesh import Grid2D
from tests import oracles

RNG = np.random.default_rng(9)


@pytest.fixture(scope="module")
def grid():
    return Grid2D(P=3, N_ex=2, N_ey=3, L_x=1.2, L_y=0.9)


def test_global_matrices_match_oracles(grid):
    np.testing.assert_allclose(asm.global_mass_matrix(grid).toarray(),
                               oracles.dense_mass(grid), atol=1e-13)
    np.testing.assert_allclose(asm.global_stiffness_matrix(grid).toarray(),
                               oracles.dense_stiffness(grid), atol=1e-11)
    Gx, Gy = asm.global_gradient_matrices(grid)
    np.testing.assert_allclose(Gx.toarray(), oracles.dense_grad_x(grid),
                               atol=1e-12)
    np.testing.assert_allclose(Gy.toarray(), oracles.dense_grad_y(grid),
                               atol=1e-12)


def test_convection_tensor_contractions(grid):
    Cx, Cy = asm.global_convection_matrices(grid)
    CxD, CyD = oracles.dense_convection_tensors(grid)
    u = RNG.standard_normal(grid.N)
    f = RNG.standard_normal(grid.N)
    np.testing.assert_allclose(Cx.left(u).toarray(),
                               np.einsum("abc,b->ac", CxD, u), atol=1e-11)
    np.testing.assert_allclose(Cy.right(f).toarray(),
                               np.einsum("abc,c->ab", CyD, f), atol=1e-11)


def test_generic_assemble_matches_operator(grid):
    """assemble() of the element stiffness arrays == matrix-free apply."""
    P1 = grid.P + 1
    Ks, w = grid.basis.K, grid.basis.weights
    I = np.eye(P1)
    K_e1 = np.einsum("ik,jl,j->ijkl", (2 / grid.dx) * Ks, I,
                     grid.dy / 2 * w) \
        + np.einsum("ik,jl,i->ijkl", I, (2 / grid.dy) * Ks,
                    grid.dx / 2 * w)
    A_e = np.broadcast_to(K_e1, (grid.N_ex, grid.N_ey) + K_e1.shape)
    K = asm.assemble(grid, A_e)
    x = RNG.standard_normal(grid.N)
    np.testing.assert_allclose(K @ x,
                               np.asarray(ops.apply_stiffness(
                                   grid, jnp.asarray(x))),
                               rtol=1e-11, atol=1e-12)


def test_assemble_vector(grid):
    """4-d element array assembles by duplicate-sum (C0 interface sum)."""
    ones = np.ones((grid.N_ex, grid.N_ey, grid.P + 1, grid.P + 1))
    out = asm.assemble(grid, ones)
    np.testing.assert_allclose(out, grid.multiplicity)


def test_assemble_rank3(grid):
    """8-d element arrays assemble to the duplicate-summed rank-3 tensor
    (reference SEM.py:139-145).  The canonical return is the COO-triple
    dict regardless of which optional packages are importable; PyData
    ``sparse.COO`` (the reference's type) is an explicit opt-in."""
    P1 = grid.P + 1
    A_e = RNG.standard_normal((grid.N_ex, grid.N_ey) + (P1,) * 6)
    out = asm.assemble(grid, A_e)

    g = grid.gidx.reshape(grid.N_ex, grid.N_ey, P1, P1)
    i1 = np.broadcast_to(g[:, :, :, :, None, None, None, None], A_e.shape)
    i2 = np.broadcast_to(g[:, :, None, None, :, :, None, None], A_e.shape)
    i3 = np.broadcast_to(g[:, :, None, None, None, None, :, :], A_e.shape)
    dense = np.zeros((grid.N,) * 3)
    np.add.at(dense, (i1.reshape(-1), i2.reshape(-1), i3.reshape(-1)),
              A_e.reshape(-1))

    assert isinstance(out, dict) and out["shape"] == (grid.N,) * 3
    got = np.zeros((grid.N,) * 3)
    np.add.at(got, tuple(out["coords"]), out["data"])
    np.testing.assert_allclose(got, dense, atol=1e-12)

    try:
        import sparse
    except ImportError:
        sparse = None
    if sparse is not None:   # opt-in reference-parity type
        coo = asm.assemble(grid, A_e, as_pydata_sparse=True)
        assert isinstance(coo, sparse.COO)
        np.testing.assert_allclose(coo.todense(), dense, atol=1e-12)


def test_assemble_shape_validation(grid):
    with pytest.raises(ValueError):
        asm.assemble(grid, np.zeros((1, 1, 2, 2)))
