"""Tests of the mesh layer and matrix-free operators vs dense oracles.

Equivalence of segment-sum/tensor-product operator applies against a naive
dense global assembly at small P/N_e (SURVEY.md §7.2 step 2-3 acceptance).
"""
import numpy as np
import pytest
import jax.numpy as jnp

from sem_jax import operators as ops
from sem_jax.mesh import Grid2D, x2xi, xi2x
from tests import oracles

RNG = np.random.default_rng(0)


@pytest.fixture(scope="module")
def grid():
    return Grid2D(P=3, N_ex=2, N_ey=3, L_x=1.3, L_y=0.7)


def test_coordinate_maps():
    dx = 0.25
    x = np.array([0.0, 0.1, 0.25, 0.3, 0.5, 1.0])
    e, xi = x2xi(x, dx)
    np.testing.assert_allclose(xi2x(e, xi, dx), x, atol=1e-14)
    # interface and right-end ownership shifts
    assert e[2] == 0 and np.isclose(xi[2], 1.0)
    assert e[-1] == 3 and np.isclose(xi[-1], 1.0)


def test_global_nodes(grid):
    assert grid.x_1d.shape == (grid.Ngx,)
    np.testing.assert_allclose(grid.x_1d[0], 0.0)
    np.testing.assert_allclose(grid.x_1d[-1], grid.L_x)
    assert np.all(np.diff(grid.x_1d) > 0)
    # points agrees with meshgrid of 1D nodes (x-major)
    X, Y = np.meshgrid(grid.x_1d, grid.y_1d, indexing="ij")
    np.testing.assert_allclose(grid.points[0], X.reshape(-1))
    np.testing.assert_allclose(grid.points[1], Y.reshape(-1))


def test_points_e_match_gather(grid):
    """Element node coordinates = gather of global coordinates (C0 mesh)."""
    for d in range(2):
        gathered = np.asarray(ops.gather(grid, jnp.asarray(grid.points[d])))
        np.testing.assert_allclose(
            gathered.reshape(grid.N_ex, grid.N_ey, grid.P + 1, grid.P + 1),
            grid.points_e[d])


def test_gather_scatter_roundtrip(grid):
    u = RNG.standard_normal(grid.N)
    u_e = ops.gather(grid, jnp.asarray(u))
    # scatter(gather(u)) multiplies by node multiplicity
    back = np.asarray(ops.scatter_sum(grid, u_e))
    np.testing.assert_allclose(back, u * grid.multiplicity, rtol=1e-13)


def test_mass_operator(grid):
    A = oracles.dense_mass(grid)
    u = RNG.standard_normal(grid.N)
    np.testing.assert_allclose(np.asarray(ops.apply_mass(grid, jnp.asarray(u))),
                               A @ u, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(grid.mass_diag, np.diag(A), rtol=1e-13)
    # total mass = domain area
    np.testing.assert_allclose(grid.mass_diag.sum(), grid.L_x * grid.L_y,
                               rtol=1e-13)


def test_stiffness_operator(grid):
    A = oracles.dense_stiffness(grid)
    u = RNG.standard_normal(grid.N)
    got = np.asarray(ops.apply_stiffness(grid, jnp.asarray(u)))
    np.testing.assert_allclose(got, A @ u, rtol=1e-11, atol=1e-12)
    # Laplacian annihilates constants
    ones = np.asarray(ops.apply_stiffness(grid, jnp.ones(grid.N)))
    np.testing.assert_allclose(ones, 0.0, atol=1e-11)


def test_gradient_operators(grid):
    Ax = oracles.dense_grad_x(grid)
    Ay = oracles.dense_grad_y(grid)
    u = RNG.standard_normal(grid.N)
    np.testing.assert_allclose(np.asarray(ops.apply_grad_x(grid, jnp.asarray(u))),
                               Ax @ u, rtol=1e-11, atol=1e-13)
    np.testing.assert_allclose(np.asarray(ops.apply_grad_y(grid, jnp.asarray(u))),
                               Ay @ u, rtol=1e-11, atol=1e-13)
    # weak derivative of linear field: Gx x = M 1 * 1 (since dx/dx = 1)
    x = grid.points[0]
    np.testing.assert_allclose(
        np.asarray(ops.apply_grad_x(grid, jnp.asarray(x))),
        grid.mass_diag, rtol=1e-11)


@pytest.fixture(scope="module")
def tiny():
    return Grid2D(P=2, N_ex=2, N_ey=2, L_x=1.0, L_y=1.5)


def test_convection_operator(tiny):
    """(u@Cx + v@Cy) w against the dense rank-3 tensor contraction."""
    Cx, Cy = oracles.dense_convection_tensors(tiny)
    u = RNG.standard_normal(tiny.N)
    v = RNG.standard_normal(tiny.N)
    w = RNG.standard_normal(tiny.N)
    # left-slot contraction: A = Σ_b u_b C[a,b,c]; res = A @ w
    expect = (np.einsum("abc,b,c->a", Cx, u, w)
              + np.einsum("abc,b,c->a", Cy, v, w))
    got = np.asarray(ops.apply_convection(
        tiny, jnp.asarray(u), jnp.asarray(v), jnp.asarray(w)))
    np.testing.assert_allclose(got, expect, rtol=1e-11, atol=1e-13)


def test_convection_jacobian_diag(tiny):
    """Right-slot contraction tensordot(C, f, (2,0)) is globally diagonal."""
    Cx, Cy = oracles.dense_convection_tensors(tiny)
    f = RNG.standard_normal(tiny.N)
    Jx = np.einsum("abc,c->ab", Cx, f)
    Jy = np.einsum("abc,c->ab", Cy, f)
    # dense result is diagonal
    assert np.allclose(Jx, np.diag(np.diag(Jx)), atol=1e-13)
    assert np.allclose(Jy, np.diag(np.diag(Jy)), atol=1e-13)
    np.testing.assert_allclose(np.asarray(ops.conv_diag_x(tiny, jnp.asarray(f))),
                               np.diag(Jx), rtol=1e-11, atol=1e-13)
    np.testing.assert_allclose(np.asarray(ops.conv_diag_y(tiny, jnp.asarray(f))),
                               np.diag(Jy), rtol=1e-11, atol=1e-13)


def test_side_masks(grid):
    for side, (axis, val) in {"W": (0, 0.0), "E": (0, grid.L_x),
                              "S": (1, 0.0), "N": (1, grid.L_y)}.items():
        m = grid.side_mask(side)
        np.testing.assert_allclose(grid.points[axis][m], val, atol=1e-14)
        assert m.sum() == (grid.Ngy if axis == 0 else grid.Ngx)
    nb = grid.boundary_mask.sum()
    assert nb == 2 * grid.Ngx + 2 * grid.Ngy - 4


def test_f32_path(grid):
    """Operators run in float32 without silent promotion to f64."""
    u = jnp.asarray(RNG.standard_normal(grid.N), dtype=jnp.float32)
    for fn in (ops.apply_mass, ops.apply_stiffness, ops.apply_grad_x):
        out = fn(grid, u)
        assert out.dtype == jnp.float32


def test_x2xi_out_of_domain_raises():
    """Domain guardrail (the reference enforces it through xi2x's range
    check, reference SEM.py:18-19)."""
    import pytest
    from sem_jax.mesh import x2xi
    with pytest.raises(ValueError):
        x2xi(np.array([-0.1, 0.5]), 0.25, N_e=4)
    with pytest.raises(ValueError):
        x2xi(np.array([0.5, 1.2]), 0.25, N_e=4)
    e, xi = x2xi(np.array([0.0, 0.5, 1.0]), 0.25, N_e=4)  # in-domain OK
    assert e[-1] == 3 and xi[-1] == 1.0
