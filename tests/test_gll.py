"""Unit tests of the GLL basis layer against analytic identities.

Test strategy per SURVEY.md §4: node symmetry, Σw = 2, quadrature exactness to
degree 2P-1, D·1 = 0, K symmetric PSD, evaluation-matrix interpolation
identities.
"""
import numpy as np
import pytest

from sem_jax import gll
from tests import oracles


@pytest.mark.parametrize("P", [1, 2, 3, 4, 7, 8, 16])
def test_nodes_weights_basic(P):
    nodes, weights = gll.nodes_weights(P)
    assert nodes.shape == (P + 1,)
    assert nodes[0] == -1.0 and nodes[-1] == 1.0
    assert np.all(np.diff(nodes) > 0)
    # symmetry
    np.testing.assert_allclose(nodes, -nodes[::-1], atol=1e-14)
    np.testing.assert_allclose(weights, weights[::-1], atol=1e-14)
    # Σw = |[-1,1]| = 2
    np.testing.assert_allclose(weights.sum(), 2.0, rtol=1e-14)


@pytest.mark.parametrize("P", [2, 3, 4, 8])
def test_quadrature_exactness(P):
    """GLL quadrature is exact for polynomials of degree <= 2P-1."""
    nodes, weights = gll.nodes_weights(P)
    for k in range(2 * P):
        exact = 2.0 / (k + 1) if k % 2 == 0 else 0.0
        np.testing.assert_allclose(weights @ nodes**k, exact, atol=1e-13)


@pytest.mark.parametrize("P", [4, 6])
def test_known_values(P):
    """Spot-check against known GLL node values."""
    nodes, weights = gll.nodes_weights(P)
    if P == 4:
        np.testing.assert_allclose(nodes[1], -np.sqrt(3 / 7), rtol=1e-14)
        np.testing.assert_allclose(weights[0], 1 / 10, rtol=1e-14)
        np.testing.assert_allclose(weights[2], 32 / 45, rtol=1e-14)


@pytest.mark.parametrize("P", [2, 4, 9])
def test_differentiation_matrix(P):
    D = gll.standard_differentiation_matrix(P)
    nodes, _ = gll.nodes_weights(P)
    # constant annihilated
    np.testing.assert_allclose(D @ np.ones(P + 1), 0.0, atol=1e-11)
    # exact derivatives of monomials up to degree P
    for k in range(1, P + 1):
        np.testing.assert_allclose(D @ nodes**k, k * nodes ** (k - 1),
                                   atol=1e-10)
    assert D[0, 0] == -P * (P + 1) / 4
    assert D[-1, -1] == P * (P + 1) / 4


@pytest.mark.parametrize("P", [2, 4, 8])
def test_stiffness_spd(P):
    K = gll.standard_stiffness_matrix(P)
    np.testing.assert_allclose(K, K.T, atol=1e-13)
    evals = np.linalg.eigvalsh(K)
    assert evals[0] > -1e-12  # PSD (one zero eigenvalue: constants)
    assert np.sum(np.abs(evals) < 1e-10) == 1


@pytest.mark.parametrize("P", [2, 4])
def test_gradient_matrix_integrates(P):
    """Gˢᵢⱼ = ∫ℓᵢℓ'ⱼ: column sums give ∫ℓ'ⱼ = ℓⱼ(1) - ℓⱼ(-1)."""
    G = gll.standard_gradient_matrix(P)
    colsum = G.sum(axis=0)
    expect = np.zeros(P + 1)
    expect[0] = -1.0
    expect[-1] = 1.0
    np.testing.assert_allclose(colsum, expect, atol=1e-12)


@pytest.mark.parametrize("P", [3, 5])
def test_product_and_convection_tensors(P):
    w = gll.nodes_weights(P)[1]
    D = gll.standard_differentiation_matrix(P)
    F = gll.standard_product_matrix(P)
    C = gll.standard_convection_matrix(P)
    idx = np.arange(P + 1)
    np.testing.assert_allclose(F[idx, idx, idx], w)
    assert np.count_nonzero(F) == P + 1
    np.testing.assert_allclose(C[idx, idx, :], w[:, None] * D)
    # off super-diagonal entries vanish
    C2 = C.copy()
    C2[idx, idx, :] = 0
    assert np.count_nonzero(C2) == 0


@pytest.mark.parametrize("P", [3, 6])
def test_evaluation_matrix(P):
    nodes, _ = gll.nodes_weights(P)
    # at the nodes: identity
    S = gll.standard_evaluation_matrix(P, nodes)
    np.testing.assert_allclose(S, np.eye(P + 1), atol=1e-13)
    # partition of unity + polynomial reproduction at arbitrary points
    xi = np.linspace(-1, 1, 17)
    S = gll.standard_evaluation_matrix(P, xi)
    np.testing.assert_allclose(S.sum(axis=1), 1.0, atol=1e-12)
    for k in range(P + 1):
        np.testing.assert_allclose(S @ nodes**k, xi**k, atol=1e-11)
    # against the direct product-formula oracle
    for a, x in enumerate([-0.7, 0.123]):
        row = gll.standard_evaluation_matrix(P, np.array([x]))[0]
        for j in range(P + 1):
            np.testing.assert_allclose(row[j], oracles.lagrange_value(P, j, x),
                                       rtol=1e-12)


def test_standard_nodes_vandermonde():
    P = 5
    nodes, weights, V = gll.standard_nodes(P)
    # V[:, j] = P_j(nodes); check orthogonality under GLL quadrature for j<P
    for j in range(P):
        for k in range(P):
            got = np.sum(weights * V[:, j] * V[:, k])
            expect = 2 / (2 * j + 1) if j == k else 0.0
            np.testing.assert_allclose(got, expect, atol=1e-12)
