"""The fused applies under a multi-device mesh, on the virtual 8-device CPU
mesh.

Under a multi-device mesh :func:`sem_jax.ops.apply_impl` picks the dense
reference form, and XLA's SPMD partitioner shards it along the row strips
the solvers' ``constrain`` annotations ask for.  These tests run that path as
the solvers do (traced inside ``use_mesh``, inputs and outputs constrained)
and check it against the single-device reference.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sem_jax import operators as ops
from sem_jax.mesh import Grid2D
from sem_jax.parallel.sharding import make_mesh, use_mesh, constrain
from sem_jax.ops import (apply_system_best, apply_coupled_system_best,
                         apply_impl)

from tests.test_banded import coupled_composition

RNG = np.random.default_rng(11)


def _rand(n, dt=jnp.float32):
    return jnp.asarray(RNG.standard_normal(n), dt)


def _mesh_apply(grid, mesh, u, v, w, coef):
    f = jax.jit(lambda u, v, w: constrain(apply_system_best(
        grid, constrain(u), constrain(v), constrain(w), coef)))
    with use_mesh(mesh):
        assert apply_impl() == "xla-dense"
        return np.asarray(f(u, v, w))


def _coupled_args(grid):
    N = grid.N
    return (_rand(3 * N), _rand(N), _rand(N), tuple(_rand(N) for _ in
                                                    range(4)),
            jnp.asarray(RNG.random(N) < 0.2))


def _mesh_coupled(grid, mesh, args, coef):
    f = jax.jit(lambda q, ul, vl, jac, mb: apply_coupled_system_best(
        grid, q, constrain(ul), constrain(vl), tuple(map(constrain, jac)),
        mb, coef))
    with use_mesh(mesh):
        return f, np.asarray(f(*args))


@pytest.mark.parametrize("nex,ney", [(8, 4), (70, 2)])
def test_sharded_system_apply_parity(nex, ney):
    """Mesh apply == single-device apply on the 8-device mesh (f32
    roundoff), for a grid that divides the mesh badly and a long strip."""
    grid = Grid2D(P=4, N_ex=nex, N_ey=ney, L_x=1.0, L_y=1.0)
    u, v, w = _rand(grid.N), _rand(grid.N), _rand(grid.N)
    ref = np.asarray(ops.apply_system(grid, u, v, w, 3.0))
    got = _mesh_apply(grid, make_mesh(), u, v, w, 3.0)
    np.testing.assert_allclose(got, ref, atol=3e-6 * np.abs(ref).max())


def test_sharded_coupled_apply_parity():
    """Mesh coupled saddle matvec == the operator-level composition."""
    grid = Grid2D(P=4, N_ex=8, N_ey=4, L_x=1.0, L_y=1.0)
    args = _coupled_args(grid)
    ref = coupled_composition(grid, *args, 2.5)
    _, got = _mesh_coupled(grid, make_mesh(), args, 2.5)
    np.testing.assert_allclose(got, ref, atol=3e-6 * np.abs(ref).max())


def test_sharded_coupled_hlo_structure():
    """The compiled mesh matvec is the dense two-matmul form run through
    the SPMD partitioner: collectives inserted, and exactly two dots (all
    twelve 1D products of the stacked fields), not one per product.

    At the odd field lengths of every SEM grid the row-strip constraint
    cannot split the fields evenly, so the two dots run at full size on
    each device (ROADMAP lists a sharded banded apply for the mesh path)."""
    grid = Grid2D(P=4, N_ex=8, N_ey=4, L_x=1.0, L_y=1.0)
    mesh = make_mesh()
    N = grid.N
    f, _ = _mesh_coupled(grid, mesh, _coupled_args(grid), 2.5)
    s = jax.ShapeDtypeStruct((N,), jnp.float32)
    with use_mesh(mesh):
        hlo = f.lower(jax.ShapeDtypeStruct((3 * N,), jnp.float32), s, s,
                      (s, s, s, s),
                      jax.ShapeDtypeStruct((N,), jnp.bool_)
                      ).compile().as_text()
    assert any(c in hlo for c in ("all-gather", "all-reduce",
                                  "collective-permute", "all-to-all")), \
        "mesh matvec compiled with no collectives"
    dots = [l for l in hlo.splitlines() if " dot(" in l]
    assert len(dots) == 2, dots


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_sharded_apply_device_counts(ndev):
    """Every mesh size partitions the p16 apply correctly (uneven rows per
    device)."""
    grid = Grid2D(P=16, N_ex=5, N_ey=3, L_x=1.0, L_y=1.0)
    mesh = make_mesh(devices=jax.devices()[:ndev])
    u, v, w = _rand(grid.N), _rand(grid.N), _rand(grid.N)
    ref = np.asarray(ops.apply_system(grid, u, v, w, 3.0))
    got = _mesh_apply(grid, mesh, u, v, w, 3.0)
    np.testing.assert_allclose(got, ref, atol=3e-6 * np.abs(ref).max())
