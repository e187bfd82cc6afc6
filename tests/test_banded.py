"""The banded (in-band einsum) XLA applies against the dense reference path,
and the dispatcher's choice of form."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from sem_jax import operators as ops
from sem_jax.mesh import Grid2D
from sem_jax.ops import banded as bd
from sem_jax.parallel.sharding import make_mesh, use_mesh

RNG = np.random.default_rng(21)
# (P, N_ex, N_ey): one partial block, multi-block, long non-square strips
# (partial blocks on both axes), p16
SHAPES = [(4, 8, 8), (7, 5, 5), (7, 40, 40), (16, 16, 16), (4, 9, 2),
          (3, 2, 11)]


def _grid(P, Nex, Ney):
    return Grid2D(P=P, N_ex=Nex, N_ey=Ney, L_x=1.0, L_y=1.3)


def _fields(grid, dt=jnp.float32):
    return tuple(jnp.asarray(RNG.standard_normal(grid.N), dt)
                 for _ in range(3))


def _coupled_inputs(grid, dt=jnp.float32):
    N = grid.N
    q = jnp.asarray(RNG.standard_normal(3 * N), dt)
    ul, vl = (jnp.asarray(RNG.standard_normal(N), dt) for _ in range(2))
    jac = tuple(jnp.asarray(RNG.standard_normal(N), dt) for _ in range(4))
    mb_np = np.zeros(N, bool)
    mb_np[RNG.choice(N, size=N // 7, replace=False)] = True
    return q, ul, vl, jac, jnp.asarray(mb_np)


def coupled_composition(grid, q, ul, vl, jac, mb, Re):
    """The NS tangent rows (reference NavierStokes_Solver.py:138-160, pin
    row excluded) composed from the single operators."""
    N = grid.N
    du, dv, dp = q[:N], q[N:2 * N], q[2 * N:]

    def sysapply(w):
        return (ops.apply_stiffness(grid, w)
                + Re * ops.apply_convection(grid, ul, vl, w))

    jxx, jxy, jyx, jyy = jac
    dru = sysapply(du) + jxx * du + jxy * dv + ops.apply_grad_x(grid, dp)
    drv = sysapply(dv) + jyx * du + jyy * dv + ops.apply_grad_y(grid, dp)
    drc = ops.apply_grad_x(grid, du) + ops.apply_grad_y(grid, dv)
    dru = jnp.where(mb, du, dru)
    drv = jnp.where(mb, dv, drv)
    drc = jnp.where(mb, ops.apply_stiffness(grid, dp), drc)
    return np.asarray(jnp.concatenate([dru, drv, drc]))


def _close(got, ref, rel=2e-5):
    np.testing.assert_allclose(np.asarray(got), ref,
                               atol=rel * np.max(np.abs(ref)))


@pytest.mark.parametrize("P,Nex,Ney", SHAPES)
def test_banded_xla_apply_matches_dense(P, Nex, Ney):
    """The in-band einsum apply matches the dense two-matmul path on every
    grid shape class (partial and multi-block, non-square, p16)."""
    grid = _grid(P, Nex, Ney)
    u, v, w = _fields(grid)
    ref = np.asarray(ops.apply_system(grid, u, v, w, jnp.float32(7.5)))
    _close(bd.apply_system_banded_xla(grid, u, v, w, jnp.float32(7.5)), ref)


@pytest.mark.parametrize("P,Nex,Ney", SHAPES)
def test_banded_xla_coupled_matches_composition(P, Nex, Ney):
    """The field-batched einsum coupled matvec matches the operator-level
    composition."""
    grid = _grid(P, Nex, Ney)
    args = _coupled_inputs(grid)
    ref = coupled_composition(grid, *args, jnp.float32(37.0))
    _close(bd.apply_coupled_system_banded_xla(grid, *args,
                                              jnp.float32(37.0)), ref)


@pytest.mark.parametrize("P,Ne", [(4, 8), (16, 4)])
def test_banded_xla_f64(P, Ne):
    """The in-band forms serve float64 to f64 roundoff."""
    grid = Grid2D(P=P, N_ex=Ne, N_ey=Ne + 1, L_x=1.0, L_y=1.3)
    u, v, w = _fields(grid, jnp.float64)
    ref = np.asarray(ops.apply_system(grid, u, v, w, 7.5))
    _close(bd.apply_system_banded_xla(grid, u, v, w, 7.5), ref, rel=1e-13)
    args = _coupled_inputs(grid, jnp.float64)
    ref = coupled_composition(grid, *args, 37.0)
    _close(bd.apply_coupled_system_banded_xla(grid, *args, 37.0), ref,
           rel=1e-13)


def test_dense_coupled_matches_composition():
    """``operators.apply_coupled_system`` (the dense reference form the CPU
    and GSPMD paths use) matches the composition in float64."""
    grid = Grid2D(P=5, N_ex=4, N_ey=3, L_x=1.0, L_y=1.3)
    args = _coupled_inputs(grid, jnp.float64)
    ref = coupled_composition(grid, *args, 37.0)
    _close(ops.apply_coupled_system(grid, *args, 37.0), ref, rel=1e-13)


@pytest.mark.parametrize("dtype,rel", [(jnp.float32, 2e-5),
                                       (jnp.float64, 1e-13)])
def test_gpu_dispatch_matches_dense(monkeypatch, dtype, rel):
    """With the backend reported as a GPU, both fused applies go through
    the banded form and still equal the dense reference, inside a jitted
    caller as the solvers use them."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    grid = Grid2D(P=6, N_ex=5, N_ey=3, L_x=1.0, L_y=1.3)
    u, v, w = _fields(grid, dtype)
    c = jnp.asarray(7.5, dtype)
    assert bd.apply_impl() == "xla-banded"
    got = jax.jit(lambda u, v, w: bd.apply_system_best(grid, u, v, w, c))(
        u, v, w)
    _close(got, np.asarray(ops.apply_system(grid, u, v, w, c)), rel)
    args = _coupled_inputs(grid, dtype)
    c = jnp.asarray(37.0, dtype)
    got = jax.jit(lambda *a: bd.apply_coupled_system_best(grid, *a, c))(
        *args)
    _close(got, coupled_composition(grid, *args, c), rel)


@pytest.mark.parametrize("P,T", [(2, 16), (4, 16), (8, 16), (9, 32),
                                 (16, 32), (20, 64)])
def test_tile_sizes(P, T):
    """Blocks are powers of two with a window half-pad H = T/2 ≥ P."""
    t, h = bd._tile(P)
    assert (t, h) == (T, T // 2) and h >= P and t >= 16


def test_band_blocks_cover_band():
    """The in-band blocks reproduce the 1D operator exactly, and a band
    wider than the window is refused."""
    grid = Grid2D(P=5, N_ex=7, N_ey=3, L_x=1.0, L_y=1.0)
    T, H = bd._tile(grid.P)
    n = grid.Ngx
    nb = -(-n // T)
    B = bd._band_blocks(grid.K1x, nb, T, H)
    A = np.zeros((nb * T, n + 2 * T))
    for g in range(nb):
        s = bd._window_start(g, T, H)
        A[g * T:(g + 1) * T, s:s + 2 * T] += B[g]
    np.testing.assert_allclose(A[:n, :n], grid.K1x, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        bd._band_blocks(np.ones((40, 40)), 3, 16, 8)


def _spy_impls(monkeypatch, backend):
    """Route jax.default_backend to ``backend`` and replace every
    implementation by a spy returning its name."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    for n in ("apply_system_banded_xla", "apply_coupled_system_banded_xla"):
        monkeypatch.setattr(bd, n, lambda *a, _n=n, **k: _n)
    for n in ("apply_system", "apply_coupled_system"):
        monkeypatch.setattr(bd.ops, n, lambda *a, _n=n, **k: _n)


@pytest.mark.parametrize("backend,dtype,mesh,impl,called", [
    ("gpu", jnp.float32, None, "xla-banded", "apply_system_banded_xla"),
    ("gpu", jnp.float64, None, "xla-banded", "apply_system_banded_xla"),
    ("cpu", jnp.float32, None, "xla-dense", "apply_system"),
    ("cpu", jnp.float64, None, "xla-dense", "apply_system"),
    ("gpu", jnp.float32, "1d", "xla-dense", "apply_system"),
    ("gpu", jnp.float64, "1d", "xla-dense", "apply_system"),
    ("gpu", jnp.float32, "2d", "xla-dense", "apply_system"),
    ("gpu", jnp.float32, "single", "xla-banded", "apply_system_banded_xla"),
])
def test_dispatch_selection(monkeypatch, backend, dtype, mesh, impl, called):
    """Selection is by platform and mesh only: one GPU runs the in-band
    einsums in any dtype; the CPU and every multi-device mesh run the dense
    reference form (GSPMD partitions it); a single-device mesh partitions
    nothing and counts as one GPU."""
    grid = Grid2D(P=4, N_ex=8, N_ey=4, L_x=1.0, L_y=1.0)
    _spy_impls(monkeypatch, backend)
    meshes = {
        None: None, "1d": make_mesh(),
        "single": make_mesh(devices=jax.devices()[:1]),
        "2d": jax.sharding.Mesh(np.array(jax.devices()).reshape(4, 2),
                                ("a", "b")),
    }
    w = jnp.zeros(grid.N, dtype)

    def check():
        assert bd.apply_impl() == impl
        assert bd.apply_system_best(grid, w, w, w, 1.0) == called
        assert (bd.apply_coupled_system_best(grid, w, w, w, (w,) * 4, w, 1.0)
                == called.replace("apply_system", "apply_coupled_system"))

    if meshes[mesh] is None:
        check()
    else:
        with use_mesh(meshes[mesh]):
            check()
