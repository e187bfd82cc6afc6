"""Banded SEM applies in plain XLA, and the choice of apply form.

The assembled 1D operators ``K1x, G1x, K1y, G1y`` are block-banded with
half-band ``P`` (one element on each side of a node), so the dense XLA path
(:func:`sem_jax.operators.apply_system`) multiplies structural zeros: at p16
64×64 the two dense (2·1025)×1025×1025 products issue ~8.6 GFLOP for ~0.28
GFLOP of in-band work.  Every product runs at ``Precision.HIGHEST`` (IEEE
float32, see :func:`sem_jax.operators.mm_precision`), i.e. on the CUDA
cores, not the tensor cores.

The banded forms contract only the band.  The rows are cut into blocks of
``T = 2H`` (``H ≥ P`` a power of two, ``T = 32`` at p16); block ``g``
multiplies a ``(T, 2T)`` in-band operator block (precomputed on the host by
``_band_consts``) into the ``2T``-row window of the field that starts ``H``
rows above it, as one batched einsum per operator and direction.  On an
H100 this is about 2-5× faster than the dense form at p16 64×64 in float32 and
float64 (PERF.md).

:func:`apply_impl` chooses the form by platform and mesh.  Parity
with the dense form is tested in ``tests/test_banded.py`` and
``tests/test_banded_mesh.py``; ``chip_smoke.py`` checks it on the card.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from sem_jax.mesh import Grid2D
from sem_jax import operators as ops

__all__ = ["apply_system_best", "apply_coupled_system_best",
           "apply_system_banded_xla", "apply_coupled_system_banded_xla",
           "apply_impl"]

_HI = jax.lax.Precision.HIGHEST


def _tile(P: int) -> tuple[int, int]:
    """``(T, H)``: row-block edge and window half-pad for order ``P``.

    ``H`` is the least power of two ≥ max(P, 8) and ``T = 2H`` (the sizes
    measured on the H100, PERF.md)."""
    H = 8
    while H < P:
        H *= 2
    return 2 * H, H


def _window_start(g: int, T: int, H: int) -> int:
    """First row of block ``g``'s contracted window."""
    return max(g * T - H, 0)


def _band_blocks(A: np.ndarray, nb: int, T: int, H: int) -> np.ndarray:
    """In-band blocks ``out[g] = A[g·T:(g+1)·T, s_g:s_g+2T]`` (zero outside
    ``A``), ``s_g`` from :func:`_window_start`.  Raises if the band of ``A``
    does not fit the window."""
    n = A.shape[0]
    out = np.zeros((nb, T, 2 * T))
    for g in range(nb):
        r0, r1 = g * T, min(g * T + T, n)
        if r0 >= n:
            continue
        s = _window_start(g, T, H)
        c1 = min(s + 2 * T, n)
        out[g, :r1 - r0, :c1 - s] = A[r0:r1, s:c1]
        rows = A[r0:r1]
        if np.any(rows[:, :s]) or np.any(rows[:, c1:]):
            raise ValueError("operator band does not fit the window")
    return out


@functools.lru_cache(maxsize=None)
def _band_consts(grid: Grid2D):
    """Host constants of the banded forms (float64; cast at use).

    ``bxk/bxg (nbx, T, 2T)`` multiply the x-window from the left;
    ``byk/byg (nby, 2T, T)`` (transposed blocks of ``K1y``/``G1y``) multiply
    the y-window from the right; ``m1x/m1y`` are the 1D mass diagonals."""
    T, H = _tile(grid.P)
    nbx, nby = -(-grid.Ngx // T), -(-grid.Ngy // T)
    bxk = _band_blocks(grid.K1x, nbx, T, H)
    bxg = _band_blocks(grid.G1x, nbx, T, H)
    byk = _band_blocks(grid.K1y, nby, T, H).transpose(0, 2, 1).copy()
    byg = _band_blocks(grid.G1y, nby, T, H).transpose(0, 2, 1).copy()
    return bxk, bxg, byk, byg, grid.m1x, grid.m1y


def _consts(grid, dtype):
    return tuple(jnp.asarray(a, dtype) for a in _band_consts(grid))


def _windows(n: int, nb: int, T: int, H: int) -> np.ndarray:
    """Row indices ``(nb, 2T)`` of each block's window (``n`` = pad row)."""
    idx = np.full((nb, 2 * T), n, np.int32)
    for g in range(nb):
        s = _window_start(g, T, H)
        r = np.arange(s, s + 2 * T)
        idx[g] = np.where(r < n, r, n)
    return idx


def _banded_parts(grid, F, bxk, bxg, byk, byg):
    """``(K1x F, G1x F, F K1yᵀ, F G1yᵀ)`` of the stacked fields ``F
    (nf, Ngx, Ngy)`` from the in-band blocks."""
    T, H = _tile(grid.P)
    Ngx, Ngy = grid.Ngx, grid.Ngy
    nbx, nby = bxk.shape[0], byk.shape[0]
    Fp = jnp.pad(F, ((0, 0), (0, 1), (0, 1)))        # zero row/col at n
    Wx = Fp[:, _windows(Ngx, nbx, T, H), :Ngy]       # (nf, nbx, 2T, Ngy)
    Wy = Fp[:, :Ngx][:, :, _windows(Ngy, nby, T, H)]  # (nf, Ngx, nby, 2T)

    def xdir(B):
        out = jnp.einsum("gok,fgkc->fgoc", B, Wx, precision=_HI)
        return out.reshape(F.shape[0], nbx * T, Ngy)[:, :Ngx]

    def ydir(B):
        out = jnp.einsum("frgk,gko->frgo", Wy, B, precision=_HI)
        return out.reshape(F.shape[0], Ngx, nby * T)[:, :, :Ngy]

    return xdir(bxk), xdir(bxg), ydir(byk), ydir(byg)


@functools.partial(jax.jit, static_argnums=(0,))
def apply_system_banded_xla(grid: Grid2D, u: jax.Array, v: jax.Array,
                            w: jax.Array, coef) -> jax.Array:
    """``(K + coef·(u∂x + v∂y)) w`` from the in-band blocks (any dtype).

    Drop-in equivalent of :func:`sem_jax.operators.apply_system`."""
    Ngx, Ngy = grid.Ngx, grid.Ngy
    bxk, bxg, byk, byg, m1x, m1y = _consts(grid, w.dtype)
    Kx, Gx, Ky, Gy = _banded_parts(grid, w.reshape(1, Ngx, Ngy),
                                   bxk, bxg, byk, byg)
    m1x = m1x[:, None]
    m1y = m1y[None, :]
    U, V = u.reshape(Ngx, Ngy), v.reshape(Ngx, Ngy)
    out = (Kx[0] * m1y + m1x * Ky[0]
           + coef * (U * (Gx[0] * m1y) + V * (m1x * Gy[0])))
    return out.reshape(-1)


@functools.partial(jax.jit, static_argnums=(0,))
def apply_coupled_system_banded_xla(grid: Grid2D, q: jax.Array,
                                    ul: jax.Array, vl: jax.Array,
                                    jac, mb: jax.Array, coef) -> jax.Array:
    """Coupled saddle matvec ``(dru, drv, drc)`` for ``q=(du,dv,dp)`` from
    the in-band blocks (fields batched into one einsum per operator).

    The tangent rows of ``NavierStokesSolver._coupled_ops``; excludes the
    pressure-pin row (a single element — callers apply it afterwards).

    :param jac: convection Jacobian diagonal vectors ``(jxx, jxy, jyx, jyy)``
    :param mb: boundary (Dirichlet-row) mask, flat bool/float ``(N,)``
    """
    Ngx, Ngy = grid.Ngx, grid.Ngy
    bxk, bxg, byk, byg, m1x, m1y = _consts(grid, q.dtype)
    Q = q.reshape(3, Ngx, Ngy)
    Kx, Gx, Ky, Gy = _banded_parts(grid, Q, bxk, bxg, byk, byg)
    m1x = m1x[:, None]
    m1y = m1y[None, :]
    K2d = Kx * m1y + m1x * Ky
    gx, gy = Gx * m1y, m1x * Gy
    f = lambda a: a.astype(q.dtype).reshape(Ngx, Ngy)
    U, V = f(ul), f(vl)
    jxx, jxy, jyx, jyy = (f(j) for j in jac)
    m = f(mb)
    du, dv = Q[0], Q[1]
    dru = K2d[0] + coef * (U * gx[0] + V * gy[0]) + jxx * du + jxy * dv \
        + gx[2]
    drv = K2d[1] + coef * (U * gx[1] + V * gy[1]) + jyx * du + jyy * dv \
        + gy[2]
    drc = gx[0] + gy[1]
    keep = 1.0 - m
    return jnp.concatenate([(m * du + keep * dru).reshape(-1),
                            (m * dv + keep * drv).reshape(-1),
                            (m * K2d[2] + keep * drc).reshape(-1)])


# ---------------------------------------------------------------------------
# dispatch: by platform and mesh


def _multichip_mesh():
    """The active mesh if it spans several devices (read at trace time,
    like the solvers' ``constrain`` annotations), else ``None``."""
    from sem_jax.parallel.sharding import active_mesh
    mesh = active_mesh()
    return mesh if mesh is not None and mesh.devices.size > 1 else None


def apply_impl() -> str:
    """Name of the form the fused applies dispatch to in the current
    context (platform and active mesh; any dtype, any grid).

    * ``"xla-banded"``: on one GPU, any dtype;
    * ``"xla-dense"``: the reference two-matmul form — on the CPU, and
      under a multi-device mesh (its GSPMD sharding propagation is tested in
      tests/test_banded_mesh.py).
    """
    if jax.default_backend() == "gpu" and _multichip_mesh() is None:
        return "xla-banded"
    return "xla-dense"


def apply_system_best(grid: Grid2D, u, v, w, coef):
    """``(K + coef·(u∂x + v∂y)) w`` by :func:`apply_impl`'s choice."""
    if apply_impl() == "xla-banded":
        return apply_system_banded_xla(grid, u, v, w, coef)
    return ops.apply_system(grid, u, v, w, coef)


def apply_coupled_system_best(grid: Grid2D, q, ul, vl, jac, mb, coef):
    """The coupled saddle matvec (pin row excluded) through
    :func:`apply_impl`'s choice."""
    if apply_impl() == "xla-banded":
        return apply_coupled_system_banded_xla(grid, q, ul, vl, jac, mb,
                                               coef)
    return ops.apply_coupled_system(grid, q, ul, vl, jac, mb, coef)
