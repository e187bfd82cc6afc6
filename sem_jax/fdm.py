"""Fast-diagonalization (FDM) direct solver for the masked global Laplacian.

The reference hides its hardest linear algebra in an exact SuperLU
factorization of the (Dirichlet-masked) velocity Jacobian each Newton step
(reference NavierStokes_Solver.py:176-187).  On the uniform tensor-product SEM
mesh there is a far better direct solver: the global stiffness
operator factorizes as ``K = K1x ⊗ diag(m1y) + diag(m1x) ⊗ K1y``
(see ``sem_jax.mesh.Grid2D``), and any Dirichlet restriction used by the
reference (whole sides) restricts to a *product set* of interior indices —
so the restricted operator keeps the tensor structure.  With the generalized
eigendecompositions ``K1 Z = M1 Z Λ`` (M1-orthonormal ``Z``) per dimension::

    (K1x ⊗ M1y + M1x ⊗ K1y + α M1x ⊗ M1y)⁻¹
        = (Zx ⊗ Zy) diag(1/(λx ⊕ λy + α)) (Zxᵀ ⊗ Zyᵀ)

One apply = four dense matmuls of size ``(nix, niy)`` — pure matmul work, O(N^1.5)
flops, no factorization per Newton step, no fill-in.  This is used

* as the *exact* inverse of the masked diffusion operator — hence a strong
  right preconditioner for the convection-diffusion and velocity-block GMRES
  solves (SuperLU replacement), and
* as an exact Poisson solver in its own right.

The eigendecompositions are computed once per (grid, BC-pattern) on the host
(sizes ≤ ~1k at the north-star config).
"""
from __future__ import annotations

import numpy as np
import scipy.linalg

import jax
import jax.numpy as jnp

from sem_jax.mesh import Grid2D
from sem_jax import operators as ops

__all__ = ["FDM2D"]


def _eig_1d(K1: np.ndarray, m1: np.ndarray, interior: np.ndarray,
            cache_key: str = None):
    """Generalized eigendecomposition of the restricted 1D pencil (K, M).

    M is diagonal (GLL mass lumping), so the generalized problem reduces to a
    symmetric standard one: with S = diag(1/√m),  S K S = Q Λ Qᵀ and
    Z = S Q satisfies ZᵀKZ = Λ, ZᵀMZ = I.

    Disk-cached per 1D configuration when ``cache_key`` is given (the
    eigh of the ~1k pencils at north-star sizes costs ~5 s of host LAPACK
    each — the dominant warm-start construction cost).
    """
    def build():
        Kii = K1[np.ix_(interior, interior)]
        mii = m1[interior]
        s = 1.0 / np.sqrt(mii)
        A = (Kii * s[:, None]) * s[None, :]
        A = 0.5 * (A + A.T)
        lam, Q = scipy.linalg.eigh(A)
        return {"lam": lam, "Z": s[:, None] * Q}

    if cache_key is not None:
        from sem_jax.utils.diskcache import npz_cached
        out = npz_cached(cache_key, build)
    else:
        out = build()
    return out["lam"], out["Z"]


class FDM2D:
    """Exact inverse of the Dirichlet-masked operator ``K + α M``.

    The masked system solved is the one the reference builds by row surgery
    (identity rows on Dirichlet nodes, reference NavierStokes_Solver.py:181-182
    and ConvectionDiffusion_Solver.py:90)::

        u[dir]      = r[dir]
        (K+αM)u|int = r[int]          (including columns into Dirichlet nodes)

    :param grid: the SEM grid
    :param dirichlet_x: (west, east) — whether those sides carry Dirichlet rows
    :param dirichlet_y: (south, north)
    :param alpha: mass-shift coefficient α (0 ⇒ pure stiffness)

    If no side is Dirichlet the operator is singular (pure Neumann Laplacian);
    the zero eigenvalue is pseudo-inverted (solution orthogonal to constants).
    """

    def __init__(self, grid: Grid2D, dirichlet_x=(True, True),
                 dirichlet_y=(True, True), alpha: float = 0.0):
        self.grid = grid
        self.alpha = float(alpha)
        ix = np.arange(grid.Ngx)
        iy = np.arange(grid.Ngy)
        if dirichlet_x[0]:
            ix = ix[1:]
        if dirichlet_x[1]:
            ix = ix[:-1]
        if dirichlet_y[0]:
            iy = iy[1:]
        if dirichlet_y[1]:
            iy = iy[:-1]
        self._ix, self._iy = ix, iy
        self._has_boundary = (len(ix) < grid.Ngx) or (len(iy) < grid.Ngy)
        # interior index sets are contiguous ranges (whole-side Dirichlet
        # masks only), so interior extraction/insertion compiles to static
        # slices / dynamic_update_slice — never a gather/scatter, which at
        # north-star grids cost ~100x the FDM matmuls on the earlier
        # accelerator
        self._x0, self._x1 = int(ix[0]), int(ix[-1]) + 1
        self._y0, self._y1 = int(iy[0]), int(iy[-1]) + 1
        assert self._x1 - self._x0 == len(ix) and self._y1 - self._y0 == len(iy)

        def key(P, Ne, L, ii):
            return (f"fdm1d_v1_P{P}_Ne{Ne}_L{L}_i{int(ii[0])}_{int(ii[-1])}"
                    if len(ii) else None)

        # the two 1D eigendecompositions are independent — build them
        # concurrently (scipy.linalg.eigh releases the GIL inside LAPACK)
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=2) as pool:
            fx = pool.submit(_eig_1d, grid.K1x, grid.m1x, ix,
                             key(grid.P, grid.N_ex, grid.L_x, ix))
            fy = pool.submit(_eig_1d, grid.K1y, grid.m1y, iy,
                             key(grid.P, grid.N_ey, grid.L_y, iy))
            lx, Zx = fx.result()
            ly, Zy = fy.result()
        denom = lx[:, None] + ly[None, :] + self.alpha
        # pseudo-inverse of (near-)zero modes (pure-Neumann nullspace guard)
        scale = max(1.0, float(np.max(np.abs(denom))))
        ginv = np.where(np.abs(denom) > 1e-12 * scale, 1.0 / denom, 0.0)

        self._Zx = Zx
        self._Zy = Zy
        self._ginv = ginv
        self._lx = lx
        self._ly = ly
        self._denom_scale = scale

        # grid-form boolean mask of the Dirichlet nodes
        bm = np.ones((grid.Ngx, grid.Ngy), dtype=bool)
        bm[np.ix_(ix, iy)] = False
        self._bmask = bm

        from sem_jax.utils.hoist import jit_hoisted
        self._solve_jit = jit_hoisted(self._solve_impl,
                                      f"fdm.solve@{grid.tag}")

    # ------------------------------------------------------------------ #
    def _solve_impl(self, r: jax.Array, sigma=None) -> jax.Array:
        """Solve for one RHS ``(N,)`` or a stacked batch ``(..., N)``.

        Batched RHSs (e.g. both velocity components of a preconditioner
        application) run as one set of batched matmuls — a single dispatch,
        which matters because SEM-sized matmuls are latency-bound.

        :param sigma: optional additional mass shift — solves
            ``(K + (α+σ) M) u = r`` with ``σ`` a *traced* scalar, so
            pseudo-transient continuation can ramp the shift without
            recompiling (the eigenbasis is σ-independent; only the diagonal
            ``1/(λx ⊕ λy + α + σ)`` changes — one elementwise op next to the
            four dense matmuls).  ``None`` uses the precomputed static
            diagonal.
        """
        grid = self.grid
        dtype = r.dtype
        batch = r.shape[:-1]
        R = r.reshape(batch + (grid.Ngx, grid.Ngy))
        x0, x1, y0, y1 = self._x0, self._x1, self._y0, self._y1

        if self._has_boundary:
            bmask = jnp.asarray(self._bmask)
            Rb = jnp.where(bmask, R, 0.0)
            # interior RHS minus the coupling through boundary columns:
            # r_i − (K+αM)_ib u_b.  Restricted to the interior product set,
            # this is EXACTLY ≤4 rank-1 outer products — one per Dirichlet
            # side: each boundary slab is a single row/column, K1x (K1y)
            # couples it into the interior through one of its columns
            # (rows), the cross-direction slabs land only in excluded
            # boundary columns/rows, corners touch nothing interior, and
            # the diagonal αM term is ring-supported so it vanishes under
            # the restriction.  The previous full K apply here cost two
            # large matmuls per field — a material share of every
            # preconditioner application.
            K1x = jnp.asarray(grid.K1x.astype(dtype))
            K1y = jnp.asarray(grid.K1y.astype(dtype))
            m1x_i = jnp.asarray(grid.m1x[x0:x1].astype(dtype))
            m1y_i = jnp.asarray(grid.m1y[y0:y1].astype(dtype))
            corr = jnp.zeros(batch + (x1 - x0, y1 - y0), dtype)
            if x0 == 1:      # West Dirichlet row
                corr = corr + (K1x[x0:x1, 0][:, None]
                               * R[..., 0:1, y0:y1]) * m1y_i
            if x1 == grid.Ngx - 1:   # East
                corr = corr + (K1x[x0:x1, grid.Ngx - 1][:, None]
                               * R[..., grid.Ngx - 1:grid.Ngx, y0:y1]) \
                    * m1y_i
            if y0 == 1:      # South Dirichlet column
                corr = corr + (R[..., x0:x1, 0:1]
                               * K1y[y0:y1, 0][None, :]) * m1x_i[:, None]
            if y1 == grid.Ngy - 1:   # North
                corr = corr + (R[..., x0:x1, grid.Ngy - 1:grid.Ngy]
                               * K1y[y0:y1, grid.Ngy - 1][None, :]) \
                    * m1x_i[:, None]
            Rint = R[..., x0:x1, y0:y1] - corr
        else:
            Rb = jnp.zeros_like(R)
            Rint = R

        Zx = jnp.asarray(self._Zx.astype(dtype))
        Zy = jnp.asarray(self._Zy.astype(dtype))
        if sigma is None:
            ginv = jnp.asarray(self._ginv.astype(dtype))
        else:
            # in-trace diagonal: (M is diagonal, so the σM boundary-column
            # coupling vanishes on interior rows — only the denominator moves)
            lx = jnp.asarray(self._lx.astype(dtype))
            ly = jnp.asarray(self._ly.astype(dtype))
            denom = lx[:, None] + ly[None, :] + self.alpha \
                + jnp.asarray(sigma, dtype)
            ginv = jnp.where(jnp.abs(denom) > 1e-12 * self._denom_scale,
                             1.0 / jnp.where(denom == 0.0, 1.0, denom), 0.0)
        hi = ops.mm_precision(dtype)  # left-precon: accuracy-critical
        W = jnp.matmul(Zx.T, jnp.matmul(Rint, Zy, precision=hi),
                       precision=hi)
        W = W * ginv
        Uint = jnp.matmul(Zx, jnp.matmul(W, Zy.T, precision=hi),
                          precision=hi)

        out = (Rb.at[..., x0:x1, y0:y1].set(Uint) if self._has_boundary
               else Uint)
        return out.reshape(batch + (grid.N,))

    def solve(self, r: jax.Array) -> jax.Array:
        """Solve the masked system for RHS ``r`` (flat, or stacked batch)."""
        return self._solve_jit(r)

    def __call__(self, r: jax.Array, sigma=None) -> jax.Array:
        # traceable form, for use inside jit
        return self._solve_impl(r, sigma=sigma)
