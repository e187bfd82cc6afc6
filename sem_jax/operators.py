"""Matrix-free global SEM operators — the performance core.

The reference assembles every global operator eagerly into SciPy CSR matrices
or rank-3 sparse COO tensors and applies them with sparse matvecs / tensordots
(reference SEM.py:170-245, ConvectionDiffusion_Solver.py:82-87,
NavierStokes_Solver.py:103-111).  Here nothing is ever assembled:

* **Linear operators** (mass, stiffness, gradients) exploit the global
  tensor-product factorization.  With a field in grid form ``U (Ngx, Ngy)``:

  - mass:       ``(M u)   = m1x[:,None] * U * m1y[None,:]``           (diagonal)
  - stiffness:  ``(K u)   = (K1x @ U) * m1y + m1x[:,None] * (U @ K1y.T)``
  - gradient-x: ``(Gx p)  = (G1x @ U) * m1y``
  - gradient-y: ``(Gy p)  = m1x[:,None] * (U @ G1y.T)``

  Each is one or two dense (Ngx×Ngx)/(Ngy×Ngy) matmuls over the whole grid —
  large, static-shaped matmul work with zero gather/scatter traffic.

* **Convection** (the trilinear term) cannot factorize through the product
  nonlinearity, so it uses the classical element path: gather to element form
  ``(N_e, P+1, P+1)``, batched sum-factorization contractions with the 1D
  differentiation matrix, then a C0 scatter-add (``segment_sum``) — the
  matrix-free equivalent of contracting the reference's global rank-3 COO
  tensors (reference SEM.py:226-245).  Per element::

      conv(u,v,w)ᵢⱼ = ŵᵢŵⱼ [ (dy/2)·uᵢⱼ·(D̂ w)ᵢⱼ + (dx/2)·vᵢⱼ·(w D̂ᵀ)ᵢⱼ ]

  and the Jacobian of the convection term with respect to the *velocity* slot
  is globally **diagonal** (the reference's axis-2 tensordots,
  ConvectionDiffusion_Solver.py:101-102): ``conv_diag_x/y`` return that
  diagonal as a vector.

All functions take the ``Grid2D`` as a static jit argument; its NumPy
constants are cast to the field dtype at trace time, so the same code path
serves float64 correctness runs and float32/bfloat16 speed runs.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from sem_jax.mesh import Grid2D

__all__ = [
    "gather", "scatter_sum", "grid_form", "flat_form",
    "apply_mass", "apply_stiffness", "apply_grad_x", "apply_grad_y",
    "apply_convection", "conv_diag_x", "conv_diag_y",
]


def grid_form(grid: Grid2D, u: jax.Array) -> jax.Array:
    """Reshape a flat global vector ``(N,)`` to grid form ``(Ngx, Ngy)``."""
    return u.reshape(grid.Ngx, grid.Ngy)


def flat_form(u: jax.Array) -> jax.Array:
    """Reshape a grid-form field back to a flat global vector."""
    return u.reshape(-1)


@functools.partial(jax.jit, static_argnums=0)
def gather(grid: Grid2D, u: jax.Array) -> jax.Array:
    """Global vector → element coefficient array ``(N_e, P+1, P+1)``.

    The vectorized equivalent of the reference's quadruple-loop ``scatter``
    (reference SEM.py:149-167 — note the reference names the gather
    direction 'scatter').

    Implemented with **reshapes and strided slices only** — on the
    structured tensor-product grid the local↔global map is, per axis,
    "P-strided windows of size P+1", so no gather instruction is ever
    emitted.  Per axis: entries i<P come from ``x[:N_e·P]`` reshaped
    to (N_e, P); the shared i=P entry is the strided slice ``x[P::P]``.
    """
    P, Nex, Ney = grid.P, grid.N_ex, grid.N_ey
    U = u.reshape(grid.Ngx, grid.Ngy)
    # x-axis: (Ngx, Ngy) -> (Nex, P+1, Ngy)
    a = U[:Nex * P, :].reshape(Nex, P, grid.Ngy)
    b = U[P::P, :][:, None, :]
    rows = jnp.concatenate([a, b], axis=1)
    # y-axis: (Nex, P+1, Ngy) -> (Nex, P+1, Ney, P+1)
    c = rows[:, :, :Ney * P].reshape(Nex, P + 1, Ney, P)
    d = rows[:, :, P::P][:, :, :, None]
    cols = jnp.concatenate([c, d], axis=3)
    return cols.transpose(0, 2, 1, 3).reshape(grid.N_e, P + 1, P + 1)


@functools.partial(jax.jit, static_argnums=0)
def scatter_sum(grid: Grid2D, u_e: jax.Array) -> jax.Array:
    """Element array ``(N_e, P+1, P+1)`` → global vector by duplicate-sum.

    The C0 Galerkin assembly: contributions of all elements sharing a global
    node are summed — the matrix-free equivalent of the COO duplicate-sum
    assembly of reference SEM.py:113-146.

    The exact transpose of :func:`gather` — two slice-adds per axis
    (interior block + P-strided shared-node line) instead of a
    scatter-add/segment-sum.  Interface nodes
    receive contributions from both neighboring slices — that overlap *is*
    the C0 interface sum (≙ halo exchange under sharding).
    """
    P, Nex, Ney = grid.P, grid.N_ex, grid.N_ey
    t = u_e.reshape(Nex, Ney, P + 1, P + 1).transpose(0, 2, 1, 3)
    # y-axis: (Nex, P+1, Ney, P+1) -> (Nex, P+1, Ngy)
    colpart = jnp.zeros((Nex, P + 1, grid.Ngy), u_e.dtype)
    colpart = colpart.at[:, :, :Ney * P].add(
        t[:, :, :, :P].reshape(Nex, P + 1, Ney * P))
    colpart = colpart.at[:, :, P::P].add(t[:, :, :, P])
    # x-axis: (Nex, P+1, Ngy) -> (Ngx, Ngy)
    out = jnp.zeros((grid.Ngx, grid.Ngy), u_e.dtype)
    out = out.at[:Nex * P, :].add(
        colpart[:, :P, :].reshape(Nex * P, grid.Ngy))
    out = out.at[P::P, :].add(colpart[:, P, :])
    return out.reshape(-1)


@functools.partial(jax.jit, static_argnums=0)
def scatter_sum_segment(grid: Grid2D, u_e: jax.Array) -> jax.Array:
    """Index-based segment-sum assembly (reference semantics cross-check)."""
    return jax.ops.segment_sum(
        u_e.reshape(-1),
        jnp.asarray(grid.gidx_flat),
        num_segments=grid.N,
    )


def _c(grid: Grid2D, name: str, dtype):
    """Grid constant as a jnp array of the compute dtype (trace-time cast)."""
    return jnp.asarray(getattr(grid, name).astype(dtype))


def mm_precision(dtype) -> jax.lax.Precision:
    """Matmul precision for SEM kernels: always HIGHEST.

    On an NVIDIA GPU a float32 product without an explicit precision may run
    in TF32 (about three decimal digits, ~1e-3 relative error), which
    silently destroys Krylov orthogonalization and operator accuracy.
    Lower-precision modes were measured and rejected end-to-end on the
    earlier accelerator (its 3-pass ``HIGH`` mode keeps more digits than
    TF32):

    * operator applies at 3-pass ``HIGH`` pollute converged solutions along
      near-null directions (CD antisymmetry defect 1e-10 → 2e-7);
    * the NS coupled saddle MATVEC at HIGH stalls the f32 inner GMRES at
      ~0.22 preconditioned residual at p16 64x64 (HIGHEST converges);
    * even the FDM *preconditioner* at HIGH floors the left-preconditioned
      f32 inner solves at ~4e-5 relative (vs the ~1e-5 refinement target),
      multiplying CD solve iterations ~25x — a left preconditioner is part
      of the Arnoldi operator, so its rounding nonlinearity caps inner
      convergence.
    """
    return jax.lax.Precision.HIGHEST


@functools.partial(jax.jit, static_argnums=0)
def apply_mass(grid: Grid2D, u: jax.Array) -> jax.Array:
    """Global mass operator (diagonal) — parity with reference SEM.py:170-183."""
    U = grid_form(grid, u)
    m1x = _c(grid, "m1x", u.dtype)
    m1y = _c(grid, "m1y", u.dtype)
    return flat_form(m1x[:, None] * U * m1y[None, :])


@functools.partial(jax.jit, static_argnums=0)
def apply_stiffness(grid: Grid2D, u: jax.Array) -> jax.Array:
    """Global stiffness (2D Laplacian) — parity with reference SEM.py:186-203.

    ``K = K1x ⊗ diag(m1y) + diag(m1x) ⊗ K1y`` applied as two dense matmuls.
    """
    U = grid_form(grid, u)
    K1x = _c(grid, "K1x", u.dtype)
    K1y = _c(grid, "K1y", u.dtype)
    m1x = _c(grid, "m1x", u.dtype)
    m1y = _c(grid, "m1y", u.dtype)
    hi = mm_precision(u.dtype)
    KU = jnp.matmul(K1x, U, precision=hi) * m1y[None, :]
    UK = jnp.matmul(U, K1y.T, precision=hi) * m1x[:, None]
    return flat_form(KU + UK)


@functools.partial(jax.jit, static_argnums=0)
def apply_grad_x(grid: Grid2D, p: jax.Array) -> jax.Array:
    """Global weak x-derivative ``Gx = G1x ⊗ diag(m1y)``.

    Parity with reference SEM.py:206-223 (``G_x``; the 2/dx derivative metric
    cancels the dx/2 quadrature metric, cf. reference SEM.py:221).
    """
    U = grid_form(grid, p)
    G1x = _c(grid, "G1x", p.dtype)
    m1y = _c(grid, "m1y", p.dtype)
    return flat_form(jnp.matmul(G1x, U, precision=mm_precision(p.dtype))
                     * m1y[None, :])


@functools.partial(jax.jit, static_argnums=0)
def apply_grad_y(grid: Grid2D, p: jax.Array) -> jax.Array:
    """Global weak y-derivative ``Gy = diag(m1x) ⊗ G1y`` (reference SEM.py:222)."""
    U = grid_form(grid, p)
    G1y = _c(grid, "G1y", p.dtype)
    m1x = _c(grid, "m1x", p.dtype)
    return flat_form(jnp.matmul(U, G1y.T, precision=mm_precision(p.dtype))
                     * m1x[:, None])


def _elem_dx(grid: Grid2D, w_e: jax.Array) -> jax.Array:
    """Batched ξ-derivative along x within each element: (D̂ w)ᵢⱼ."""
    D = jnp.asarray(grid.basis.D.astype(w_e.dtype))
    return jnp.einsum("ik,ekj->eij", D, w_e,
                      precision=mm_precision(w_e.dtype))


def _elem_dy(grid: Grid2D, w_e: jax.Array) -> jax.Array:
    """Batched ξ-derivative along y within each element: (w D̂ᵀ)ᵢⱼ."""
    D = jnp.asarray(grid.basis.D.astype(w_e.dtype))
    return jnp.einsum("jl,eil->eij", D, w_e,
                      precision=mm_precision(w_e.dtype))


@functools.partial(jax.jit, static_argnums=0)
def apply_convection(grid: Grid2D, u: jax.Array, v: jax.Array,
                     w: jax.Array) -> jax.Array:
    """Apply the assembled convection operator ``(u@Cx + v@Cy) w``.

    Matrix-free equivalent of the reference's left-slot rank-3 tensordots
    (reference ConvectionDiffusion_Solver.py:82-83,
    NavierStokes_Solver.py:103-104) — the 3-tensor is never materialized.

    **Key identity** (proved by the super-diagonal GLL product tensor
    Fˢᵢⱼₖ = wᵢδᵢⱼδᵢₖ, reference GLL.py:91): the globally assembled trilinear
    convection form collapses to a *pointwise product with the assembled weak
    gradient*::

        (u @ Cx) w = u ∘ (Gx w),        (u @ Cy) w = u ∘ (Gy w)

    because the element-sum Σₑ ŵᵢŵⱼ(dy/2)·u·(D̂w)ₑ factorizes per direction
    and the x-factor is exactly the assembled G1x row while the y-factor
    reassembles m1y.  Hence the whole convection apply is two dense 1D
    matmuls and elementwise products — no gather, no scatter, no element
    batch (validated to machine precision against the dense rank-3 oracle in
    tests/test_mesh_operators.py).
    """
    return u * apply_grad_x(grid, w) + v * apply_grad_y(grid, w)


@functools.partial(jax.jit, static_argnums=0)
def apply_system(grid: Grid2D, u: jax.Array, v: jax.Array, w: jax.Array,
                 coef) -> jax.Array:
    """Fused system apply ``(K + coef·(u∂x + v∂y)) w`` in TWO matmuls.

    The hot matvec of the CD solver (and the diffusion+convection part of
    the NS momentum blocks).  Stiffness and weak-gradient applies share the
    same operand, so the stacked operators :attr:`Grid2D.KG1x` /
    :attr:`Grid2D.KG1yT` produce all four products from one left and one
    right matmul.  This dense form is the plain reference of the banded
    forms in :mod:`sem_jax.ops` and the path on the CPU and under a GSPMD
    mesh.
    """
    W = grid_form(grid, w)
    Ngx, Ngy = grid.Ngx, grid.Ngy
    hi = mm_precision(w.dtype)
    KGx = jnp.asarray(grid.KG1x.astype(w.dtype))
    KGyT = jnp.asarray(grid.KG1yT.astype(w.dtype))
    m1x = jnp.asarray(grid.m1x.astype(w.dtype))[:, None]
    m1y = jnp.asarray(grid.m1y.astype(w.dtype))[None, :]
    L = jnp.matmul(KGx, W, precision=hi)     # [K1x@W ; G1x@W]
    R = jnp.matmul(W, KGyT, precision=hi)    # [W@K1yᵀ , W@G1yᵀ]
    K2d = L[:Ngx] * m1y + m1x * R[:, :Ngy]
    gx = (L[Ngx:] * m1y).reshape(-1)
    gy = (m1x * R[:, Ngy:]).reshape(-1)
    return K2d.reshape(-1) + coef * (u * gx + v * gy)


@functools.partial(jax.jit, static_argnums=0)
def apply_coupled_system(grid: Grid2D, q: jax.Array, ul: jax.Array,
                         vl: jax.Array, jac, mb: jax.Array,
                         coef) -> jax.Array:
    """Coupled NS saddle matvec ``(dru, drv, drc)`` for ``q = (du, dv, dp)``.

    The tangent rows of reference NavierStokes_Solver.py:138-160 with the
    Dirichlet rows of ``mb`` replaced by identity (velocity) and pressure
    stiffness (continuity) rows; the pressure-pin row is left to the caller.
    All twelve 1D operator products (K/Gx/Gy applied to du, dv, dp) come
    from TWO matmuls on the stacked fields.

    :param jac: convection Jacobian diagonals ``(jxx, jxy, jyx, jyy)``
    """
    N, Ngx, Ngy = grid.N, grid.Ngx, grid.Ngy
    dt = q.dtype
    hi = mm_precision(dt)
    KGx = jnp.asarray(grid.KG1x.astype(dt))      # [K1x; G1x]
    KGyT = jnp.asarray(grid.KG1yT.astype(dt))    # [K1yᵀ, G1yᵀ]
    m1x = jnp.asarray(grid.m1x.astype(dt))[:, None]
    m1y = jnp.asarray(grid.m1y.astype(dt))[None, :]
    DU, DV, DP = (q[k * N:(k + 1) * N].reshape(Ngx, Ngy) for k in range(3))
    L = jnp.matmul(KGx, jnp.concatenate([DU, DV, DP], axis=1),
                   precision=hi)                           # (2Ngx, 3Ngy)
    R = jnp.matmul(jnp.concatenate([DU, DV, DP], axis=0), KGyT,
                   precision=hi)                           # (3Ngx, 2Ngy)

    def parts(f):  # f = 0:du, 1:dv, 2:dp
        Kx = L[:Ngx, f * Ngy:(f + 1) * Ngy]
        Gx = L[Ngx:, f * Ngy:(f + 1) * Ngy] * m1y
        Ky = R[f * Ngx:(f + 1) * Ngx, :Ngy]
        Gy = R[f * Ngx:(f + 1) * Ngx, Ngy:] * m1x
        return ((Kx * m1y + m1x * Ky).reshape(-1), Gx.reshape(-1),
                Gy.reshape(-1))

    Ku, gxu, gyu = parts(0)
    Kv, gxv, gyv = parts(1)
    Kp, gxp, gyp = parts(2)
    du, dv = q[:N], q[N:2 * N]
    jxx, jxy, jyx, jyy = jac
    dru = Ku + coef * (ul * gxu + vl * gyu) + jxx * du + jxy * dv + gxp
    drv = Kv + coef * (ul * gxv + vl * gyv) + jyx * du + jyy * dv + gyp
    drc = gxu + gyv
    return jnp.concatenate([jnp.where(mb, du, dru), jnp.where(mb, dv, drv),
                            jnp.where(mb, Kp, drc)])


@functools.partial(jax.jit, static_argnums=0)
def conv_diag_x(grid: Grid2D, f: jax.Array) -> jax.Array:
    """Diagonal (as a vector) of the global operator ``Cx @ f`` (right slot).

    Matrix-free equivalent of ``tensordot(C_x, f, (2,0))`` (reference
    ConvectionDiffusion_Solver.py:101, NavierStokes_Solver.py:131-136): the
    result is globally diagonal (the left two tensor slots coincide on the
    same nodal point) and by the same identity as
    :func:`apply_convection` equals the assembled weak x-derivative ``Gx f``.
    """
    return apply_grad_x(grid, f)


@functools.partial(jax.jit, static_argnums=0)
def conv_diag_y(grid: Grid2D, f: jax.Array) -> jax.Array:
    """Diagonal (as a vector) of the global operator ``Cy @ f`` (right slot)."""
    return apply_grad_y(grid, f)
