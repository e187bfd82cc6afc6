"""Implicit-differentiation adjoints of the coupled Boussinesq solve.

The reference implements only forward-mode coupled derivatives and raises on
reverse mode (reference ConvectionDiffusion_Component.py:45-46,
NavierStokes_Component.py:44-45).  This module is the capability *upgrade*
of pure-JAX fixed-point loops with implicit-diff adjoints: gradients of any functional of the converged
coupled state with respect to the physics parameters (Re, Ra, Pr, wall
temperatures), via the implicit-function theorem::

    F(x*, θ) = 0   ⇒   dJ/dθ = ∂J/∂θ − λᵀ ∂F/∂θ,   J_xᵀ λ = (∂J/∂x)ᵀ

The coupled residual ``F`` is re-expressed here as a *pure traced function*
of (state, params) — every operator in the framework is matrix-free and
jax-traceable, so the transposed Jacobian-vector products ``J_xᵀ v`` and
``∂F/∂θᵀ λ`` come from ``jax.vjp`` exactly (no hand-derived adjoints).  The
adjoint system is solved by flexible GMRES preconditioned by the TRANSPOSED
block-Gauss-Seidel of the forward solvers' preconditioner (NS block first,
transposed buoyancy coupling into the CD RHS; blocks are the exact vjp
transposes of the forward FDM / spectral-Schur applies), optionally
strengthened by solving the true transposed diagonal blocks to
``inner_rtol`` per application for the convection-dominated high-Ra states
PTC reaches — the adjoint analog of the forward BGS block solves.

Validated against finite differences in tests/test_implicit.py.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from sem_jax import operators as ops
from sem_jax.coupling.mda import _fgmres
from sem_jax.interp import apply_transfer

__all__ = ["coupled_residual_fn", "solve_adjoint", "gradients"]


def coupled_residual_fn(cd, ns):
    """Pure coupled residual ``F(x_flat, params) -> r_flat``.

    ``params`` is a dict with (any of) ``Re``, ``Ra``, ``Pr``, ``T_W``,
    ``T_E`` as traced scalars.  Matches exactly the residual the MDA drives
    to zero (same operators, masks, pressure pin, cross-mesh transfers).
    """
    N_cd, N_ns = cd.N, ns.N
    mask_cd = cd._mask_dir
    mb, pin = ns._mask_bound, ns._mask_pin
    dir_u, dir_v = ns._dirichlet_u, ns._dirichlet_v
    mask_W = jnp.asarray(cd.grid.side_mask("W"))
    mask_E = jnp.asarray(cd.grid.side_mask("E"))

    def unpack(x):
        return (x[:N_cd], x[N_cd:N_cd + N_ns],
                x[N_cd + N_ns:N_cd + 2 * N_ns], x[N_cd + 2 * N_ns:])

    def F(x, params):
        T, u, v, p = unpack(x)
        Re = params["Re"]
        Pr = params["Pr"]
        Ra = params["Ra"]
        Pe = Re * Pr
        GrRe = Ra / Pr / Re
        T_W = params.get("T_W", 0.5)
        T_E = params.get("T_E", -0.5)

        # CD residual on the CD grid
        u_cd = apply_transfer(ns.grid, cd.grid, u)
        v_cd = apply_transfer(ns.grid, cd.grid, v)
        rT = Pe * ops.apply_convection(cd.grid, u_cd, v_cd, T) \
            + ops.apply_stiffness(cd.grid, T)
        dirichlet = jnp.where(mask_W, T_W, 0.0) + jnp.where(mask_E, T_E, 0.0)
        rT = jnp.where(mask_cd, T - dirichlet, rT)

        # NS residual on the NS grid
        T_ns = apply_transfer(cd.grid, ns.grid, T)
        conv = lambda w: ops.apply_stiffness(ns.grid, w) \
            + Re * ops.apply_convection(ns.grid, u, v, w)
        ru = conv(u) + ops.apply_grad_x(ns.grid, p)
        rv = conv(v) + ops.apply_grad_y(ns.grid, p) \
            - GrRe * ops.apply_mass(ns.grid, T_ns)
        rc = ops.apply_grad_x(ns.grid, u) + ops.apply_grad_y(ns.grid, v)
        ru = jnp.where(mb, u - dir_u, ru)
        rv = jnp.where(mb, v - dir_v, rv)
        rc = jnp.where(mb, ops.apply_stiffness(ns.grid, p), rc)
        rc = jnp.where(pin, p, rc)
        return jnp.concatenate([rT, ru, rv, rc])

    return F


def _block_precon_transposed(cd, ns, x_star, params,
                             inner_rtol: float = None,
                             inner_restart: int = 60,
                             inner_maxiter: int = 600,
                             inner_basis_dtype=None):
    """Transposed block-GAUSS-SEIDEL preconditioner of ``J_xᵀ``.

    The forward high-Ra lesson transposes directly: block-Jacobi ignores the
    buoyancy coupling and the coupled GMRES stagnates at Ra ≳ 1e5 (measured
    both forward — ROADMAP r3, the 'bgs' PTC default — and here: the
    block-diagonal adjoint pc stall-exited at a PTC-converged Ra=1e5
    state).  The forward BGS is lower block-triangular
    ``M = [[A_cd, 0], [C, A_ns]]`` (solve T, forward the coupling
    ``C = ∂F_ns/∂T`` into the NS RHS); the adjoint uses exactly ``Mᵀ``
    (upper block-triangular): solve the NS block FIRST, then feed the
    TRANSPOSED coupling into the CD RHS::

        z_ns = Â_nsᵀ⁻¹ r_ns
        z_T  = Â_cdᵀ⁻¹ (r_T − Cᵀ z_ns)

    with ``Cᵀ`` exact from ``jax.vjp`` (buoyancy through the cross-mesh
    transfer — affine in T).  Block approximations:

    * CD block: the FDM inverse (self-adjoint — preconditions
      ``(K + Pe·conv)ᵀ`` exactly as well as the forward block).
    * NS block: the exact TRANSPOSE of the forward solver's strong coupled
      block preconditioner (spectral-Schur pressure + batched FDM velocity,
      ``ns._pc64_fn``), obtained by ``jax.vjp`` of the linear apply.
    * ``inner_rtol = t > 0``: convection-aware strengthening (the adjoint
      analog of the forward block solves): each application
      SOLVES the TRUE transposed diagonal blocks (convection included, from
      ``jax.vjp`` of the block-restricted residuals at ``x_star``) to
      relative tolerance ``t`` by inner GMRES right-preconditioned by the
      block approximations above — matching the strength of the forward
      BGS preconditioner, whose blocks are full discipline solves to
      ``mtol_precon`` (the fixed-k velocity sweeps that suffice inside the
      forward f32 chunks are far too weak here: at a PTC-converged Ra=1e5
      state the forward inner solves run dozens-to-hundreds of
      iterations).  The inner solves vary per application; the host FGMRES
      outer loop (already flexible) absorbs them.
    """
    N_cd, N_ns = cd.N, ns.N
    x_star = jnp.asarray(x_star)
    ul = x_star[N_cd:N_cd + N_ns]
    vl = x_star[N_cd + N_ns:N_cd + 2 * N_ns]
    zero_sigma = jnp.asarray(0.0, jnp.float64)
    F = coupled_residual_fn(cd, ns)
    pj = {k: jnp.asarray(v, jnp.float64) for k, v in params.items()}
    T_star = x_star[:N_cd]
    uvp_star = x_star[N_cd:]

    # exact transpose of the (linear) forward NS block pc via vjp
    _, pc_vjp = jax.vjp(lambda q: ns._pc64_fn(q, ul, vl, zero_sigma),
                        jnp.zeros(3 * N_ns))
    pcT = lambda r: pc_vjp(r)[0]

    # transposed coupling Cᵀ = (∂F_ns/∂T)ᵀ at the converged state
    _, vjp_c = jax.vjp(
        lambda T: F(jnp.concatenate([T, uvp_star]), pj)[N_cd:], T_star)
    CT = lambda z: vjp_c(z)[0]

    if inner_rtol:
        from sem_jax.krylov import gmres

        # true transposed diagonal blocks from vjp of the restricted
        # residuals (the other discipline's state frozen at x_star)
        _, vjp_ns = jax.vjp(
            lambda q: F(jnp.concatenate([T_star, q]), pj)[N_cd:], uvp_star)
        _, vjp_cd = jax.vjp(
            lambda T: F(jnp.concatenate([T, uvp_star]), pj)[:N_cd], T_star)
        rt = float(inner_rtol)

        # ``inner_restart``/``inner_maxiter`` bound the single-dispatch
        # runtime of each (jitted) preconditioner application — at p16
        # (3.4M DOF) an unbounded 600-iteration f64 inner loop per block
        # runs for minutes in one dispatch; the outer FGMRES is flexible, so a
        # capped inner solve only weakens (never breaks) the application
        # the inner basis stores in f32 by default: a 1e-4 relative block
        # tolerance sits far above the f32 recurrence floor (each restart
        # recomputes the true residual in the working f64), and f32 halves
        # the CGS2 sweeps' basis traffic, as in the forward host-FGMRES
        def ns_apply(r):
            q, _ = gmres(lambda z: vjp_ns(z)[0], r,
                         atol=rt * jnp.linalg.norm(r),
                         restart=inner_restart, maxiter=inner_maxiter,
                         precon=pcT, basis_dtype=inner_basis_dtype)
            return q

        def cd_apply(r):
            q, _ = gmres(lambda z: vjp_cd(z)[0], r,
                         atol=rt * jnp.linalg.norm(r),
                         restart=inner_restart, maxiter=inner_maxiter,
                         precon=lambda t: cd._fdm(t),
                         basis_dtype=inner_basis_dtype)
            return q
    else:
        ns_apply = pcT
        cd_apply = lambda r: cd._fdm(r)

    from sem_jax.utils.hoist import jit_hoisted

    @jit_hoisted
    def precon(r):
        z_ns = ns_apply(r[N_cd:])
        z_T = cd_apply(r[:N_cd] - CT(z_ns))
        return jnp.concatenate([z_T, z_ns])

    # device-native callable: the host FGMRES keeps every n-sized vector on
    # the device, and a np.asarray round trip here would add ~2 full-vector
    # host transfers per outer iteration (mda._fgmres docstring)
    return precon


def solve_adjoint(cd, ns, x_star, gbar, params, atol=1e-10,
                  restart=60, maxiter=20000, inner_rtol: float = 1e-4,
                  inner_restart: int = 60, inner_maxiter: int = 600,
                  raise_on_fail: bool = True, max_basis_gb: float = 0.5,
                  iprint: bool = False, inner_basis_dtype=None):
    """Solve the adjoint system ``J_xᵀ λ = gbar`` at the converged state.

    The outer FGMRES runs on the ROW-SCALED transposed system
    ``E⁻¹ Jᵀ λ = E⁻¹ g`` with ``E`` a stochastic row-norm estimate of
    ``Jᵀ`` (8 Rademacher probes), and the convergence test applies in that
    scaled norm: raw SEM rows mix stiffness- and unit-Dirichlet scales
    spanning ~1e7, so the RAW residual 2-norm both overweights the stiff
    rows and carries an f64 attainable floor far above useful tolerances
    (measured at a PTC-converged Ra=1e5 state: hard plateau at ~1e-6
    relative raw; the forward solves avoid the same trap with
    left-preconditioned/row-scaled norms).  ``atol`` is the RMS tolerance
    on the scaled residual.

    :param inner_rtol: strength of the (transposed block-Gauss-Seidel)
        preconditioner — t>0 (default 1e-4, the strength of the forward
        BGS pc, whose blocks are full 1e-4 discipline solves): solve the
        true transposed diagonal blocks to relative tolerance t per
        application; None: one transposed-block-pc apply per block — the
        cheap variant, which stalls already on MILD states (measured:
        1420-iteration stall at a JNK-converged Ra=1e3 state where
        inner_rtol=1e-4 converges in ~300), so only use it when profiling
        shows the inner solves dominating AND the outer converges
    :param iprint: print outer residual + per-iteration wall (the forward
        solvers' iprint convention)
    :param inner_basis_dtype: Krylov-basis dtype of the inner block solves
        (None = auto: f32 above ``SEM_JAX_ADJ_INNER_F32_MIN_DOF`` block
        DOF, default 1e6, else the working f64; see the in-code
        measurement note)
    """
    F = coupled_residual_fn(cd, ns)
    x_star = jnp.asarray(x_star)
    params = {k: jnp.asarray(v, jnp.float64) for k, v in params.items()}
    # Memory-scale the Krylov windows: the outer f64 FGMRES keeps TWO
    # padded (restart+1, n) bases, each inner block solve one more, and
    # XLA's while-loop carry double-buffering + CGS2 temporaries multiply
    # each live basis ~4-6× inside the jitted programs — at p16 (n = 3.4M)
    # the naive restart-60 everywhere compiled to a 22.1 GB program on a
    # 15.75 GB chip (measured OOM).  ``max_basis_gb`` caps each basis
    # buffer (default sized so the multiplied footprint fits a 16 GB
    # chip); small problems keep the full windows.
    n = x_star.shape[0]
    cap = max(8, int(max_basis_gb * 1e9 / (8 * max(n, 1))) - 1)
    restart = min(restart, cap)
    # the inner block solves act on BLOCK-sized vectors (N_cd or 3·N_ns)
    # with an f32 basis — cap their window by their own footprint, not the
    # coupled-f64 worst case (at p16 the shared cap collapsed the inner
    # window to 17, gutting the convection-dominated NS block solve the
    # preconditioner's strength comes from)
    n_in = max(3 * ns.N, cd.N)
    # inner-basis dtype, auto by block size (override explicitly or via
    # SEM_JAX_ADJ_INNER_F32_MIN_DOF): above ~1M block DOF the inner solves
    # store their Krylov basis in f32 — a 1e-4 relative block tolerance sits
    # far above the f32 recurrence floor (restarts recompute the true
    # residual in f64) and f32 halves the CGS2 sweeps' basis traffic (as in
    # the forward host-FGMRES).
    # Measured at a PTC-converged Ra=1e5 state (CPU): identical outer
    # iteration count (33), gradient shift ~1.6e-3 relative — inside the
    # solve's own uncertainty in the dRa functional (|λ| ≈ 1e15 with ~1e10
    # cancellation in λᵀ∂F/∂Ra; the FD reference itself carries ~2e-4-1e-3
    # noise).  Small/deep-tolerance problems keep the full-precision basis.
    if inner_basis_dtype is None:
        import os as _os
        thresh = float(_os.environ.get("SEM_JAX_ADJ_INNER_F32_MIN_DOF",
                                       "1e6") or "1e6")
        inner_basis_dtype = jnp.float32 if n_in > thresh else None
    bytes_in = 4 if inner_basis_dtype == jnp.float32 else 8
    cap_in = max(8, int(max_basis_gb * 1e9 / (bytes_in * max(n_in, 1))) - 1)
    inner_restart = min(inner_restart, cap_in)
    _, vjp_x = jax.vjp(lambda x: F(x, params), x_star)
    mv = jax.jit(lambda lam: vjp_x(lam)[0])

    # stochastic row-norm estimate of Jᵀ (cf. the forward flexible chunks)
    from sem_jax.krylov import rownorm_estimate
    e = jax.jit(lambda key: rownorm_estimate(
        lambda z: vjp_x(z)[0], x_star.shape[0], jnp.float64, key))(
            jax.random.PRNGKey(0))
    einv = 1.0 / e
    precon = _block_precon_transposed(cd, ns, x_star, params,
                                      inner_rtol=inner_rtol,
                                      inner_restart=inner_restart,
                                      inner_maxiter=inner_maxiter,
                                      inner_basis_dtype=inner_basis_dtype)

    # all callables device-native: _fgmres keeps every n-sized vector on
    # the device (host round trips per callback were the measured p16
    # pathology its docstring records)
    cb = None
    if iprint:
        import time as _time
        t_ip = [_time.perf_counter()]

        def cb(it, res):
            now = _time.perf_counter()
            print(f"   adjoint FGMRES: {it}\t{res:.6e}\t"
                  f"({now - t_ip[0]:.1f}s/it)", flush=True)
            t_ip[0] = now
    lam, iters, ok = _fgmres(
        lambda z: mv(z) * einv,
        lambda r: precon(r * e),
        jnp.asarray(gbar) * einv, atol=atol * np.sqrt(gbar.shape[0]),
        restart=restart, maxiter=maxiter, callback=cb,
        # full-precision outer basis: the adjoint is validated to 1e-6
        # RAW-relative in one solve — at/below the f32 refinement floor
        basis_dtype=jnp.float64)
    if not ok:
        if raise_on_fail:
            raise RuntimeError(f"adjoint FGMRES: no convergence in {iters} "
                               f"iterations")
        print(f"adjoint FGMRES: best-effort exit after {iters} iterations "
              f"(gradient accuracy degraded)", flush=True)
    return jnp.asarray(lam), iters


def gradients(cd, ns, x_star, loss_fn, params, atol=1e-10,
              inner_rtol: float = 1e-4, **adjoint_kw):
    """Gradient of ``loss_fn(x)`` at the converged coupled state w.r.t. the
    physics parameters, by the implicit-function theorem.

    :param x_star: converged flat coupled state (from ``BoussinesqMDA``)
    :param loss_fn: traced scalar functional of the flat state
    :param params: dict of parameter values (``Re``, ``Ra``, ``Pr``, ...)
    :param inner_rtol: adjoint-preconditioner strength (see
        :func:`solve_adjoint`; the 1e-4 default matches the forward BGS)
    :param adjoint_kw: forwarded to :func:`solve_adjoint` (restart,
        maxiter, inner_restart, inner_maxiter, raise_on_fail — the
        dispatch-bounding knobs for large-DOF states)
    :return: (loss value, dict of d loss / d param)
    """
    x_star = jnp.asarray(x_star)
    loss, gbar = jax.value_and_grad(loss_fn)(x_star)
    lam, _ = solve_adjoint(cd, ns, x_star, np.asarray(gbar), params,
                           atol=atol, inner_rtol=inner_rtol, **adjoint_kw)

    F = coupled_residual_fn(cd, ns)
    pj = {k: jnp.asarray(v, jnp.float64) for k, v in params.items()}
    _, vjp_theta = jax.vjp(lambda th: F(x_star, th), pj)
    dtheta = vjp_theta(lam)[0]
    grads = {k: -float(v) for k, v in dtheta.items()}
    return float(loss), grads
