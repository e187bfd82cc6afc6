"""Steady Navier-Stokes (+ Boussinesq buoyancy) solver — matrix-free Newton/Uzawa.

Solves, for (u, v, p) on [0,L_x]×[0,L_y] given a temperature field T::

    Re ([u,v]∘∇)[u,v] = -∇p + ∇²[u,v] + Gr/Re [0, T]
    ∇∘[u,v] = 0

with no-normal-flow + tangential-Dirichlet walls, a pinned reference pressure
at the (approximate) center node, and artificial homogeneous-Neumann pressure
rows on the boundary — the exact BC construction of the reference
(reference NavierStokes_Solver.py:10-91, :114-119).

Solution structure (parity with reference :238-268 / :162-236):

* outer **Newton** iteration on the full nonlinear residual with RMS-scaled
  tolerance ``mtol_newton·√(3N)``;
* inner linear solve by the **Uzawa / pressure-Schur complement**: the 2N×2N
  velocity Jacobian block is inverted per Schur matvec, the pressure update
  comes from GMRES on the Schur operator with the inverse-diagonal-mass
  preconditioner (works because the GLL mass matrix is diagonal, reference
  :208-212), and velocities are back-substituted.

Deltas from the reference:

* the velocity-block solve replaces the per-Newton-step **SuperLU
  factorization** (reference :176-187, flagged there as a memory-bound
  placeholder) with jitted GMRES right-preconditioned by the **exact
  fast-diagonalization inverse** of the Dirichlet-masked Laplacian
  (``sem_jax.fdm.FDM2D``) — no factorization, no fill-in, dense-matmul work;
* every operator application is matrix-free (no CSR ``bmat``, no sparse
  rank-3 tensors); the convection Jacobian blocks are global *diagonals*
  (see ``sem_jax.operators.conv_diag_*``);
* the whole Uzawa update (nested Krylov included) compiles to one XLA program.
"""
from __future__ import annotations

import typing

import numpy as np

import jax
import jax.numpy as jnp

from sem_jax import operators as ops
from sem_jax.fdm import FDM2D
from sem_jax.interp import PointEvaluator
from sem_jax.krylov import (fgmres, gmres, refined_gmres_host,
                            rownorm_estimate)
from sem_jax.mesh import Grid2D
from sem_jax.ops import apply_coupled_system_best
from sem_jax.parallel.sharding import place

__all__ = ["NavierStokesSolver", "solve_ns_continued"]


def _sqnorm(x):
    """``x·x`` at full precision (no TF32 for float32 fields)."""
    return jnp.vdot(x, x, precision=jax.lax.Precision.HIGHEST)


def solve_ns_continued(L_x, L_y, Re, Gr, P, N_ex, N_ey, T_func=None,
                       levels: int = 2, **kwargs):
    """p-continuation solve of a standalone NS problem.

    Solves on a ladder of halved polynomial orders (floored at 2, element
    counts fixed), prolonging (u, v, p) through the cross-mesh transfer and
    warm-starting each level's Newton iteration.  Two wins over a direct
    solve: (1) the fine level starts near the solution, so its Newton takes
    1-2 steps, and (2) at convection-dominated parameters the warm-started
    linear systems need far less residual reduction per solve, which keeps
    the FDM-preconditioned Krylov inside its attainable range (a from-zero
    Newton at e.g. the Re=400 lid cavity on fine grids can demand reductions
    the Laplacian-preconditioned f32 solves cannot deliver).

    The NS analog of :func:`sem_jax.coupling.boussinesq.solve_continued`;
    capability beyond the reference (which always solves from zero,
    reference NavierStokes_Solver.py:290-303).

    :param T_func: temperature field callable (None ⇒ zero buoyancy source)
    :param levels: number of coarser levels below the target order
    :param kwargs: forwarded to every level's :class:`NavierStokesSolver`
    :return: (ns, u, v, p) — the finest-level solver and solution vectors
    """
    from sem_jax.interp import apply_transfer

    ladder = [max(2, P >> k) for k in range(levels, 0, -1)] + [P]
    ladder = [p_ for i, p_ in enumerate(ladder)
              if i == 0 or p_ != ladder[i - 1]]
    uvp = None
    prev = None
    for P_level in ladder:
        ns = NavierStokesSolver(L_x, L_y, Re=Re, Gr=Gr, P=P_level,
                                N_ex=N_ex, N_ey=N_ey, **kwargs)
        T = (jnp.zeros(ns.N, ns._dtype) if T_func is None
             else jnp.asarray(ns._get_vector(T_func), ns._dtype))
        if uvp is not None:
            uvp = tuple(apply_transfer(prev.grid, ns.grid, f) for f in uvp)
            u, v, p = ns._get_solution(T, u0=uvp[0], v0=uvp[1], p0=uvp[2])
        else:
            u, v, p = ns._get_solution(T)
        uvp = (u, v, p)
        prev = ns
    return ns, u, v, p


def _spectral_schur_data(grid: Grid2D):
    """Constants of the ``'spectral'`` Schur-block preconditioner.

    The consistent pressure Poisson ``E = B M⁻¹ G`` factorizes on the tensor
    grid (``E = Ex ⊗ M1y + M1x ⊗ Ey`` with ``Ex = G1xᵀ M1x⁻¹ G1x``), and its
    near-null tail is exactly the near-spurious pressure tail of the
    equal-order PN-PN discretization that makes the reference's diag-mass
    Schur preconditioner (reference NavierStokes_Solver.py:208-212) degrade
    with resolution (measured: ~20 → ~3000 GMRES iterations from P=4 8×8 to
    p16 64×64; study/schur_spectrum.py).  In the M-orthonormal eigenbasis of
    the per-direction pencils ``(Ex, M1x)`` the Schur complement
    ``S ≈ B K⁻¹ G`` is approximately diagonal with per-mode value
    ``(εx+εy)/(λ̂x+λ̂y)`` (``λ̂`` = stiffness Rayleigh quotients in the same
    basis), so::

        Ŝ⁻¹ r = Zx [ (λ̂x ⊕ λ̂y)/(εx ⊕ εy) ⊙ (Zxᵀ R Zy) ] Zyᵀ

    — four dense matmuls, exactly an FDM apply.  Measured (Stokes and
    Boussinesq-wind, study/schur_spectrum.py): iteration counts go flat in
    resolution (52→181 for mass vs 48→55 for spectral over 4× refinement).

    The boundary rows of S are *exactly* the pressure-stiffness rows
    ``K[mb,:]`` (the artificial ∂ₙp=0 rows; the divergence block has zero
    rows there), so they are eliminated exactly: the static boundary-ring
    block ``K_bb`` is dense-inverted once (size 2·Ngx+2·Ngy−4) and
    ``dp_b = K_bb⁻¹ (r_b − K_bi dp_int)`` costs one stiffness apply plus one
    small matmul.

    Built once per grid configuration; at p16 64×64 the dense boundary-ring
    inverse plus the pencil eigendecompositions cost ~30 s of host LAPACK,
    so the result is persisted to the :mod:`sem_jax` cache directory
    (:func:`sem_jax.utils.diskcache.cache_dir`, beside the XLA compile cache; disable
    with ``SEM_JAX_CACHE=0``) keyed by the grid configuration; on a cold
    cache the three independent LAPACK pieces (two pencils, ring inverse)
    build concurrently.

    Returns dict of NumPy constants: Zx, Zy, esum/ksum (Ngx, Ngy) — the
    per-mode pencil values and stiffness Rayleigh quotients, combined into
    ``ginv = (ksum + σ)/esum`` at trace time so a pseudo-transient mass
    shift σ (see ``_get_update``'s ``sigma``) reuses the same constants —
    and Kbb_inv.
    """
    import scipy.linalg
    from concurrent.futures import ThreadPoolExecutor

    from sem_jax.utils.diskcache import npz_cached

    def pencil(G1, m1, K1):
        E1 = G1.T @ (G1 / m1[:, None])
        s = 1.0 / np.sqrt(m1)
        A1 = (E1 * s[:, None]) * s[None, :]
        A1 = 0.5 * (A1 + A1.T)
        lam, Q = scipy.linalg.eigh(A1)
        Z = s[:, None] * Q
        lhat = (Z * (K1 @ Z)).sum(axis=0)  # per-mode Rayleigh quotients
        return lam, lhat, Z

    def ring_inverse():
        # boundary-ring stiffness block in edge-slice order (W row, E row,
        # S column sans corners, N column sans corners)
        Ngx, Ngy = grid.Ngx, grid.Ngy
        ixb = np.concatenate([np.zeros(Ngy, int), np.full(Ngy, Ngx - 1),
                              np.arange(1, Ngx - 1), np.arange(1, Ngx - 1)])
        iyb = np.concatenate([np.arange(Ngy), np.arange(Ngy),
                              np.zeros(Ngx - 2, int),
                              np.full(Ngx - 2, Ngy - 1)])
        # K[(ix1,iy1),(ix2,iy2)] =
        #   K1x[ix1,ix2]·m1y[iy1]·δ_y + m1x[ix1]·K1y[iy1,iy2]·δ_x
        Kbb = (grid.K1x[np.ix_(ixb, ixb)] * grid.m1y[iyb][:, None]
               * (iyb[:, None] == iyb[None, :])
               + grid.K1y[np.ix_(iyb, iyb)] * grid.m1x[ixb][:, None]
               * (ixb[:, None] == ixb[None, :]))
        return np.linalg.inv(Kbb)

    def build():
        with ThreadPoolExecutor(max_workers=3) as pool:
            fx = pool.submit(pencil, grid.G1x, grid.m1x, grid.K1x)
            fy = pool.submit(pencil, grid.G1y, grid.m1y, grid.K1y)
            fb = pool.submit(ring_inverse)
            ex, lx, Zx = fx.result()
            ey, ly, Zy = fy.result()
            Kbb_inv = fb.result()
        esum = ex[:, None] + ey[None, :]
        ksum = lx[:, None] + ly[None, :]
        return {"Zx": Zx, "Zy": Zy, "esum": esum, "ksum": ksum,
                "Kbb_inv": Kbb_inv}

    return npz_cached(f"spectral_v2_{grid.P}_{grid.N_ex}_{grid.N_ey}"
                      f"_{grid.L_x}_{grid.L_y}", build)


class NavierStokesSolver:
    def __init__(self, L_x: float, L_y: float, Re: float, Gr: float, P: int,
                 N_ex: int, N_ey: int,
                 v_W: float = 0, v_E: float = 0, u_S: float = 0, u_N: float = 0,
                 mtol: float = 1e-7, mtol_newton: float = 1e-5,
                 iprint: list = ("NEWTON_suc", "NEWTON_iter"),
                 restart: int = None, maxiter: int = 5000,
                 restart_velo: int = 60, maxiter_velo: int = 4000,
                 max_newton: int = 100, linear_solver: str = "coupled",
                 mixed_precision: bool = True, max_refine: int = 12,
                 schur_precon: str = "spectral", forcing: float = 1e-3,
                 velo_inner: int = 0,
                 basis_dtype=None, dtype=jnp.float64):
        """
        :param Re: Reynolds number; :param Gr: Grashof number
        :param v_W/v_E/u_S/u_N: tangential Dirichlet wall values
        :param mtol: RMS tolerance of the pressure-Schur GMRES
        :param mtol_newton: RMS tolerance of the Newton iteration
        :param iprint: tags among {'NEWTON_iter','NEWTON_suc','LGMRES_suc','VELO_suc'}
        :param restart/maxiter: GMRES window / total-iteration cap.  Default
            (None) auto-sizes the window: restarted GMRES stagnates on
            convection-dominated systems when the window is too small (e.g.
            the Re=400 cavity needs ~150+), so the window is made as large
            as a ~2 GB Krylov basis allows (a budget chosen on the earlier
            accelerator, not re-sized for the H100's memory), capped at 200
        :param restart_velo/maxiter_velo: velocity-block GMRES parameters
        :param max_newton: safety cap on Newton iterations (reference loops
            unboundedly, reference :253)
        :param linear_solver: ``'uzawa'`` — structural parity with the
            reference (pressure-Schur GMRES with exact inner velocity
            solves); ``'coupled'`` — one flexible-free GMRES on the full
            (du,dv,dp) saddle system with a block upper-triangular
            preconditioner (FDM velocity blocks + approximate Schur
            inverse), avoiding the nested Krylov entirely — the faster
            path
        :param forcing: inexact-Newton forcing factor η: each Newton step's
            linear system is solved only to RMS tolerance
            max(mtol, η·‖F‖/√(3N)) — early steps get cheap loose solves, the
            final steps tighten automatically (Dembo-Eisenstat-Steihaug).
            The Newton convergence test itself is unchanged, so results are
            identical within mtol_newton.  None = the reference's
            fixed-tolerance behavior; default 1e-3 (~1.7× faster solves).
        :param schur_precon: Schur-block approximation of the coupled
            preconditioner: ``'spectral'`` (default) — spectrally-matched
            tensor solve in the eigenbasis of the consistent pressure
            Poisson pencil + exact boundary-row elimination (measured
            resolution-independent iteration counts; see
            ``_spectral_schur_data``); ``'mass'`` — inverse diagonal GLL
            mass (the reference's choice, :208-212; iteration counts grow
            ~linearly with 1/h); ``'pcd'`` — pressure convection-diffusion
            Ŝ⁻¹ = M⁻¹ F_p A_p⁻¹ with A_p the FDM pseudo-inverse of the
            Neumann pressure Laplacian and F_p the convection-diffusion
            operator
        :param velo_inner: inner velocity-solve strength of the coupled
            preconditioner: 0 (default) = one FDM(Laplacian+σ) apply per
            application; k>0 replaces it with ``k`` iterations of
            FDM-right-preconditioned GMRES on the TRUE shifted velocity
            Jacobian (convection + reaction diagonals).  The inner solve
            varies per application, so the outer loop must be FLEXIBLE:
            the f64 single-level path uses :func:`sem_jax.krylov.fgmres`,
            and the mixed-precision path swaps its left-preconditioned
            plain-GMRES f32 chunks for ROW-SCALED right-preconditioned
            FGMRES chunks (solve D⁻¹A x = D⁻¹r with D a stochastic
            row-norm estimate conditioning the f32-visible norm — raw SEM
            row scales span ~1e7 — and the varying block preconditioner
            applied flexibly on the right).  Offline composition
            measurements (study/coupled_pc_diag.py, real Re=400 lid
            linearization, consistent RHS) show k=5 cutting outer
            iterations ~2.7×.  Even at the default 0, a mixed-precision
            solve that floors far above tolerance retries ONCE on the
            flexible k=5 path before paying the software-f64 fallback
            (``flex_retry_count`` counts these)
        :param basis_dtype: storage dtype of the f32 chunks' Krylov basis
            (``None`` = f32; ``jnp.bfloat16`` halves orthogonalization HBM
            traffic at the cost of a higher attainable chunk floor; it
            failed at p16 on the earlier accelerator)
        :param max_refine: SOFT floor on the mixed-precision refinement
            passes, not a hard cap: once the observed per-chunk iteration
            count is known, :func:`sem_jax.krylov.refined_gmres_host`
            raises the pass budget to whatever ``maxiter`` total inner
            iterations implies (its plateau/no-progress exits bound
            unproductive looping) — tune wall-clock through ``maxiter``;
            ``max_refine`` only guarantees a minimum refinement depth
        """
        self._iprint = list(iprint)
        self._Re = float(Re)
        self._Gr = float(Gr)
        if self._Re == 0 and self._Gr != 0:
            raise ValueError("Cannot have Re == 0 and Gr != 0")
        self._Gr_over_Re = self._Gr / self._Re if self._Re != 0 else 0.0
        self._mtol = float(mtol)
        self._mtol_newton = float(mtol_newton)
        N3 = 3 * (N_ex * P + 1) * (N_ey * P + 1)
        if restart is None:
            restart = min(200, max(60, int(2e9 / (4 * N3))))
        self._restart = int(restart)
        self._maxiter = int(maxiter)
        self._restart_velo = int(restart_velo)
        self._maxiter_velo = int(maxiter_velo)
        self._velo_inner = max(0, int(velo_inner))
        self._max_newton = int(max_newton)
        if linear_solver not in ("uzawa", "coupled"):
            raise ValueError("linear_solver must be 'uzawa' or 'coupled'")
        self._linear_solver = linear_solver
        if schur_precon not in ("mass", "pcd", "spectral"):
            raise ValueError(
                "schur_precon must be 'mass', 'pcd' or 'spectral'")
        self._schur_precon = schur_precon
        self._forcing = None if forcing is None else float(forcing)
        # mixed precision: float32 Krylov loops inside float64 iterative
        # refinement (half the basis traffic of f64; whether plain f64 is
        # as fast on the H100 is not measured yet); the refinement loop
        # restores full f64 accuracy ('coupled' path only)
        self._mixed_precision = bool(mixed_precision)
        self._max_refine = int(max_refine)
        # storage dtype of the f32 chunks' Krylov basis (None = f32).
        # bfloat16 halves the HBM traffic of the bandwidth-bound
        # orthogonalization sweeps; arithmetic stays f32 and the f64
        # refinement loop restores full accuracy — the cost is a higher
        # per-chunk attainable floor (more refinement passes).
        self._basis_dtype = basis_dtype
        self._dtype = dtype

        self.grid = Grid2D(P, N_ex, N_ey, L_x, L_y)
        self._L_x, self._L_y = float(L_x), float(L_y)
        self._P, self._N_ex, self._N_ey = P, N_ex, N_ey
        self.points = self.grid.points
        self.points_e = self.grid.points_e
        self.N = self.grid.N

        # Dirichlet values and masks (reference :78-91): no normal flow on all
        # walls, tangential values per side, pressure pinned at ~center node.
        dir_u = np.full(self.N, np.nan)
        dir_v = np.full(self.N, np.nan)
        for side, du_, dv_ in (("W", 0.0, v_W), ("E", 0.0, v_E),
                               ("S", u_S, 0.0), ("N", u_N, 0.0)):
            m = self.grid.side_mask(side)
            dir_u[m] = du_
            dir_v[m] = dv_
        # Closure constants stay HOST-resident (NumPy): a device array
        # closed over by a jitted function is read BACK from the device at
        # MLIR lowering time (mlir._array_mlir_constant_handler -> ._value),
        # once per program and process.  NumPy constants lower straight
        # from host memory.
        self._mask_bound_np = ~np.isnan(dir_u)
        self._mask_bound = self._mask_bound_np
        self._dirichlet_u = np.nan_to_num(dir_u).astype(dtype)
        self._dirichlet_v = np.nan_to_num(dir_v).astype(dtype)
        self._pin = int(self.N / 2)
        pin_mask = np.zeros(self.N, dtype=bool)
        pin_mask[self._pin] = True
        self._mask_pin_np = pin_mask
        self._mask_pin = pin_mask

        # exact masked-Laplacian inverse for the velocity blocks
        self._fdm = FDM2D(self.grid, dirichlet_x=(True, True),
                          dirichlet_y=(True, True))
        # pure-Neumann pressure Laplacian pseudo-inverse (PCD Schur block)
        self._fdm_p = (FDM2D(self.grid, dirichlet_x=(False, False),
                             dirichlet_y=(False, False))
                       if schur_precon == "pcd" else None)
        # spectrally-matched Schur block (see _spectral_schur_data)
        self._spec = (_spectral_schur_data(self.grid)
                      if schur_precon == "spectral" else None)

        # linearization state (u, v of the last _calc_jacobians; convection
        # Jacobian diagonals — reference :123-136 keeps 4 CSR matrices)
        self._lin32_cache = None  # f32 casts of the current linearization
        self._dinv32 = None       # cached row-norm scaling (velo_inner)
        self._u_lin = None
        self._v_lin = None
        self._jac = None  # (jxx, jxy, jyx, jyy) diagonal vectors
        self._sigma = 0.0  # pseudo-transient mass shift of the last
        #                    _calc_jacobians (0 = steady Newton)

        self._k = 0                 # Newton iterations of the last solve
        self.iter_count_solve = 0   # number of _get_update calls
        self.f64_fallback_count = 0  # single-level f64 retries of the mixed
        #                              path (0 = everything through f32)
        self.flex_retry_count = 0   # floored plain-f32 solves retried on the
        #                             flexible row-scaled velo_inner=5 path
        self.besteffort_floor_count = 0  # floored best-effort (precon) calls
        self.last_schur_info = None
        self.last_velo_info = None

        self._build_jitted()

    # ------------------------------------------------------------------ #
    def _build_jitted(self):
        grid = self.grid
        Re, GrRe = self._Re, self._Gr_over_Re
        mb, pin = self._mask_bound, self._mask_pin
        dir_u, dir_v = self._dirichlet_u, self._dirichlet_v
        fdm = self._fdm
        N = self.N
        dtype = self._dtype
        eps = float(np.finfo(np.dtype(dtype)).eps)

        atol_schur = self._mtol * np.sqrt(N)
        # velocity block: solved (nearly) exactly, like the reference's LU —
        # tight tolerance with a machine-precision floor
        atol_velo_abs = 1e-2 * self._mtol * np.sqrt(2 * N)

        def sys_apply(u, v, w):
            """K w + Re (u∂x + v∂y) w (reference 'Sys', :103-106)."""
            return ops.apply_stiffness(grid, w) \
                + Re * ops.apply_convection(grid, u, v, w)

        from sem_jax.parallel.sharding import constrain

        def residual(u, v, p, T):
            u, v, p, T = (constrain(u), constrain(v), constrain(p),
                          constrain(T))
            ru = sys_apply(u, v, u) + ops.apply_grad_x(grid, p)
            rv = sys_apply(u, v, v) + ops.apply_grad_y(grid, p) \
                - GrRe * ops.apply_mass(grid, T)
            rc = ops.apply_grad_x(grid, u) + ops.apply_grad_y(grid, v)
            ru = jnp.where(mb, u - dir_u, ru)
            rv = jnp.where(mb, v - dir_v, rv)
            Kp = ops.apply_stiffness(grid, p)
            rc = jnp.where(mb, Kp, rc)         # artificial ∂ₙp = 0 rows (:119)
            rc = jnp.where(pin, p, rc)         # pressure pin (:116)
            return ru, rv, rc

        def jac_diags(u, v, sigma):
            """Convection Jacobian diagonals, plus the pseudo-transient mass
            shift σ·diag(M) on the (u,u) and (v,v) blocks.  The GLL mass is
            diagonal, so the entire velocity shift σ·M of a pseudo-transient
            (implicit-Euler) Jacobian is exactly a Jacobian-diagonal shift —
            every downstream tangent apply (dense or banded form, device JNK)
            picks it up through the existing ``jac`` runtime arguments with
            no signature change."""
            md_ = jnp.asarray(grid.mass_diag.astype(np.dtype(dtype)))
            return (Re * ops.conv_diag_x(grid, u) + sigma * md_,
                    Re * ops.conv_diag_y(grid, u),
                    Re * ops.conv_diag_x(grid, v),
                    Re * ops.conv_diag_y(grid, v) + sigma * md_)

        def dres(du, dv, dp, dT, u_lin, v_lin, jac):
            jxx, jxy, jyx, jyy = jac
            du, dv, dp = constrain(du), constrain(dv), constrain(dp)
            dru = sys_apply(u_lin, v_lin, du) + jxx * du + jxy * dv \
                + ops.apply_grad_x(grid, dp)
            drv = sys_apply(u_lin, v_lin, dv) + jyx * du + jyy * dv \
                + ops.apply_grad_y(grid, dp) - GrRe * ops.apply_mass(grid, dT)
            drc = ops.apply_grad_x(grid, du) + ops.apply_grad_y(grid, dv)
            dru = jnp.where(mb, du, dru)
            drv = jnp.where(mb, dv, drv)
            drc = jnp.where(mb, ops.apply_stiffness(grid, dp), drc)
            drc = jnp.where(pin, dp, drc)
            return dru, drv, drc

        zero = lambda: jnp.zeros(N, dtype)

        def solve_velo(bu, bv, u_lin, v_lin, jac, q0, sigma):
            """Invert the masked 2N×2N velocity Jacobian (SuperLU replacement)."""
            b = jnp.concatenate([bu, bv])

            def mv(q):
                du, dv = q[:N], q[N:]
                dru, drv, _ = dres(du, dv, zero(), zero(), u_lin, v_lin, jac)
                return jnp.concatenate([dru, drv])

            def pc(q):
                duv = fdm(jnp.stack([q[:N], q[N:]]), sigma=sigma)
                return jnp.concatenate([duv[0], duv[1]])

            atol = jnp.maximum(jnp.asarray(atol_velo_abs, dtype),
                               10 * eps * jnp.linalg.norm(b))
            return gmres(mv, b, x0=q0, atol=atol,
                         restart=self._restart_velo,
                         maxiter=self._maxiter_velo, precon=pc)

        mass_diag = grid.mass_diag.astype(dtype)
        want_hist = "LGMRES_iter" in self._iprint
        Ngx, Ngy = grid.Ngx, grid.Ngy
        # combine the HOST copies of the masks: np.asarray on the device
        # arrays would be a device→host readback at every construction
        mb_or_pin = self._mask_bound_np | self._mask_pin_np

        def edges_get(Rg):
            """Boundary-ring values in W/E/S/N edge-slice order (static
            slices, no gather)."""
            return jnp.concatenate([Rg[0, :], Rg[-1, :],
                                    Rg[1:-1, 0], Rg[1:-1, -1]])

        def edges_set(Rg, vb):
            Rg = Rg.at[0, :].set(vb[:Ngy]).at[-1, :].set(vb[Ngy:2 * Ngy])
            Rg = Rg.at[1:-1, 0].set(vb[2 * Ngy:2 * Ngy + Ngx - 2])
            return Rg.at[1:-1, -1].set(vb[2 * Ngy + Ngx - 2:])

        def _make_spectral(xdtype):
            """Traceable Ŝ⁻¹ apply of the 'spectral' Schur block (see
            _spectral_schur_data): tensor solve on interior rows + exact
            elimination of the (static) boundary stiffness rows — all static
            slices, no gather/scatter.

            The returned apply takes the velocity-block mass shift ``sigma``
            (a traced scalar; 0 = steady) and matches the Schur complement of
            the shifted block ``A + σM`` mode-by-mode:
            ``ginv = (λ̂ ⊕ σ)/ε`` computed in-trace from the stored pencil
            spectra — one (Ngx, Ngy) elementwise op, negligible next to the
            four dense matmuls.  The boundary rows of S are the pressure
            stiffness rows (unaffected by the velocity shift), so ``Kbb_inv``
            stays exact.
            """
            Zx = self._spec["Zx"].astype(xdtype)
            Zy = self._spec["Zy"].astype(xdtype)
            # edge-only stiffness constants for the boundary-row elimination
            # (see apply_): K(dp_z) is needed only on the boundary ring, and
            # with dp_z zero on all edges those values reduce to two THIN
            # matmuls — K1x's first/last rows against dp_z, and dp_z's
            # interior rows against K1y's first/last columns (the
            # cross-direction terms vanish on zero edge slabs) — replacing
            # the two full-size stiffness matmuls.
            K1e = grid.K1x[[0, -1], :].astype(xdtype)
            K1yTe = grid.K1y[[0, -1], :].T.astype(xdtype)
            m1y_np = grid.m1y.astype(xdtype)
            m1x_in = grid.m1x[1:-1].astype(xdtype)
            esum_np = self._spec["esum"]
            scale = float(np.max(np.abs(esum_np)))
            # only the exact (constant ⊗ constant) null mode is cut — the
            # pressure pin handles constants; the near-spurious tail is the
            # point of the method and must NOT be truncated
            nz_np = np.abs(esum_np) > 1e-14 * scale
            nz = nz_np
            esafe = np.where(nz_np, esum_np, 1.0).astype(xdtype)
            ksum = self._spec["ksum"].astype(xdtype)
            Kbb_inv = self._spec["Kbb_inv"].astype(xdtype)
            hi = ops.mm_precision(xdtype)

            def apply_(rp, sigma):
                ginv = jnp.where(nz, (ksum + sigma) / esafe, 0.0)
                r_int = jnp.where(mb_or_pin, 0.0, rp).reshape(Ngx, Ngy)
                W = jnp.matmul(Zx.T, jnp.matmul(r_int, Zy, precision=hi),
                               precision=hi)
                dp_g = jnp.matmul(Zx, jnp.matmul(ginv * W, Zy.T,
                                                 precision=hi), precision=hi)
                # exact boundary-row elimination: dp_b = K_bb⁻¹(r_b − K_bi dp_i)
                dp_z = edges_set(dp_g, jnp.zeros(2 * Ngy + 2 * (Ngx - 2),
                                                 xdtype))
                # ring values of K(dp_z) via two thin matmuls (constants
                # precomputed above; exact — dp_z edges are zero)
                zrows = jnp.matmul(K1e, dp_z, precision=hi) * m1y_np[None, :]
                zcols = jnp.matmul(dp_z[1:-1, :], K1yTe, precision=hi) \
                    * m1x_in[:, None]
                zb = jnp.concatenate([zrows[0], zrows[1],
                                      zcols[:, 0], zcols[:, 1]])
                rb = edges_get(rp.reshape(Ngx, Ngy))
                dp_b = jnp.matmul(Kbb_inv, rb - zb, precision=hi)
                dp = edges_set(dp_z, dp_b).reshape(-1)
                return jnp.where(pin, rp, dp)

            return apply_

        spectral_f64 = (_make_spectral(dtype)
                        if self._schur_precon == "spectral" else None)

        def precon_schur(c, sigma):
            """Schur preconditioner of the Uzawa path: the reference's
            inverse-diagonal-mass (reference :208-212), or the
            resolution-robust 'spectral' block."""
            if self._schur_precon == "spectral":
                return spectral_f64(c, sigma)
            return jnp.where(pin, c, c / mass_diag)

        def update(res_u, res_v, res_cont, u_lin, v_lin, jac, dp0, mtol_s,
                   sigma):
            """Full Uzawa update (reference :162-236), one XLA program."""
            # velocity pre-solve: A⁻¹ rhs_uv
            q_star, velo_info = solve_velo(res_u, res_v, u_lin, v_lin, jac,
                                           jnp.zeros(2 * N, dtype), sigma)
            b_schur = res_cont - dres(q_star[:N], q_star[N:], zero(), zero(),
                                      u_lin, v_lin, jac)[2]

            def schur_mv(dp):
                bu, bv, _ = dres(zero(), zero(), dp, zero(), u_lin, v_lin, jac)
                f, _ = solve_velo(bu, bv, u_lin, v_lin, jac,
                                  jnp.zeros(2 * N, dtype), sigma)
                return dres(-f[:N], -f[N:], dp, zero(), u_lin, v_lin, jac)[2]

            # convergence floor: the absolute RMS tolerance (reference :223)
            # or mtol relative to the RHS scale, whichever is larger — the
            # Schur matvec contains nested velocity solves whose f64 noise
            # makes absolute targets below roundoff·||b|| unreachable
            atol_eff = jnp.maximum(mtol_s * np.sqrt(N),
                                   jnp.maximum(mtol_s, 50 * eps)
                                   * jnp.linalg.norm(b_schur))
            out = gmres(schur_mv, b_schur, x0=dp0,
                        atol=atol_eff, restart=self._restart,
                        maxiter=self._maxiter,
                        precon=lambda c: precon_schur(c, sigma),
                        return_hist=want_hist)
            dp, schur_info = out[0], out[1]
            hist = out[2] if want_hist else jnp.zeros(0, dtype)

            # velocity back-substitution (reference :232-235)
            bu, bv, _ = dres(zero(), zero(), dp, zero(), u_lin, v_lin, jac)
            q, velo_info2 = solve_velo(res_u - bu, res_v - bv, u_lin, v_lin,
                                       jac, q_star, sigma)
            return q[:N], q[N:], dp, schur_info, velo_info2, hist

        def _coupled_ops(u_lin, v_lin, jac, xdtype, velo_inner=0):
            """Coupled saddle matvec + block-triangular preconditioner in the
            given compute dtype (the operator kernels cast their constants by
            input dtype, so one definition serves f64 and the f32 fast path).
            """
            ul = u_lin.astype(xdtype)
            vl = v_lin.astype(xdtype)
            jxx, jxy, jyx, jyy = tuple(j.astype(xdtype) for j in jac)
            md = mass_diag.astype(xdtype)
            sd = jnp.asarray(grid.stiff_diag.astype(xdtype))
            coef = jnp.asarray(Re, xdtype)

            def mv(q):
                # the coupled tangent rows in one fused pass (the banded
                # form on one GPU, see sem_jax.ops.apply_impl); the pressure
                # pin row is the identity
                out = apply_coupled_system_best(
                    grid, q, ul, vl, (jxx, jxy, jyx, jyy), mb, coef)
                drc = jnp.where(pin, q[2 * N:], out[2 * N:])
                return jnp.concatenate([out[:2 * N], drc])

            spectral_x = (_make_spectral(xdtype)
                          if self._schur_precon == "spectral" else None)

            def pc(r, sigma):
                ru, rv, rp = r[:N], r[N:2 * N], r[2 * N:]
                if self._schur_precon == "spectral":
                    # resolution-robust spectrally-matched Schur block
                    # (handles its own boundary/pin rows)
                    dp = spectral_x(rp, sigma)
                elif self._schur_precon == "pcd":
                    # pressure convection-diffusion Schur approximation:
                    # Ŝ⁻¹ ≈ M⁻¹ F_p A_p⁻¹ (Elman-Silvester-Wathen), with
                    # A_p⁻¹ the FDM pseudo-inverse of the Neumann pressure
                    # Laplacian and F_p = K + Re·(u∂x + v∂y) on pressure.
                    # The masked rows (∂ₙp=0 boundary rows, pin) carry a
                    # different scale and are excluded from the Poisson solve.
                    rp_int = jnp.where(mb | pin, 0.0, rp)
                    t = self._fdm_p(rp_int)
                    s_ = ops.apply_system(grid, ul, vl, t,
                                          jnp.asarray(Re, xdtype))
                    dp = s_ / md
                else:
                    # reference's diagonal GLL mass (:208-212)
                    dp = rp / md
                if self._schur_precon != "spectral":
                    # artificial ∂ₙp=0 rows carry stiffness scale; pin = id
                    # ('spectral' eliminates the boundary block exactly)
                    dp = jnp.where(mb, rp / sd, dp)
                    dp = jnp.where(pin, rp, dp)
                gx = jnp.where(mb, 0.0, ops.apply_grad_x(grid, dp))
                gy = jnp.where(mb, 0.0, ops.apply_grad_y(grid, dp))
                bu_, bv_ = ru - gx, rv - gy
                if velo_inner == 0:
                    # both velocity FDM solves as one batched dispatch
                    duv = fdm(jnp.stack([bu_, bv_]), sigma=sigma)
                    return jnp.concatenate([duv[0], duv[1], dp])
                # velo_inner > 0: solve the TRUE shifted velocity Jacobian
                # (convection + reaction diagonals — mv carries σ inside
                # jxx/jyy, matching fdm's σ) by a bounded inner GMRES with
                # the FDM as right preconditioner.  The inner solve varies
                # per application ⇒ callers must use FLEXIBLE outer GMRES
                # (measured: a nonlinear pc inside plain GMRES silently
                # breaks the Arnoldi relation — ROADMAP r3 notes; offline
                # composition data: k=5 cuts outer its ~2.7× at Re=400).
                b2 = jnp.concatenate([bu_, bv_])
                zp = jnp.zeros(N, b2.dtype)

                def mv_velo(q2):
                    return mv(jnp.concatenate([q2, zp]))[:2 * N]

                def pc_velo(q2):
                    duv_ = fdm(jnp.stack([q2[:N], q2[N:]]), sigma=sigma)
                    return jnp.concatenate([duv_[0], duv_[1]])

                q2, _ = gmres(mv_velo, b2,
                              atol=jnp.asarray(0.0, b2.dtype),
                              restart=velo_inner, maxiter=velo_inner,
                              precon=pc_velo)
                return jnp.concatenate([q2[:N], q2[N:], dp])

            return mv, pc

        def update_coupled_f64(res_u, res_v, res_cont, u_lin, v_lin, jac,
                               dp0, mtol_s, sigma):
            """Pure-f64 single-level saddle-point solve (mixed_precision off).

            GMRES on the stacked (du,dv,dp) system with a block upper-
            triangular right preconditioner (dp = Ŝ⁻¹ r_p with the diagonal
            GLL mass ≈ the Schur complement, as the reference's own Schur
            preconditioner :208-212; velocity blocks du = Â⁻¹(r_u − ∇x dp)
            with Â⁻¹ the exact FDM inverse).
            """
            b = jnp.concatenate([res_u, res_v, res_cont])
            atol_eff = jnp.maximum(mtol_s * np.sqrt(3 * N),
                                   jnp.maximum(mtol_s, 50 * eps)
                                   * jnp.linalg.norm(b))
            mv64, pc64 = _coupled_ops(u_lin, v_lin, jac, dtype,
                                      velo_inner=self._velo_inner)
            q0 = jnp.concatenate([zero(), zero(), dp0])
            if self._velo_inner > 0:
                # the inner velocity GMRES varies per application —
                # flexible outer required (see pc)
                q, info, hist = fgmres(mv64, b, q0, atol=atol_eff,
                                       restart=self._restart,
                                       maxiter=self._maxiter,
                                       precon=lambda r: pc64(r, sigma))
                if not want_hist:
                    hist = jnp.zeros(0, dtype)
                return q[:N], q[N:2 * N], q[2 * N:], info, info, hist
            out = gmres(mv64, b, x0=q0, atol=atol_eff,
                        restart=self._restart,
                        maxiter=self._maxiter,
                        precon=lambda r: pc64(r, sigma),
                        return_hist=want_hist)
            q, info = out[0], out[1]
            hist = out[2] if want_hist else jnp.zeros(0, dtype)
            return q[:N], q[N:2 * N], q[2 * N:], info, info, hist

        def coupled_pc64(r, ul, vl, sigma):
            """The f64 coupled block preconditioner as a standalone traceable
            apply (spectral-Schur pressure block + batched FDM velocity).
            Exposed for reuse by the implicit-adjoint solver
            (sem_jax.coupling.implicit), which applies its exact TRANSPOSE
            via ``jax.vjp`` — the apply is linear in ``r``."""
            _, pcx = _coupled_ops(ul, vl,
                                  tuple(jnp.zeros(N, dtype)
                                        for _ in range(4)), dtype)
            return pcx(r, sigma)

        # --- separately-jitted pieces of the mixed-precision refinement ---
        # The refinement loop itself runs at host level (<= max_refine trips,
        # negligible dispatch cost): one all-fused megakernel (while-in-
        # while-in-cond) provokes XLA compile failures at north-star sizes,
        # and small programs compile in seconds instead of minutes.
        lp = jnp.float32

        def coupled_resid(x, b, u_lin, v_lin, jac):
            # the mass shift rides in the (shifted) jac diagonals — no
            # explicit sigma needed on the matvec side
            mv64, _ = _coupled_ops(u_lin, v_lin, jac, dtype)
            return b - mv64(x)

        def coupled_pc32(r32, ul32, vl32, sigma32):
            _, pc32 = _coupled_ops(ul32, vl32,
                                   tuple(jnp.zeros(N, lp) for _ in range(4)),
                                   lp)  # pc ignores the Jacobian diagonals
            return pc32(r32, sigma32)

        def coupled_pcprep(r, scale32, ul32, vl32, sigma32):
            # fused per-refinement-pass prep (downcast + pc + norm + chunk
            # tolerance in ONE dispatch — krylov.refined_gmres_host pc_prep)
            rp = coupled_pc32(r.astype(lp), ul32, vl32, sigma32)
            rpn = jnp.linalg.norm(rp)
            return rp, scale32 * rpn, rpn

        def coupled_pass_pc(x, xin, b, u_lin, v_lin, jac, ul32, vl32,
                            sigma32):
            # FULLY-FUSED refinement pass for the plain (left-pc) f32 chunks:
            # accumulate + f64 true residual + norm + downcast + pc + norm
            # in ONE program — the un-fused sequence cost ~5 dispatches and
            # 2-3 blocking readbacks per pass
            # (krylov.refined_gmres_host pass_fused)
            x = x + xin.astype(x.dtype)
            r = coupled_resid(x, b, u_lin, v_lin, jac)
            rp = coupled_pc32(r.astype(lp), ul32, vl32, sigma32)
            return x, jnp.linalg.norm(r), rp, jnp.linalg.norm(rp)

        def coupled_pass_rs(x, xin, b, u_lin, v_lin, jac, dinv32):
            # FULLY-FUSED refinement pass for the ROW-SCALED flexible chunks
            x = x + xin.astype(x.dtype)
            r = coupled_resid(x, b, u_lin, v_lin, jac)
            rp = r.astype(lp) * dinv32
            return x, jnp.linalg.norm(r), rp, jnp.linalg.norm(rp)

        def coupled_gmres32(rp32, x032, atol32, ul32, vl32, jac32, sigma32):
            # bounded chunk of left-preconditioned f32 GMRES (warm-started);
            # chunking bounds the runtime of each device dispatch
            mv32, pc32 = _coupled_ops(ul32, vl32, jac32, lp)
            return gmres(lambda q: pc32(mv32(q), sigma32), rp32, x0=x032,
                         atol=atol32, restart=self._restart,
                         maxiter=2 * self._restart + 5,
                         basis_dtype=self._basis_dtype,
                         return_hist=want_hist)

        def coupled_rownorms32(ul32, vl32, jac32, key):
            """Stochastic row-norm estimate of the f32 coupled operator
            (:func:`sem_jax.krylov.rownorm_estimate`).  ``D = diag(d)``
            conditions the f32-visible norm of the row-scaled flexible
            chunks: raw SEM rows mix stiffness- and unit-Dirichlet scales
            spanning ~1e7, beyond f32 resolution in the raw 2-norm."""
            mv32, _ = _coupled_ops(ul32, vl32, jac32, lp)
            return rownorm_estimate(mv32, 3 * N, lp, key)

        def make_fgmres32(k):
            """Row-scaled right-preconditioned FLEXIBLE f32 chunk (the
            varying-preconditioner analog of ``coupled_gmres32``): solve
            ``D⁻¹A x = D⁻¹r`` with the block preconditioner — including
            ``k`` FDM-preconditioned GMRES steps on the TRUE shifted
            velocity Jacobian — applied flexibly on the right.  ``dinv32``
            is 1/d from ``coupled_rownorms32``; the caller feeds the
            refinement residuals pre-scaled by the same ``dinv32``
            (ROADMAP r3 design note #4)."""

            def coupled_fgmres32(rp32, x032, atol32, ul32, vl32, jac32,
                                 sigma32, dinv32):
                mv32, pc32 = _coupled_ops(ul32, vl32, jac32, lp,
                                          velo_inner=k)
                x, info, hist = fgmres(
                    lambda q: mv32(q) * dinv32, rp32, x032, atol=atol32,
                    restart=self._restart, maxiter=2 * self._restart + 5,
                    basis_dtype=self._basis_dtype,
                    precon=lambda r: pc32(r / dinv32, sigma32))
                if want_hist:
                    return x, info, hist
                return x, info

            return jit_hoisted(
                coupled_fgmres32,
                f"ns.fgmres32k{k}@{self.grid.tag}/{self._linear_solver}")

        # jit_hoisted keeps the large solver constants (operator matrices,
        # spectral/FDM transforms, boundary-ring inverse) OUT of the
        # executables: they are passed as device-resident runtime arguments
        # instead of HLO literals, shrinking the serialized programs ~10x
        # (see sem_jax.utils.hoist)
        from sem_jax.utils.hoist import jit_hoisted
        tag = f"@{self.grid.tag}/{self._linear_solver}"
        self._residual_jit = jit_hoisted(residual, "ns.residual" + tag)
        self._jac_diags_jit = jit_hoisted(jac_diags, "ns.jac_diags" + tag)
        self._dres_jit = jit_hoisted(dres, "ns.dres" + tag)
        self._update_jit = jit_hoisted(update if self._linear_solver ==
                                       "uzawa" else update_coupled_f64,
                                       "ns.update" + tag)
        self._cres_jit = jit_hoisted(coupled_resid, "ns.cres" + tag)
        self._pc32_jit = jit_hoisted(coupled_pc32, "ns.pc32" + tag)
        self._pcprep_jit = jit_hoisted(coupled_pcprep, "ns.pcprep" + tag)
        self._pass_pc_jit = jit_hoisted(coupled_pass_pc, "ns.pass_pc" + tag)
        self._pass_rs_jit = jit_hoisted(coupled_pass_rs, "ns.pass_rs" + tag)
        self._gmres32_jit = jit_hoisted(coupled_gmres32, "ns.gmres32" + tag)
        self._rownorm32_jit = jit_hoisted(coupled_rownorms32,
                                          "ns.rownorm32" + tag)
        self._pc64_fn = coupled_pc64    # traceable; vjp-able (adjoints)
        # flexible chunks are built lazily per inner strength k (each is a
        # separate megakernel — only pay its compile/load when used)
        self._make_fgmres32 = make_fgmres32
        self._fgmres32_jits = {}
        # concurrent first-call prefetch of previously-recorded programs
        # (time-to-first-solution; no-op without a manifest/accelerator)
        from sem_jax.utils import prefetch
        prefetch.warm_async()

    def _update_coupled_mixed(self, res_u, res_v, res_cont, dp0, mtol,
                              velo_inner=None, x0_full=None):
        """Host-level f64 iterative refinement around jitted f32 GMRES.

        Two chunk flavors (both enforce the TRUE f64 residual tolerance
        through the refinement loop and keep the best iterate):

        * ``velo_inner == 0`` (default): LEFT-preconditioned plain-GMRES f32
          chunks (raw SEM row scales span ~1e7, beyond f32 resolution; in
          the preconditioned norm the rows are O(1)).  Requires a fixed
          LINEAR preconditioner.
        * ``velo_inner == k > 0``: ROW-SCALED right-preconditioned FGMRES
          chunks — solve ``D⁻¹A x = D⁻¹r`` with ``D`` a stochastic row-norm
          estimate (the f32 norm conditioner replacing the left pc) and the
          VARYING block preconditioner (k FDM-preconditioned GMRES steps on
          the true shifted velocity Jacobian) applied flexibly on the right.
          Offline composition data: k=5 cuts outer iterations ~2.7× on
          convection-dominated linearizations (study/coupled_pc_diag.py).

        :param velo_inner: per-call override of the constructor knob
        :param x0_full: optional stacked (3N,) warm start (e.g. the floored
            iterate of a previous attempt); the refinement's best-iterate
            tracking guarantees the result is never worse than it
        """
        N = self.N
        dtype = self._dtype
        lp = jnp.float32
        eps = float(np.finfo(np.dtype(dtype)).eps)
        k_inner = self._velo_inner if velo_inner is None else int(velo_inner)
        b = place(jnp.concatenate([place(res_u, dtype), place(res_v, dtype),
                                   place(res_cont, dtype)]), dtype)
        # ‖b‖ is computed on device and rides the refinement loop's first
        # combined read (atol_fn) — no up-front blocking readback here
        atol_fn = (lambda bn: max(mtol * np.sqrt(3 * N),
                                  max(mtol, 50 * eps) * bn))

        ul32, vl32, jac32, sigma32 = self._lin32()

        x0 = (jnp.concatenate([jnp.zeros(2 * N, dtype), dp0])
              if x0_full is None else place(x0_full, dtype))
        count = [0]

        if k_inner > 0:
            dinv32 = self._dinv32
            if dinv32 is None:
                dinv32 = 1.0 / self._rownorm32_jit(ul32, vl32, jac32,
                                                   jax.random.PRNGKey(0))
                self._dinv32 = dinv32
            chunkf = self._fgmres32_jits.get(k_inner)
            if chunkf is None:
                chunkf = self._make_fgmres32(k_inner)
                self._fgmres32_jits[k_inner] = chunkf
            pass_fused = lambda x, xin: self._pass_rs_jit(
                x, xin, b, self._u_lin, self._v_lin, self._jac, dinv32)

            def raw_chunk(rp, xin, atol_lp):
                return chunkf(rp, xin, atol_lp, ul32, vl32, jac32, sigma32,
                              dinv32)
        else:
            pass_fused = lambda x, xin: self._pass_pc_jit(
                x, xin, b, self._u_lin, self._v_lin, self._jac, ul32, vl32,
                sigma32)

            def raw_chunk(rp, xin, atol_lp):
                return self._gmres32_jit(rp, xin, atol_lp, ul32, vl32,
                                         jac32, sigma32)

        def chunk(rp, xin, atol_lp):
            out = raw_chunk(rp, xin, atol_lp)
            if len(out) == 3:   # 'LGMRES_iter' (f32 inner-loop residuals)
                xc, infoc, hist = out
                h = np.asarray(hist)
                for j in range(int(infoc.iterations)):
                    print(f"NavierStokes LGMRES: {count[0] + j + 1}\t{h[j]}")
                count[0] += int(infoc.iterations)
                return xc, infoc
            return out

        x, info = refined_gmres_host(
            cres=None, pc_lp=None, pass_fused=pass_fused,
            gmres_chunk=chunk,
            b=b, x0=x0, atol_fn=atol_fn, maxiter=self._maxiter,
            max_refine=self._max_refine)
        return x[:N], x[N:2 * N], x[2 * N:], info, info

    # ---------------- seven-method discipline protocol ---------------- #
    def _get_residuals(self, u, v, p, T):
        """Momentum + continuity residuals (reference :93-121)."""
        u = place(u, self._dtype)
        v = place(v, self._dtype)
        self._u_lin, self._v_lin = u, v  # 'Sys' statefulness (reference :106)
        return self._residual_jit(u, v, place(p, self._dtype),
                                  place(T, self._dtype))

    def _calc_jacobians(self, u, v, sigma: float = 0.0):
        """Precompute the convection Jacobian diagonals (reference :123-136).

        :param sigma: pseudo-transient mass shift σ of the velocity blocks
            (the Jacobian becomes that of implicit Euler with Δt = Re/σ,
            i.e. A + σM; the GLL mass is diagonal so the shift lives in the
            (u,u)/(v,v) Jacobian diagonals).  The stored σ also steers the
            preconditioners of the subsequent ``_get_update`` — steady
            solves use the default 0.
        """
        u = place(u, self._dtype)
        v = place(v, self._dtype)
        self._u_lin, self._v_lin = u, v
        self._sigma = float(sigma)
        self._jac = self._jac_diags_jit(u, v,
                                        jnp.asarray(sigma, self._dtype))
        self._dinv32 = None  # row-norm scaling follows the linearization
        #                      (reset HERE at the mutation site — readers
        #                      must never see the previous iterate's D)

    def _lin32(self):
        """f32 casts of the current linearization (u_lin, v_lin, jac, σ),
        computed ONCE per linearization instead of per discipline solve —
        each astype/asarray is a dispatch (~6 dispatches × ~20 solves per
        coupled JNK run).
        Invalidation is by object identity of the stored linearization."""
        src = (self._u_lin, self._v_lin, self._jac, self._sigma)
        cached = self._lin32_cache
        if (cached is None
                or cached[0][0] is not src[0] or cached[0][1] is not src[1]
                or cached[0][2] is not src[2] or cached[0][3] != src[3]):
            lp = jnp.float32
            val = (src[0].astype(lp), src[1].astype(lp),
                   tuple(j.astype(lp) for j in src[2]),
                   jnp.asarray(src[3], lp))
            self._lin32_cache = (src, val)
            self._dinv32 = None  # row-norm scaling follows the linearization
            cached = self._lin32_cache
        return cached[1]

    def _get_dresiduals(self, du, dv, dp, dT=None):
        """Tangent residuals with the stored linearization (reference :138-160)."""
        z = jnp.zeros(self.N, self._dtype)
        dT = z if dT is None else place(dT, self._dtype)
        return self._dres_jit(place(du, self._dtype),
                              place(dv, self._dtype),
                              place(dp, self._dtype), dT,
                              self._u_lin, self._v_lin, self._jac)

    def _get_update(self, dres_u, dres_v, dres_cont,
                    du0=None, dv0=None, dp0=None, mtol=None,
                    best_effort=False):
        """Linear solve for (du, dv, dp) (reference :162-236).

        :param mtol: optional per-call RMS tolerance override (used by the
            MDA to run preconditioner applications loosely)
        :param best_effort: return the best-achievable iterate instead of
            escalating — no f64 retry when the f32 mixed path floors above
            tolerance, no RuntimeError on non-convergence.  For
            *preconditioner* applications inside a flexible outer Krylov
            loop (FGMRES tolerates arbitrary inexact preconditioning):
            at Ra≳1e7 the convection-dominated tangent blocks floor every
            f32 chunk, and escalating each preconditioner application to
            the full software-f64 saddle solve turned single coupled-GMRES
            iterations into multi-minute stalls (measured, p16 64×64)
        """
        dp0 = (jnp.zeros(self.N, self._dtype) if dp0 is None
               else place(dp0, self._dtype))
        mtol_f = float(self._mtol if mtol is None else mtol)
        if self._linear_solver == "coupled" and self._mixed_precision:
            du, dv, dp, schur_info, velo_info = self._update_coupled_mixed(
                dres_u, dres_v, dres_cont, dp0, mtol_f)
            if not bool(schur_info.converged):
                # The mixed path plateaued.  A plateau *near* the tolerance
                # is the f32/roundoff floor — accept it (outer Newton checks
                # are authoritative).  A plateau far above it means the f32
                # chunks cannot deliver the needed reduction at this
                # conditioning (strongly convection-dominated velocity
                # blocks) — retry with the single-level f64 solve, which
                # handles the same systems at f64 depth (measured: the
                # Re=400 P=8 lid-cavity tangent systems converge in ~190
                # f64 iterations while every f32 chunk stalls).
                eps = float(np.finfo(np.dtype(self._dtype)).eps)
                # ‖b‖ was computed on device inside the refinement loop and
                # rode its first combined readback (saves three blocking
                # readbacks per rescue check)
                nb = float(schur_info.bnorm)
                if nb == 0.0:
                    nb = float(np.sqrt(
                        float(_sqnorm(dres_u))
                        + float(_sqnorm(dres_v))
                        + float(_sqnorm(dres_cont))))
                atol_eff = max(mtol_f * np.sqrt(3 * self.N),
                               max(mtol_f, 50 * eps) * nb)

                def needs_rescue(info):
                    # two useless-stall shapes: floored FAR above tolerance,
                    # or floored with (near-)ZERO progress on the RHS — the
                    # latter can sit *below* the 100× cut when the Newton
                    # residual is already within ~2 decades of target, and
                    # accepting its ~zero update freezes the outer Newton
                    # (measured: Re=400 P=8 16×16 stagnated 8 iterations at
                    # 3.3× target with bit-identical residuals)
                    rn_ = float(info.resnorm)
                    return rn_ > 100 * atol_eff or rn_ > 0.9 * nb

                if needs_rescue(schur_info) and best_effort:
                    # preconditioner application: the floored iterate is a
                    # usable (weaker) preconditioner — never pay the f64 tax
                    self.besteffort_floor_count += 1
                elif needs_rescue(schur_info):
                    if self._velo_inner == 0:
                        # escalation step 1 — retry on the flexible
                        # row-scaled f32 path with a k=5 inner velocity
                        # solve (measured: cuts outer iterations ~2.7× on
                        # convection-dominated linearizations, exactly the
                        # regime where the plain chunks floor), warm-started
                        # at the floored iterate.  Only floor-far cases pay
                        # its extra per-application cost.
                        self.flex_retry_count += 1
                        out = self._update_coupled_mixed(
                            dres_u, dres_v, dres_cont, dp0, mtol_f,
                            velo_inner=5,
                            x0_full=jnp.concatenate([du, dv, dp]))
                        adopted = (float(out[3].resnorm)
                                   < float(schur_info.resnorm))
                        if adopted:
                            du, dv, dp, schur_info, velo_info = out
                        if "LGMRES_suc" in self._iprint:
                            print("NavierStokes linear solve: plain f32 "
                                  "chunks floored; flexible velo_inner=5 "
                                  "retry reached resnorm "
                                  f"{float(out[3].resnorm):.3e} "
                                  + ("(adopted)" if adopted else
                                     "(worse — kept plain-chunk iterate)"))
                    if (not bool(schur_info.converged)
                            and (needs_rescue(schur_info)
                                 or not bool(schur_info.stalled))):
                        # escalation step 2 — the software-f64 single-level
                        # saddle solve.  Also fires when the (possibly
                        # retried) iterate sits below the rescue thresholds
                        # but is non-converged AND non-stalled: that state
                        # would raise at the fail-fast check below, where
                        # round-3 semantics always rescued in f64 first.
                        self.f64_fallback_count += 1
                        mtol_s = jnp.asarray(mtol_f, self._dtype)
                        (du, dv, dp, schur_info, velo_info,
                         _) = self._update_jit(
                            place(dres_u, self._dtype),
                            place(dres_v, self._dtype),
                            place(dres_cont, self._dtype),
                            self._u_lin, self._v_lin, self._jac, dp0, mtol_s,
                            jnp.asarray(self._sigma, self._dtype))
                        if "LGMRES_suc" in self._iprint:
                            print("NavierStokes linear solve: mixed-"
                                  "precision path floored far above "
                                  "tolerance; retried in f64")
        else:
            mtol_s = jnp.asarray(mtol_f, self._dtype)
            du, dv, dp, schur_info, velo_info, hist = self._update_jit(
                place(dres_u, self._dtype), place(dres_v, self._dtype),
                place(dres_cont, self._dtype),
                self._u_lin, self._v_lin, self._jac, dp0, mtol_s,
                jnp.asarray(self._sigma, self._dtype))
            if "LGMRES_iter" in self._iprint:
                h = np.asarray(hist)
                for j in range(int(schur_info.iterations)):
                    print(f"NavierStokes LGMRES: {j + 1}\t{h[j]}")
        self.last_schur_info = schur_info
        self.last_velo_info = velo_info
        self.iter_count_solve += 1
        # Roundoff-stalled solves (no progress over a full restart cycle /
        # refinement pass) return the best-achievable iterate and are
        # accepted: the outer Newton/MDA convergence checks on the TRUE
        # nonlinear residual are authoritative.  Only genuine non-convergence
        # (maxiter exhausted while still progressing) raises, mirroring the
        # reference's fail-fast on Krylov breakdown (reference :225-226).
        if (not bool(schur_info.converged) and not bool(schur_info.stalled)
                and not best_effort):
            raise RuntimeError(
                f"NavierStokes Schur GMRES: failed to converge in "
                f"{int(schur_info.iterations)} iterations (resnorm "
                f"{float(schur_info.resnorm):.3e})")
        if "LGMRES_suc" in self._iprint:
            status = ("converged" if bool(schur_info.converged)
                      else "stalled (roundoff plateau)")
            print(f"NavierStokes Schur GMRES: {status} in "
                  f"{int(schur_info.iterations)} iterations "
                  f"({int(schur_info.resweeps)} DGKS resweeps) with resnorm "
                  f"{float(schur_info.resnorm):.3e}")
        if "VELO_suc" in self._iprint or "LU_suc" in self._iprint:
            print(f"NavierStokes velocity solve: {int(velo_info.iterations)} "
                  f"iterations, resnorm {float(velo_info.resnorm):.3e}, "
                  f"converged={bool(velo_info.converged)}")
        return du, dv, dp

    def _get_solution(self, T, u0=None, v0=None, p0=None, mtol=None):
        """Newton iteration to RMS tolerance (reference :238-270).

        :param mtol: optional RMS tolerance override for this solve (applies
            to both the Newton test and the inner linear solves — used by the
            MDA to run the iteration-0 subsystem sweep loosely)
        """
        z = jnp.zeros(self.N, self._dtype)
        u = z if u0 is None else place(u0, self._dtype)
        v = z if v0 is None else place(v0, self._dtype)
        p = z if p0 is None else place(p0, self._dtype)
        T = place(T, self._dtype)

        atol = (self._mtol_newton if mtol is None else mtol)             * np.sqrt(self.N * 3)
        self._k = 0
        stag = 0
        best = float("inf")
        while True:
            ru, rv, rc = self._get_residuals(u, v, p, T)
            norm = float(jnp.sqrt(_sqnorm(ru) + _sqnorm(rv)
                                  + _sqnorm(rc)))
            if "NEWTON_iter" in self._iprint:
                print(f"NavierStokes NEWTON: {self._k}\t{norm}")
            if norm <= atol:
                if "NEWTON_suc" in self._iprint:
                    mx = float(jnp.max(jnp.concatenate([
                        jnp.abs(ru), jnp.abs(rv), jnp.abs(rc)])))
                    print(f"NavierStokes NEWTON: Converged in {self._k} "
                          f"iterations with max-norm {mx}")
                break
            # fail fast on stagnation: when the (stall-accepted) linear
            # solves stop producing useful updates, the residual freezes —
            # raising after 8 flat iterations beats burning max_newton
            stag = stag + 1 if norm > 0.999 * best else 0
            best = min(best, norm)
            if stag >= 8 or self._k >= self._max_newton:
                raise RuntimeError(
                    f"NavierStokes NEWTON: no convergence in {self._k} "
                    f"iterations (residual {norm:.3e}, target {atol:.3e}"
                    + (", stagnated" if stag >= 8 else "") + ")")
            self._calc_jacobians(u, v)
            mtol_k = mtol
            if self._forcing is not None:
                floor = self._mtol if mtol is None else mtol
                mtol_k = max(floor,
                             self._forcing * norm / np.sqrt(3 * self.N))
            du, dv, dp = self._get_update(-ru, -rv, -rc, mtol=mtol_k)
            u = u + du
            v = v + dv
            p = p + dp
            self._k += 1
        return u, v, p

    def solve_ptc(self, T, u0=None, v0=None, p0=None, mtol=None,
                  dt0: float = 0.1, growth: float = 3.0,
                  dt_max: float = 1e12, forcing_ptc: float = 1e-2,
                  max_steps: int = 300):
        """Pseudo-transient continuation solve — globally-convergent path to
        steady states where the from-zero Newton fails (convection-dominated
        regimes, e.g. the Re≥400 lid cavity on fine grids where round-2
        needed a full-f64 fallback; capability beyond the reference, whose
        Newton loop reference :253-268 simply diverges there).

        Each step solves the damped/implicit-Euler system
        ``(J + σM)δ = −F`` with σ = Re/Δt carried in the Jacobian diagonals
        (``_calc_jacobians(sigma=...)``) and matched by the shifted FDM and
        Schur preconditioners — the linear systems stay diagonally dominant
        (and inside the f32 mixed-precision path's attainable range) exactly
        when the steady ones are intractable.  The Δt schedule is the shared
        :class:`sem_jax.ptc.SERController` (SER ramp, blowup rejection,
        linear-failure-gated shrink + Δt trust-region ceiling — one
        implementation with the coupled :meth:`BoussinesqMDA._solve_ptc`).
        As Δt→∞ the step is exact Newton; convergence is tested on the
        unchanged steady residual at the same RMS tolerance as
        :meth:`_get_solution`.

        :return: (u, v, p)
        """
        from sem_jax.ptc import SERController

        z = jnp.zeros(self.N, self._dtype)
        u = z if u0 is None else place(u0, self._dtype)
        v = z if v0 is None else place(v0, self._dtype)
        p = z if p0 is None else place(p0, self._dtype)
        T = place(T, self._dtype)
        atol = ((self._mtol_newton if mtol is None else mtol)
                * np.sqrt(self.N * 3))
        ctrl = SERController(dt0, growth=growth, dt_max=dt_max)
        self._k = 0
        ru, rv, rc = self._get_residuals(u, v, p, T)
        norm = float(jnp.sqrt(_sqnorm(ru) + _sqnorm(rv)
                              + _sqnorm(rc)))
        linfail_rejects = 0
        for k in range(max_steps):
            if "NEWTON_iter" in self._iprint:
                print(f"NavierStokes PTC: {k}\t{norm}\tdt={ctrl.dt:.3g}")
            if norm <= atol:
                if "NEWTON_suc" in self._iprint:
                    print(f"NavierStokes PTC: Converged in {k} steps")
                return u, v, p
            self._calc_jacobians(u, v, sigma=self._Re / ctrl.dt)
            floor = self._mtol if mtol is None else mtol
            mtol_k = max(floor, forcing_ptc * norm / np.sqrt(3 * self.N))
            # best_effort: inside PTC the Δt controller owns recovery — a
            # floored/failed linear solve must feed back as ``lin_failed``
            # (Δt cut restores preconditioner dominance) instead of raising
            # RuntimeError or paying the flex/f64 escalation ladder against
            # a shift the controller is about to strengthen anyway (the
            # MDA PTC path has identical semantics via its best_effort
            # block-Jacobi preconditioner)
            du, dv, dp = self._get_update(-ru, -rv, -rc, mtol=mtol_k,
                                          best_effort=True)
            info = self.last_schur_info
            lin_failed = (not bool(info.converged)
                          and float(info.resnorm)
                          > 10 * mtol_k * np.sqrt(3 * self.N))
            un, vn, pn = u + du, v + dv, p + dp
            run_, rvn, rcn = self._get_residuals(un, vn, pn, T)
            norm_new = float(jnp.sqrt(_sqnorm(run_)
                                      + _sqnorm(rvn)
                                      + _sqnorm(rcn)))
            self._k += 1
            if not np.isfinite(norm_new) or norm_new > 1e3 * max(norm, 1.0):
                if not ctrl.reject_blowup():
                    raise RuntimeError(
                        f"NavierStokes PTC: pseudo-time step collapsed at "
                        f"residual {norm:.3e}")
                continue
            if lin_failed and norm_new > norm and linfail_rejects < 3:
                # a dx that failed its linear solve AND raised the residual
                # is not a pseudo-time step: re-solve about the same state
                # at the damped Δt (bounded; MDA PTC has identical
                # semantics — see SERController.reject_linfail)
                linfail_rejects += 1
                if not ctrl.reject_linfail():
                    raise RuntimeError(
                        f"NavierStokes PTC: pseudo-time step collapsed at "
                        f"residual {norm:.3e}")
                continue
            linfail_rejects = 0
            ctrl.accept(norm, norm_new, lin_failed)
            u, v, p = un, vn, pn
            ru, rv, rc = run_, rvn, rcn
            norm = norm_new
        raise RuntimeError(
            f"NavierStokes PTC: no convergence in {max_steps} steps "
            f"(residual {norm:.3e}, target {atol:.3e})")

    def _get_vector(self, f_func: typing.Callable) -> np.ndarray:
        """Evaluate a callable at the global nodes (reference :272-278)."""
        return np.asarray(f_func(self.points[0], self.points[1]), dtype=float)

    def _get_interpol(self, f, points_plot) -> np.ndarray:
        """Evaluate the SEM interpolant at plot points (reference :280-288)."""
        return PointEvaluator(self.grid, points_plot)(place(f, self._dtype))

    def run(self, T_func, points_plot):
        """End-to-end solve: temperature → (u, v, p) at plot points
        (reference :290-303)."""
        T = jnp.asarray(self._get_vector(T_func), self._dtype)
        u, v, p = self._get_solution(T)
        return (self._get_interpol(u, points_plot),
                self._get_interpol(v, points_plot),
                self._get_interpol(p, points_plot))
