"""Steady convection-diffusion solver (matrix-free).

Solves, for T(x,y) on [0,L_x]×[0,L_y] given velocities u, v::

    Pe [u, v]∘∇T = ∇²T

with per-side Dirichlet (value) or homogeneous Neumann (``None``) boundary
conditions — exactly the BC semantics of the reference
(reference ConvectionDiffusion_Solver.py:9-71).

Implements the same seven-method implicit-discipline protocol the reference's
coupling layer consumes (``_get_residuals``, ``_calc_jacobians``,
``_get_dresiduals``, ``_get_update``, ``_get_solution``, ``_get_vector``,
``_get_interpol`` — reference ConvectionDiffusion_Solver.py:73-188), so a user
of the reference finds the identical surface, but:

* the residual/Jacobian applies are matrix-free (no CSR, no rank-3 COO
  tensors — cf. reference :53-55, :82-87, :101-102);
* the linear solve is an on-device jitted GMRES **right-preconditioned by an
  exact fast-diagonalization inverse of the masked diffusion operator**
  (``sem_jax.fdm.FDM2D``), instead of unpreconditioned SciPy LGMRES with an
  O(0.3·N) inner window (reference :146-148).
"""
from __future__ import annotations

import typing

import numpy as np

import jax
import jax.numpy as jnp

from sem_jax import operators as ops
from sem_jax.fdm import FDM2D
from sem_jax.interp import PointEvaluator
from sem_jax.krylov import gmres, refined_gmres_host
from sem_jax.mesh import Grid2D
from sem_jax.ops import apply_system_best
from sem_jax.parallel.sharding import place

__all__ = ["ConvectionDiffusionSolver"]


class ConvectionDiffusionSolver:
    def __init__(self, L_x: float, L_y: float, Pe: float, P: int,
                 N_ex: int, N_ey: int,
                 T_W: float = None, T_E: float = None,
                 T_S: float = None, T_N: float = None,
                 mtol: float = 1e-7, iprint: list = (),
                 restart: int = None, maxiter: int = 5000,
                 mixed_precision: bool = True,
                 dtype=jnp.float64):
        """
        :param L_x, L_y: domain lengths
        :param Pe: Peclet number
        :param P: polynomial order
        :param N_ex, N_ey: elements per direction
        :param T_W/T_E/T_S/T_N: Dirichlet value or None ⇒ homogeneous Neumann
        :param mtol: tolerance on RMS residual for the linear solve
            (absolute tolerance = mtol·√N, reference convention :147)
        :param iprint: diagnostics tags; supports 'LGMRES_suc' (solve summary)
        :param restart: GMRES restart window (None ⇒ auto-sized: large
            windows prevent restarted-GMRES stagnation at high Peclet; capped
            by a ~2 GB Krylov basis — a budget chosen on the earlier
            accelerator, not re-sized for the H100 — and at 200)
        :param maxiter: GMRES max total iterations
        :param dtype: compute dtype (float64 default for spectral accuracy)
        """
        self._iprint = list(iprint)
        self._Pe = float(Pe)
        self._mtol = float(mtol)
        Nn = (N_ex * P + 1) * (N_ey * P + 1)
        if restart is None:
            restart = min(200, max(60, int(2e9 / (4 * Nn))))
        self._restart = int(restart)
        self._maxiter = int(maxiter)
        # float32 Krylov loop inside float64 iterative refinement
        self._mixed_precision = bool(mixed_precision)
        self._dtype = dtype

        self.grid = Grid2D(P, N_ex, N_ey, L_x, L_y)
        self._L_x, self._L_y = float(L_x), float(L_y)
        self._P, self._N_ex, self._N_ey = P, N_ex, N_ey
        self.points = self.grid.points
        self.points_e = self.grid.points_e
        self.N = self.grid.N

        # Dirichlet values & mask (None ⇒ homogeneous Neumann on that side),
        # matching reference ConvectionDiffusion_Solver.py:62-71.
        dirichlet = np.full(self.N, np.nan)
        for side, val in (("W", T_W), ("E", T_E), ("S", T_S), ("N", T_N)):
            if val is not None:
                dirichlet[self.grid.side_mask(side)] = val
        # host-resident closure constants (device arrays closed over by
        # jitted code are read back from the device at lowering; see the
        # NS solver note)
        self._mask_dir_np = ~np.isnan(dirichlet)
        self._mask_dir = self._mask_dir_np
        self._dirichlet = np.where(self._mask_dir_np, dirichlet,
                                   0.0).astype(dtype)

        # exact masked-diffusion inverse (preconditioner)
        self._fdm = FDM2D(self.grid,
                          dirichlet_x=(T_W is not None, T_E is not None),
                          dirichlet_y=(T_S is not None, T_N is not None))

        # linearization state (mirrors the reference's statefulness:
        # _Sys from the last _get_residuals call :85, Jacobians from the last
        # _calc_jacobians call :101-102)
        self._u = None
        self._v = None
        self._lin32_cache = None  # f32/f64 casts of the current wind + σ
        self._sigma64_cache = None
        self._jac_diag_u = None   # diag of ∂res/∂u (global diagonal)
        self._jac_diag_v = None
        self._sigma = 0.0         # pseudo-transient T-block mass shift of
        #                           the last _calc_jacobians (0 = steady)

        self.iter_count_solve = 0   # number of _get_update calls
        self.last_info = None       # KrylovInfo of the last linear solve

        self._build_jitted()

    # ------------------------------------------------------------------ #
    def _build_jitted(self):
        grid, Pe = self.grid, self._Pe
        mask, dirichlet = self._mask_dir, self._dirichlet
        fdm = self._fdm
        atol = self._mtol * np.sqrt(self.N)
        restart, maxiter = self._restart, self._maxiter

        from sem_jax.parallel.sharding import constrain

        def residual(T, u, v):
            T, u, v = constrain(T), constrain(u), constrain(v)
            r = Pe * ops.apply_convection(grid, u, v, T) \
                + ops.apply_stiffness(grid, T)
            return constrain(jnp.where(mask, T - dirichlet, r))

        md = grid.mass_diag  # host constant (see mask note above)

        def dres(dT, u, v, jdu, jdv, du, dv, sigma):
            """Tangent residual; jdu/jdv are the (diagonal) velocity
            Jacobians; ``sigma`` is the pseudo-transient mass shift σ of the
            T-block (Jacobian of implicit Euler with Δt = Pe/σ — the GLL
            mass is diagonal; 0 = steady)."""
            dT = constrain(dT)
            r = Pe * ops.apply_convection(grid, u, v, dT) \
                + ops.apply_stiffness(grid, dT)
            r = r + jdu * du + jdv * dv + sigma * md.astype(dT.dtype) * dT
            return constrain(jnp.where(mask, dT, r))

        def jac_diags(T):
            return (Pe * ops.conv_diag_x(grid, T),
                    Pe * ops.conv_diag_y(grid, T))

        eps = float(np.finfo(np.dtype(self._dtype)).eps)

        def _make_mv(u, v, xdtype, sigma):
            ul = u.astype(xdtype)
            vl = v.astype(xdtype)
            pe = jnp.asarray(Pe, xdtype)
            mdx = md.astype(xdtype)

            def mv(dT):
                r = apply_system_best(grid, ul, vl, dT, pe) + sigma * mdx * dT
                return jnp.where(mask, dT, r)

            return mv

        def update_f64(drhs, u, v, dT0, mtol_s, sigma):
            # convergence floor: absolute RMS tolerance or mtol relative to
            # the RHS scale (absolute targets below roundoff are unreachable);
            # mtol_s is a traced scalar so per-call overrides (e.g. loose
            # preconditioner solves in the MDA) reuse the compiled program
            atol_eff = jnp.maximum(mtol_s * np.sqrt(self.N),
                                   jnp.maximum(mtol_s, 50 * eps)
                                   * jnp.linalg.norm(drhs))
            mv64 = _make_mv(u, v, drhs.dtype, sigma)
            return gmres(mv64, drhs, x0=dT0, atol=atol_eff, restart=restart,
                         maxiter=maxiter,
                         precon=lambda r: fdm(r, sigma=sigma),
                         return_hist="LGMRES_iter" in self._iprint)

        # separately-jitted pieces of the host-orchestrated mixed-precision
        # refinement (bounded dispatches — see krylov.refined_gmres_host)
        lp = jnp.float32

        def cd_resid(x, b, u, v, sigma):
            return b - _make_mv(u, v, self._dtype, sigma)(x)

        want_hist = "LGMRES_iter" in self._iprint

        def cd_gmres32(rp32, x032, atol32, ul32, vl32, sigma32):
            mv32 = _make_mv(ul32, vl32, lp, sigma32)
            return gmres(lambda q: fdm(mv32(q), sigma=sigma32), rp32,
                         x0=x032, atol=atol32,
                         restart=restart, maxiter=2 * restart + 5,
                         return_hist=want_hist)

        # large closure constants hoisted to runtime arguments (see
        # sem_jax.utils.hoist: executable size / per-process load time)
        from sem_jax.utils.hoist import jit_hoisted
        tag = f"@{self.grid.tag}"
        self._residual_jit = jit_hoisted(residual, "cd.residual" + tag)
        self._dres_jit = jit_hoisted(dres, "cd.dres" + tag)
        self._jac_diags_jit = jit_hoisted(jac_diags, "cd.jac_diags" + tag)
        self._update_jit = jit_hoisted(update_f64, "cd.update" + tag)
        self._cres_jit = jit_hoisted(cd_resid, "cd.cres" + tag)
        self._pc32_jit = jit_hoisted(lambda r32, s32: fdm(r32, sigma=s32),
                                     "cd.pc32" + tag)

        def cd_pcprep(r, scale32, sigma32):
            # fused per-refinement-pass prep (downcast + pc + norm + chunk
            # tolerance in ONE dispatch — krylov.refined_gmres_host pc_prep)
            rp = fdm(r.astype(lp), sigma=sigma32)
            rpn = jnp.linalg.norm(rp)
            return rp, scale32 * rpn, rpn

        def cd_pass(x, xin, b, u, v, sigma64, sigma32):
            # FULLY-FUSED refinement pass: accumulate + f64 true residual +
            # norm + downcast + FDM pc + norm in ONE program (see
            # krylov.refined_gmres_host pass_fused — each un-fused op in
            # that loop is a blocking accelerator round trip)
            x = x + xin.astype(x.dtype)
            r = cd_resid(x, b, u, v, sigma64)
            rp = fdm(r.astype(lp), sigma=sigma32)
            return x, jnp.linalg.norm(r), rp, jnp.linalg.norm(rp)

        self._pcprep_jit = jit_hoisted(cd_pcprep, "cd.pcprep" + tag)
        self._pass_jit = jit_hoisted(cd_pass, "cd.pass" + tag)
        self._gmres32_jit = jit_hoisted(cd_gmres32, "cd.gmres32" + tag)
        # concurrent first-call prefetch of previously-recorded programs
        # (time-to-first-solution; no-op without a manifest/accelerator)
        from sem_jax.utils import prefetch
        prefetch.warm_async()

    # ---------------- seven-method discipline protocol ---------------- #
    def _get_residuals(self, T, u, v):
        """Residual of the masked system (parity: reference :73-92)."""
        self._u = place(u, self._dtype)
        self._v = place(v, self._dtype)
        return self._residual_jit(place(T, self._dtype), self._u, self._v)

    def _calc_jacobians(self, T, sigma: float = 0.0):
        """Precompute ∂res/∂(u,v) diagonals (parity: reference :94-102).

        :param sigma: pseudo-transient mass shift σ of the T-block; the
            stored value steers ``_get_dresiduals``/``_get_update`` until the
            next call (steady solves use the default 0)
        """
        jdu, jdv = self._jac_diags_jit(place(T, self._dtype))
        self._jac_diag_u = jdu
        self._jac_diag_v = jdv
        self._sigma = float(sigma)

    def _get_dresiduals(self, dT, du=None, dv=None):
        """Tangent residual with the stored linearization (reference :104-121)."""
        z = jnp.zeros(self.N, self._dtype)
        jdu = self._jac_diag_u if du is not None else z
        jdv = self._jac_diag_v if dv is not None else z
        du = z if du is None else place(du, self._dtype)
        dv = z if dv is None else place(dv, self._dtype)
        return self._dres_jit(place(dT, self._dtype), self._u, self._v,
                              jdu, jdv, du, dv, self._sigma64())

    def _get_update(self, dres, dT0=None, mtol=None, best_effort=False):
        """Solve the tangent system for dT (reference :123-156).

        GMRES with FDM right preconditioning; raises RuntimeError on
        non-convergence like the reference (:149-150).

        :param mtol: optional per-call RMS tolerance override (used by the
            MDA to run preconditioner applications loosely)
        :param best_effort: never raise — return the best-achievable
            iterate (preconditioner applications inside a flexible outer
            Krylov loop)
        """
        dT0 = (jnp.zeros(self.N, self._dtype) if dT0 is None
               else place(dT0, self._dtype))
        drhs = place(dres, self._dtype)
        mtol_f = float(self._mtol if mtol is None else mtol)
        if self._mixed_precision:
            dT, info = self._update_mixed(drhs, dT0, mtol_f)
        else:
            out = self._update_jit(drhs, self._u, self._v, dT0,
                                   jnp.asarray(mtol_f, self._dtype),
                                   self._sigma64())
            if len(out) == 3:   # 'LGMRES_iter': per-iteration residual lines
                dT, info, hist = out
                self._print_hist(hist, int(info.iterations))
            else:
                dT, info = out
        self.last_info = info
        self.iter_count_solve += 1
        # roundoff-stalled solves return the best-achievable iterate and are
        # accepted (outer convergence checks are authoritative); genuine
        # non-convergence (maxiter while progressing) raises like the
        # reference (:149-150)
        if (not bool(info.converged) and not bool(info.stalled)
                and not best_effort):
            raise RuntimeError(
                f"ConvectionDiffusion GMRES: failed to converge in "
                f"{int(info.iterations)} iterations (resnorm "
                f"{float(info.resnorm):.3e})")
        if "LGMRES_suc" in self._iprint:
            print(f"ConvectionDiffusion GMRES: converged in "
                  f"{int(info.iterations)} iterations with resnorm "
                  f"{float(info.resnorm):.3e}")
        return dT

    def _print_hist(self, hist, n, offset=0):
        """Per-iteration residual lines (reference 'LGMRES_iter',
        ConvectionDiffusion_Solver.py:139-144) — recorded on device during
        the solve, printed after the dispatch."""
        h = np.asarray(hist)
        for j in range(n):
            print(f"ConvectionDiffusion LGMRES: {offset + j + 1}\t{h[j]}")

    def _sigma64(self):
        """Cached f64 device scalar of the current mass shift (the f64-only
        tangent/update paths need just this — not the f32 wind casts)."""
        cached = self._sigma64_cache
        if cached is None or cached[0] != self._sigma:
            cached = (self._sigma, jnp.asarray(self._sigma, self._dtype))
            self._sigma64_cache = cached
        return cached[1]

    def _lin32(self):
        """f32/f64 casts of the current wind + mass shift, computed ONCE
        per linearization instead of per solve — each astype/asarray is a
        dispatch.  Invalidation
        is by object identity of the stored wind fields."""
        src = (self._u, self._v, self._sigma)
        cached = self._lin32_cache
        if (cached is None or cached[0][0] is not src[0]
                or cached[0][1] is not src[1] or cached[0][2] != src[2]):
            lp = jnp.float32
            val = (src[0].astype(lp), src[1].astype(lp),
                   jnp.asarray(src[2], lp), self._sigma64())
            self._lin32_cache = (src, val)
            cached = self._lin32_cache
        return cached[1]

    def _update_mixed(self, drhs, dT0, mtol):
        """Host-level f64 refinement around chunked f32 GMRES (bounded device
        dispatches — see :func:`sem_jax.krylov.refined_gmres_host`)."""
        eps = float(np.finfo(np.dtype(self._dtype)).eps)
        # ‖b‖ rides the refinement loop's first combined read (atol_fn) —
        # no up-front blocking readback
        atol_fn = (lambda bn: max(mtol * np.sqrt(self.N),
                                  max(mtol, 50 * eps) * bn))
        ul32, vl32, sigma32, sigma64 = self._lin32()
        count = [0]

        def chunk(rp, xin, a):
            out = self._gmres32_jit(rp, xin, a, ul32, vl32, sigma32)
            if len(out) == 3:   # 'LGMRES_iter' (f32 inner-loop residuals)
                x, info, hist = out
                self._print_hist(hist, int(info.iterations), count[0])
                count[0] += int(info.iterations)
                return x, info
            return out

        return refined_gmres_host(
            cres=None, pc_lp=None,
            pass_fused=lambda x, xin: self._pass_jit(
                x, xin, drhs, self._u, self._v, sigma64, sigma32),
            gmres_chunk=chunk,
            b=drhs, x0=dT0, atol_fn=atol_fn, maxiter=self._maxiter)

    def _get_solution(self, u, v, T0=None, mtol=None):
        """Single Newton step — the problem is linear in T (reference :158-170).

        :param mtol: optional RMS tolerance override for this solve
        """
        self._sigma = 0.0  # nonlinear solves are steady (a stale
        #                    pseudo-transient shift must not leak in)
        T = (jnp.zeros(self.N, self._dtype) if T0 is None
             else place(T0, self._dtype))
        res = self._get_residuals(T, u, v)
        dT = self._get_update(-res, mtol=mtol)
        return T + dT

    def _get_vector(self, f_func: typing.Callable) -> np.ndarray:
        """Evaluate a callable at the global nodes (reference :172-178)."""
        return np.asarray(f_func(self.points[0], self.points[1]), dtype=float)

    def _get_interpol(self, f, points_plot) -> np.ndarray:
        """Evaluate the SEM interpolant at plot points (reference :180-188)."""
        return PointEvaluator(self.grid, points_plot)(place(f, self._dtype))

    def run(self, u_func, v_func, points_plot) -> np.ndarray:
        """End-to-end solve: velocities → T at plot points (reference :190-203)."""
        u = jnp.asarray(self._get_vector(u_func), self._dtype)
        v = jnp.asarray(self._get_vector(v_func), self._dtype)
        T = self._get_solution(u, v)
        return self._get_interpol(T, points_plot)
