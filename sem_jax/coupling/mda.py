"""MDA engine: nonlinear block-Gauss-Seidel / Newton-block-Jacobi /
block-Jacobi-preconditioned Newton-Krylov for the Boussinesq coupling.

Re-implements, as ~300 lines of explicit algorithm, the three coupling modes
the reference drives through (locally patched) OpenMDAO solvers
(reference Boussinesq_SequentialCoupler.py:75-93; the vendored-patch
dependency is documented in SURVEY.md §2.3 — these algorithms are owned
outright here):

* ``'GS'``  — nonlinear block Gauss-Seidel with post-sweep ``apply_nonlinear``
  residual evaluation (the reference's ``use_apply_nonlinear=True``),
  maxiter 1000;
* ``'NJ'``  — Newton-block-Jacobi: Newton whose linear solve is ONE linear
  block-Jacobi sweep (each discipline inverts its own Jacobian block,
  cross-blocks dropped), safeguarded by an Armijo-Goldstein backtracking
  line search (reference AGi/AGr/AGc parameters);
* ``'JNK'`` — block-Jacobi-preconditioned Newton-Krylov: Newton with the
  coupled linear system solved by *flexible* GMRES, preconditioned by one
  block-Jacobi sweep (each application = the disciplines' own accurate
  linear solves, like the reference's ``LinearBlockJac`` preconditioner of
  ``PETScKrylov``/``ScipyKrylov``);
* ``'PTC'`` — pseudo-transient continuation (capability beyond the
  reference): SER-ramped implicit-Euler/damped-Newton steps through the
  same JNK machinery with mass-shifted Jacobians and spectrally-matched
  shifted preconditioners — the globally-convergent path to high-Rayleigh
  steady states where from-zero JNK diverges (see :meth:`_solve_ptc`).

Both Newton modes start with one Gauss-Seidel sweep, mirroring OpenMDAO's
``NewtonSolver(solve_subsystems=True, max_sub_solves=0)`` which runs the
subsystem solves on iteration 0 only (reference :80-82).

The coupled Krylov loop runs at the host level in NumPy — each of its
callbacks (residuals, Jacobian-vector products, block solves) is a jitted
on-device operation; FGMRES is used (instead of the reference's left-
preconditioned GMRES) because the block-Jacobi preconditioner contains inner
Krylov solves and flexible GMRES is robust to such slightly-nonlinear
preconditioning.

Tolerances follow the reference's RMS convention: absolute tolerance =
mtol·√DOF with DOF = 3·N_ns + N_cd (reference :61-63).
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from sem_jax.coupling.components import (ConvectionDiffusionComponent,
                                         NavierStokesComponent)

__all__ = ["BoussinesqMDA", "MDAStats", "CoupledState"]


def _env_int(name, default):
    """Integer env-var override of a default.

    The dispatch-size thresholds below choose which solver path runs; their
    defaults were chosen on the earlier accelerator and are not measured on
    the H100 yet.  Documented in README "Environment knobs".
    """
    v = os.environ.get(name, "")
    return default if v == "" else int(float(v))


#: largest coupled DOF for which JNK auto-selects fused on-device Krylov
#: windows (``SEM_JAX_DEVICE_KRYLOV_MAX_DOF``); beyond it the
#: host-orchestrated FGMRES path runs, whose dispatches are individually
#: bounded.  Default 1e6 (chosen on the earlier accelerator).
DEVICE_KRYLOV_MAX_DOF = "SEM_JAX_DEVICE_KRYLOV_MAX_DOF"
#: largest coupled DOF for which PTC keeps the device-fused window path
#: (``SEM_JAX_PTC_DEVICE_MAX_DOF``); PTC's convection-dominated inner
#: solves stretch a fused window far past what JNK's do, hence the lower
#: default 150k (chosen on the earlier accelerator).
PTC_DEVICE_MAX_DOF = "SEM_JAX_PTC_DEVICE_MAX_DOF"
#: outer iterations bundled into one fused device window
#: (``SEM_JAX_FUSED_WINDOW``, default 10): each contains a full CD + NS
#: preconditioner solve (nested Krylov included), so the window bounds
#: the runtime of a single dispatch.
FUSED_WINDOW = "SEM_JAX_FUSED_WINDOW"


@dataclasses.dataclass
class MDAStats:
    """Iteration counters, mirroring the reference study's de-facto benchmark
    ``[cd_linear_solves, ns_linear_solves, nonlinear_iters]``
    (reference study/Boussinesq_run.py:114-128)."""

    cd_solves: int = 0
    ns_solves: int = 0
    nonlinear_iters: int = 0
    gmres_iters: int = 0

    def as_list(self):
        return [self.cd_solves, self.ns_solves, self.nonlinear_iters]


@dataclasses.dataclass
class CoupledState:
    T: jnp.ndarray   # CD temperature   (N_cd,)
    u: jnp.ndarray   # NS x-velocity    (N_ns,)
    v: jnp.ndarray   # NS y-velocity    (N_ns,)
    p: jnp.ndarray   # NS pressure      (N_ns,)

    def copy(self):
        return CoupledState(self.T, self.u, self.v, self.p)


def _fg_row(buf, vec, k):
    """Write ``vec`` into row ``k`` of the padded device basis ``buf``.
    ``k`` is a traced operand, so every iteration reuses ONE cached
    executable (``buf.at[k]`` with a Python int would bake the index in and
    compile a distinct tiny program per row)."""
    return lax.dynamic_update_slice(buf, vec[None, :], (k, jnp.int32(0)))


def _fg_read_row(buf, k):
    """Read row ``k`` of the padded device basis (traced index — one
    cached executable for all rows)."""
    return lax.dynamic_slice(buf, (k, jnp.int32(0)), (1, buf.shape[1]))[0]


def _fg_cgs2(V, w, k):
    """One fixed-shape CGS2 step against the padded basis ``V`` (m+1, n).

    Rows above ``k`` are zero, so they contribute nothing to the projection
    and no masking is needed.  Returns the basis with the normalized new
    vector written to row ``k+1`` and the ``m+2`` scalars
    ``[h_0..h_m, ‖w‖]`` (projection entries past ``k`` are zero; the last
    entry is the subdiagonal H[k+1,k]) — the only thing the host reads
    back.
    """
    hi = lax.Precision.HIGHEST
    h1 = jnp.matmul(V, w, precision=hi)
    w = w - jnp.matmul(V.T, h1, precision=hi)
    h2 = jnp.matmul(V, w, precision=hi)
    w = w - jnp.matmul(V.T, h2, precision=hi)
    nw = jnp.linalg.norm(w)
    vk1 = jnp.where(nw > 1e-300, w / jnp.maximum(nw, 1e-300), 0.0)
    V = lax.dynamic_update_slice(V, vk1[None, :], (k + 1, jnp.int32(0)))
    return V, jnp.concatenate([h1 + h2, nw[None]])


def _fg_update(x, Z, y):
    """x + Zᵀy with ``y`` zero-padded to the full window (dead rows × 0).
    The product runs in the (f32) basis dtype and accumulates into the
    (f64) iterate dtype."""
    return x + jnp.matmul(Z.T, y,
                          precision=lax.Precision.HIGHEST).astype(x.dtype)


# hoisted (not plain jax.jit) so these per-iteration glue programs join the
# prefetch manifest (each first call otherwise compiles mid-solve)
from sem_jax.utils.hoist import jit_hoisted as _jit_hoisted  # noqa: E402

_fg_row = _jit_hoisted(_fg_row, "mda.fg_row")
_fg_read_row = _jit_hoisted(_fg_read_row, "mda.fg_read_row")
_fg_cgs2 = _jit_hoisted(_fg_cgs2, "mda.fg_cgs2")
_fg_update = _jit_hoisted(_fg_update, "mda.fg_update")


def _forecast_doomed(hist, atol, remaining, slack=1.5):
    """Whether a Krylov solve is hopeless within its remaining budget.

    Projects the iterations still needed from the most OPTIMISTIC recent
    contraction rate — the best of the trailing 20- and 40-iteration
    windows of the estimated-residual history ``hist`` — and reports
    doomed when even that exceeds ``slack``× the ``remaining`` iterations.
    Pure host arithmetic; unit-pinned in tests/test_coupling.py
    (test_fgmres_forecast_exit).
    """
    res = hist[-1]
    if len(hist) < 60 or res <= 0:
        return False
    rho = max(min((res / hist[-21]) ** (1 / 20.0),
                  (res / hist[-41]) ** (1 / 40.0)), 1e-12)
    if rho >= 1.0:
        return True
    need = np.log(res / atol) / -np.log(rho)
    return need > slack * remaining


def _fgmres(matvec, precon, b, atol, restart, maxiter, callback=None,
            basis_dtype=jnp.float32, fused=None, forecast=False):
    """Host-orchestrated flexible GMRES with DEVICE-resident vectors.

    Control flow, the small Hessenberg recurrence, and the Givens rotations
    run on the host (NumPy scalars); every n-sized object — basis ``V``,
    flexible basis ``Z``, iterate, residual — stays on device in
    FIXED-SHAPE padded buffers, and the callbacks receive/return device
    arrays.  Per iteration the host reads back only the new Hessenberg
    scalars.  Two pathologies shaped this (direct p16 JNK solve):

    * an all-NumPy variant moves the full coupled vector (~34 MB at p16)
      between host and device twice per callback;
    * a device variant that GREW the basis by concatenation presented new
      shapes to every op-by-op dispatch each iteration — a fresh compile
      per outer iteration.  Padded buffers + traced row indices keep it to
      three cached executables total.

    Orthogonalization is classical Gram-Schmidt with one unconditional
    second sweep (CGS2): two (m+1, n) device matmuls per sweep, cheap at
    outer-window sizes (m ≈ 20), and the outer basis must stay orthogonal
    through the inexact/varying inner block solves.

    The padded V/Z buffers and the CGS2 products default to FLOAT32 (half
    the basis traffic of f64; on the earlier accelerator, whose f64 was
    emulated, the f64 CGS2 step was the single largest program cost of a
    direct p16 JNK solve — not re-measured on the H100).  f32 is safe for the hot
    JNK/PTC loops for the same reason the discipline chunks are: every
    window restarts from the TRUE f64 residual ``b - A x`` (computed
    outside the basis), so basis roundoff bounds the per-window reduction
    (~1e-7 relative of the window's start), and the inexact-Newton forcing
    tolerances (≥1e-4 relative) sit far above it; the update ``x + Zᵀy``
    accumulates into the f64 iterate.  Callers needing reductions at/below
    the f32 refinement floor in one solve (the implicit adjoint, tested to
    1e-6 RAW-relative on convection-dominated states) pass
    ``basis_dtype=b.dtype``.

    :param fused: optional ``(start, step, precon_split)`` triple (see
        :meth:`BoussinesqMDA._fg_fused`) replacing the per-iteration glue
        with ONE jitted program + ONE scalar readback per iteration:

        * ``start(x, b) -> (V, Z, H, cs, sn, g, *v_pieces, beta_dev)`` —
          window residual, normalization, buffer allocation and the
          ``g[0]=β`` seed in one dispatch; ``v_pieces`` feed the split
          preconditioner;
        * ``step(V, Z, H, cs, sn, g, k, *z_pieces) ->
          (V, Z, H, cs, sn, g, *v_pieces, res_dev)`` — matvec, flexible-
          basis write, CGS2 and the on-device Givens/Hessenberg recurrence
          (the un-fused loop paid ~6 dispatches + an (m+2)-scalar readback
          per iteration);
        * ``precon_split(*v_pieces) -> z_pieces`` — the block
          preconditioner on pre-split fields (its discipline solves remain
          host-orchestrated; the pack/unpack dispatches disappear).

        ``matvec``/``precon``/``basis_dtype`` are ignored when given.  The
        rotated Hessenberg ``H`` and ``g`` live on device; the window-end
        triangular solve reads them back once (a few hundred bytes).
    :param forecast: enable the convergence-forecast exit: once ≥60
        iterations are in, project the iterations still needed from the
        most optimistic recent contraction rate (best of the trailing
        20/40-iteration windows); when even that exceeds 1.5× the remaining
        budget, finish the window and return the partial iterate with
        ``ok=False`` instead of grinding to ``maxiter``.  Motivated by the
        Ra=1e8 p16 PTC probes of an uncrackable Δt band: the coupled solve
        converged ~0.06%/iteration — real progress, so the <2%-per-40
        plateau tests never fired — and burned the full 240-iteration
        effort cap on solves that could never reach ``atol_k``.  PTC
        treats the partial step as a linear failure, keeps the (useful)
        partial update, and cuts Δt — exactly what the grind would have
        concluded an hour later.  Off for plain JNK solves: their
        staircase convergence may legitimately spend >60 iterations flat
        before dropping (krylov.py floor-detection lesson), and their
        budgets are small anyway.
    """
    lp = basis_dtype
    if fused is not None:
        f_start, f_step, f_precon = fused
    b = jnp.asarray(b)
    x = jnp.zeros_like(b)
    it = 0
    normb = float(jnp.linalg.norm(b))
    if normb <= atol:
        return x, 0, True
    m = restart
    beta_prev = None    # true residual at the previous restart
    stalled_in = False  # last window ended on the in-window plateau test
    hist = []           # estimated residual per iteration (forecast exit)
    doomed = False      # forecast exit tripped mid-window
    while it < maxiter:
        if fused is not None:
            out = f_start(x, b)
            V, Z, Hd, csd, snd, gd = out[:6]
            if V.shape[0] != m + 1:
                raise ValueError(
                    f"fused FGMRES programs were built for restart="
                    f"{V.shape[0] - 1}, called with restart={m} (a window "
                    f"mismatch would silently clamp the padded-buffer "
                    f"updates)")
            vp = out[6:-1]
            beta = float(out[-1])   # window's ONE blocking read
        else:
            r = b - matvec(x)
            beta = float(jnp.linalg.norm(r))
        if not np.isfinite(beta):
            return x, it, False     # inner solve diverged/NaN — fail fast
        if beta <= atol:
            return x, it, True
        # cross-restart stall (mirrors krylov.gmres semantics): a window
        # whose estimated residual plateaued (<2% progress) AND whose
        # update left the true residual essentially unchanged marks the
        # preconditioned system uncrackable at this conditioning — return
        # the best iterate instead of grinding the remaining budget
        # (callers treat ok=False + partial progress as a linear failure:
        # PTC cuts Δt, JNK raises).  Measured trigger: the Ra=1e7 p16 PTC
        # steps sat >100 iterations at a flat 0.08 residual.
        if stalled_in and beta_prev is not None and beta > 0.98 * beta_prev:
            return x, it, False
        beta_prev = beta
        stalled_in = False
        if fused is None:
            V = jnp.zeros((m + 1, b.shape[0]), lp)
            Z = jnp.zeros((m, b.shape[0]), lp)
            V = _fg_row(V, (r / beta).astype(lp), jnp.int32(0))
            H = np.zeros((m + 1, m))
            g = np.zeros(m + 1)
            g[0] = beta
            cs = np.zeros(m)
            sn = np.zeros(m)
        resw = np.zeros(m)  # per-iteration residual estimates (plateau test)
        k_used = 0
        res = beta
        for k in range(m):
            kj = jnp.int32(k)
            if fused is not None:
                zs = f_precon(*vp)
                out = f_step(V, Z, Hd, csd, snd, gd, kj, *zs)
                V, Z, Hd, csd, snd, gd = out[:6]
                vp = out[6:-1]
                res = float(out[-1])    # the iteration's ONE blocking read
            else:
                z = precon(_fg_read_row(V, kj).astype(b.dtype))
                w = matvec(z)
                Z = _fg_row(Z, z.astype(lp), kj)
                V, hfull = _fg_cgs2(V, w.astype(lp), kj)
                hfull_np = np.asarray(hfull)        # m+2 scalars to host
                # projections h_0..h_k, then the subdiagonal ‖w‖ (LAST
                # entry — hfull_np[k+1] is the projection onto a still-zero
                # basis row)
                hcol = np.concatenate([hfull_np[:k + 1], hfull_np[-1:]])
                H[:k + 2, k] = hcol
                for j in range(k):
                    t1 = cs[j] * H[j, k] + sn[j] * H[j + 1, k]
                    t2 = -sn[j] * H[j, k] + cs[j] * H[j + 1, k]
                    H[j, k], H[j + 1, k] = t1, t2
                d = np.hypot(H[k, k], H[k + 1, k])
                cs[k], sn[k] = ((H[k, k] / d, H[k + 1, k] / d) if d > 0
                                else (1, 0))
                H[k, k] = d
                H[k + 1, k] = 0.0
                g[k + 1] = -sn[k] * g[k]
                g[k] = cs[k] * g[k]
                res = abs(g[k + 1])
            it += 1
            k_used = k + 1
            if callback is not None:
                callback(it, res)
            hist.append(res)
            if res <= atol or it >= maxiter:
                break
            # in-window plateau (<2% estimated-residual progress over the
            # last 40 iterations — the krylov.gmres criterion; only
            # reachable when the window exceeds 40): restart early
            if k + 1 >= 40 and res > 0.98 * resw[k - 39]:
                stalled_in = True
                break
            resw[k] = res
            # convergence-forecast exit (docstring): even the best recent
            # contraction rate cannot reach atol within 1.5× the remaining
            # budget — finish the window and return the partial iterate
            if forecast and _forecast_doomed(hist, atol, maxiter - it):
                doomed = True
                break
        # window ended without reaching atol and its estimate moved <2%:
        # flag it — the true-residual test above decides the stall
        if res > atol and res > 0.98 * beta:
            stalled_in = True
        if fused is not None:
            # the rotated H and g live on device: ONE small readback per
            # window for the breakdown guard + triangular solve
            H, g = jax.device_get((Hd, gd))
        # Arnoldi breakdown guard: a stagnated inner solve can return
        # (near-)dependent directions, zeroing a diagonal of the rotated H
        # (observed with a degraded low-precision inner chunk); solve only
        # the leading nonsingular block instead of raising LinAlgError,
        # and report a stall when no usable direction remains.
        diag = np.abs(np.diag(H[:k_used, :k_used]))
        tol_d = max(1e-14 * diag.max(initial=0.0), 1e-300)
        bad = np.nonzero(diag <= tol_d)[0]
        if bad.size:
            k_used = int(bad[0])
            if k_used == 0:
                return x, it, False
        y = np.linalg.solve(np.triu(H[:k_used, :k_used]), g[:k_used])
        ypad = np.zeros(m)
        ypad[:k_used] = y
        x = _fg_update(x, Z, jnp.asarray(ypad, Z.dtype))
        if abs(g[k_used]) <= atol:
            return x, it, True
        if doomed:
            return x, it, False
    return x, it, False


class BoussinesqMDA:
    """Coupled CD↔NS (Boussinesq) multidisciplinary solver.

    :param cd_comp / ns_comp: the two discipline components
    :param mode: 'GS' | 'NJ' | 'JNK'
    :param mtol_nonlin: RMS tolerance of the coupled nonlinear residual
    :param AGi/AGr/AGc: Armijo-Goldstein line-search max iterations /
        contraction factor / slope factor (NJ mode; reference :14)
    :param mtol_gmres: RMS tolerance of the coupled Krylov solve (JNK)
    :param restart: coupled GMRES restart (JNK)
    :param maxiter: nonlinear iteration cap (reference: 1000 for GS/NJ,
        100 for JNK)
    :param mtol_subsolve: RMS tolerance of the Newton modes' iteration-0
        Gauss-Seidel subsystem sweep (an initializer only — the coupled
        Newton converges the true residual afterwards; the reference runs it
        at the full internal tolerance).  None = solver internal tolerances.
        GS mode always uses the internal tolerances (its convergence is
        limited by subsolve accuracy).
    :param mtol_precon: RMS tolerance of the block-Jacobi *preconditioner*
        solves inside JNK's flexible GMRES.  The reference runs these at the
        full internal tolerance (mtol_internal=1e-13) because OpenMDAO's
        LinearBlockJac reuses the components' solve_linear verbatim — but a
        preconditioner only needs a rough inverse, and FGMRES tolerates the
        variation; 1e-4 cuts the dominant cost of a JNK iteration by ~5×.
        Pass None to reproduce the reference's behavior exactly.
    :param iprint: True ⇒ per-iteration residual lines (OpenMDAO iprint=2
        analog)
    :param forcing: inexact-Newton forcing factor η on the coupled JNK
        GMRES: each Newton step's linear system is solved only to absolute
        tolerance max(mtol_gmres·√DOF, η·‖F‖) (Dembo-Eisenstat-Steihaug) —
        early Newton steps get cheap loose solves, the final steps tighten
        automatically; the Newton convergence test is unchanged.  None
        reproduces the reference's fixed-tolerance behavior
        (om.ScipyKrylov/PETScKrylov with a fixed atol)
    :param device_krylov: run the coupled JNK flexible GMRES **on device**
        (one XLA dispatch per restart window, inner block-Jacobi discipline
        solves included) instead of the host-orchestrated loop whose every
        callback is a host-device round trip.  ``None`` (default)
        auto-enables below ~10⁶ coupled DOF, where the fused program
        compiles quickly and a window stays short; the host path remains
        for larger problems and as the structural reference.  Replaces the PETSc-side distributed GMRES of the
        reference (Boussinesq_ParallelCoupler.py:91-93) with a jitted
        collective-ready loop.
    """

    def __init__(self, cd_comp: ConvectionDiffusionComponent,
                 ns_comp: NavierStokesComponent, mode: str = "JNK",
                 mtol_nonlin: float = 1e-9,
                 AGi: int = 8, AGr: float = 0.8, AGc: float = 0.2,
                 mtol_gmres: float = 1e-10, restart: int = 20,
                 maxiter: int = None, gmres_maxiter: int = 5000,
                 mtol_precon: float = 1e-4, mtol_subsolve: float = 1e-6,
                 iprint: bool = True, device_krylov: bool = None,
                 forcing: float = 1e-3,
                 ptc_dt0: float = 0.1, ptc_growth: float = 3.0,
                 ptc_dt_max: float = 1e12, ptc_forcing: float = 1e-2,
                 precon: str = None, checkpoint_path: str = None,
                 checkpoint_every: int = 5, checkpoint_config: dict = None,
                 time_budget_s: float = None, time_deadline: float = None):
        if mode not in ("GS", "NJ", "JNK", "PTC"):
            raise ValueError("Unknown method")  # parity: reference :93
        if precon is None:
            # JNK keeps the reference's LinearBlockJac structure ('bj');
            # PTC (beyond-reference) defaults to the strictly stronger block
            # Gauss-Seidel ('bgs'): the CD solve feeds the buoyancy
            # correction into the NS block's RHS, capturing the T→NS
            # coupling that dominates the coupled Jacobian at high Ra —
            # without it, restarted GMRES stagnates once the
            # pseudo-transient shift no longer dominates (observed: a
            # ~1e-6 coupled-residual floor at Ra=1e5 P=8 32×32)
            precon = "bgs" if mode == "PTC" else "bj"
        if precon not in ("bj", "bgs", "bgs2"):
            # 'bgs2' = symmetric block Gauss-Seidel: after the NS block
            # solve, re-solve the CD block against the velocity-advection
            # coupling J_{T,(u,v)}·(du,dv) — the strength rung above 'bgs'
            # for Ra ≳ 1e8 where BOTH off-diagonal blocks are strong
            raise ValueError("precon must be 'bj', 'bgs' or 'bgs2'")
        self.precon_type = precon
        self.cd_comp = cd_comp
        self.ns_comp = ns_comp
        self.mode = mode
        self.N_cd = cd_comp.cd.N
        self.N_ns = ns_comp.ns.N
        self.DOF = 3 * self.N_ns + self.N_cd  # T,u,v,p (reference :61)
        self.atol_nonlin = mtol_nonlin * np.sqrt(self.DOF)
        self.atol_gmres = mtol_gmres * np.sqrt(self.DOF)
        self.AGi, self.AGr, self.AGc = AGi, AGr, AGc
        self.restart = restart
        self.gmres_maxiter = gmres_maxiter
        self.mtol_precon = mtol_precon
        self.mtol_subsolve = mtol_subsolve
        self.maxiter = maxiter if maxiter is not None else (
            100 if mode == "JNK" else 300 if mode == "PTC" else 1000)
        self.forcing = None if forcing is None else float(forcing)
        self.ptc_dt0 = float(ptc_dt0)
        self.ptc_growth = float(ptc_growth)
        self.ptc_dt_max = float(ptc_dt_max)
        self.ptc_forcing = float(ptc_forcing)
        self.iprint = iprint
        if device_krylov is None:
            # fused windows are bounded to FUSED_WINDOW outer iterations;
            # the size cut-off was chosen on the earlier accelerator and is
            # not measured on the H100
            device_krylov = self.DOF <= _env_int(DEVICE_KRYLOV_MAX_DOF,
                                                 1_000_000)
        self.device_krylov = bool(device_krylov)
        self._jnk_cycle_jit = None  # built lazily on first device JNK solve
        self._fg_fused_jits = None  # fused host-FGMRES programs (lazy)
        self._bgs_rhs_jit = None    # fused BGS buoyancy-coupling RHS (lazy)
        self._pc_fused_jit = None   # fused preconditioner application (lazy)
        self._pc_fused_k = None
        # mid-solve checkpointing (utils.checkpoint; SURVEY §5.4): every
        # ``checkpoint_every`` accepted nonlinear iterations/PTC steps the
        # coupled iterate is persisted — long high-Ra runs survive
        # crashes/timeouts and resume via ``solve(load_checkpoint(...)[0])``
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = int(checkpoint_every)
        self.checkpoint_config = checkpoint_config or {}
        # optional wall-clock budget: long high-Ra marches on shared
        # accelerators must terminate GRACEFULLY (checkpoint + raise)
        # instead of being SIGTERM'd mid-dispatch by an external timeout —
        # a mid-dispatch kill can wedge a remote accelerator worker pool.
        # ``time_budget_s`` is per-``solve()``; ``time_deadline`` is an
        # ABSOLUTE ``time.monotonic()`` timestamp shared across solves —
        # continuation drivers (Ra/p ladders build a fresh MDA per level)
        # must use the deadline form or each level restarts the budget
        # and the cumulative wall clock blows through the external bound.
        self.time_budget_s = (None if time_budget_s is None
                              else float(time_budget_s))
        self.time_deadline = (None if time_deadline is None
                              else float(time_deadline))
        self._t_start = None
        self._last_ckpt_iter = None
        self._ptc_dt_current = None  # live PTC Δt, persisted in checkpoints
        self.stats = MDAStats()
        self.prefetch_programs()

    def prefetch_programs(self):
        """Concurrent first-call prefetch of every program a previous
        process recorded for this configuration (sem_jax.utils.prefetch,
        off unless ``SEM_JAX_PREFETCH=1``: first-call compiles or cache
        loads run concurrently instead of mid-solve).  Lazily-built
        program sets (fused host-FGMRES, device JNK windows, flexible
        inner chunks) are constructed eagerly here iff the manifest shows
        they were used last time."""
        from sem_jax.utils import prefetch
        if not prefetch.enabled():
            return
        cd_s, ns_s = self.cd_comp.cd, self.ns_comp.ns
        pair = f"@{cd_s.grid.tag}|{ns_s.grid.tag}"
        try:
            if (self._fg_fused_jits is None
                    and prefetch.known_labels("mda.fg_start" + pair)):
                self._fg_fused_jits = self._build_fg_fused()
            if (self._jnk_cycle_jit is None and self.device_krylov
                    and prefetch.known_labels("mda.cycle" + pair)):
                self._jnk_cycle_jit = self._build_jnk_cycle()
            k = ns_s._velo_inner
            if (self._pc_fused_jit is None and prefetch.known_labels(
                    f"mda.pc_apply{pair}/k{k}")):
                if k > 0 and k not in ns_s._fgmres32_jits:
                    ns_s._fgmres32_jits[k] = ns_s._make_fgmres32(k)
                self._pc_fused_jit = self._build_pc_fused(k)
                self._pc_fused_k = k
            pre = "ns.fgmres32k"
            suf = f"@{ns_s.grid.tag}/{ns_s._linear_solver}"
            for lbl in prefetch.known_labels(pre):
                if lbl.endswith(suf):
                    k = int(lbl[len(pre):lbl.index("@")])
                    if k not in ns_s._fgmres32_jits:
                        ns_s._fgmres32_jits[k] = ns_s._make_fgmres32(k)
        except Exception:
            pass  # prefetch is strictly best-effort
        prefetch.warm_async()

    # ------------------------- plumbing ------------------------- #
    def _pack(self, rT, ru, rv, rp):
        # DEVICE concatenation: the packed coupled vector stays on device —
        # np.concatenate here forced a full device→host readback (~34 MB at
        # p16) per residual/matvec/preconditioner call through the host JNK
        # loop, which dominated large-grid solve wall-clock (see _fgmres)
        return jnp.concatenate([jnp.asarray(rT), jnp.asarray(ru),
                                jnp.asarray(rv), jnp.asarray(rp)])

    def _unpack(self, x):
        Ncd, Nns = self.N_cd, self.N_ns
        return (jnp.asarray(x[:Ncd]), jnp.asarray(x[Ncd:Ncd + Nns]),
                jnp.asarray(x[Ncd + Nns:Ncd + 2 * Nns]),
                jnp.asarray(x[Ncd + 2 * Nns:]))

    def _residuals(self, s: CoupledState) -> jnp.ndarray:
        rT = self.cd_comp.apply_nonlinear(s.T, s.u, s.v)
        ru, rv, rp = self.ns_comp.apply_nonlinear(s.u, s.v, s.p, s.T)
        return self._pack(rT, ru, rv, rp)

    def _linearize(self, s: CoupledState, sigma_cd: float = 0.0,
                   sigma_ns: float = 0.0):
        """Linearize both disciplines; the optional mass shifts
        (σ_T = Pe/Δt on the CD block, σ_v = Re/Δt on the NS velocity blocks)
        turn the coupled Jacobian into the pseudo-transient implicit-Euler
        one (see :meth:`_solve_ptc`)."""
        self.cd_comp.linearize(s.T, sigma=sigma_cd)
        self.ns_comp.linearize(s.u, s.v, sigma=sigma_ns)

    def _apply_linear(self, dx: np.ndarray) -> np.ndarray:
        dT, du, dv, dp = self._unpack(dx)
        drT = self.cd_comp.apply_linear(dT, du, dv)
        dru, drv, drp = self.ns_comp.apply_linear(du, dv, dp, dT)
        return self._pack(drT, dru, drv, drp)

    def _block_jacobi(self, r: np.ndarray, mtol=None,
                      best_effort=False) -> np.ndarray:
        """One linear block-Jacobi sweep: each discipline inverts its own
        Jacobian block (the reference's LinearBlockJac(maxiter=1)).
        With ``precon_type='bgs'``, the block Gauss-Seidel variant: the CD
        solve's dT feeds the buoyancy correction into the NS RHS (the
        dominant T→NS off-diagonal block at high Ra).

        ``best_effort=True`` (preconditioner applications inside the
        flexible outer Krylov loops): block solves return their
        best-achievable iterate instead of escalating to f64 retries or
        raising — a weaker preconditioner costs outer iterations, an f64
        escalation per application costs minutes at p16 (measured at
        Ra=1e7)."""
        rT, ru, rv, rp = self._unpack(r)
        dT, du, dv, dp = self._block_jacobi_split(rT, ru, rv, rp, mtol=mtol,
                                                  best_effort=best_effort)
        return self._pack(dT, du, dv, dp)

    def _block_jacobi_split(self, rT, ru, rv, rp, mtol=None,
                            best_effort=False):
        """:meth:`_block_jacobi` on pre-split fields (no pack/unpack
        dispatches — the fused host-FGMRES keeps the coupled vector in
        pieces across the preconditioner boundary)."""
        dT = self.cd_comp.solve_linear(rT, mtol=mtol,
                                       best_effort=best_effort)
        if self.precon_type in ("bgs", "bgs2"):
            rv = self._bgs_rhs(dT, rv)
        du, dv, dp = self.ns_comp.solve_linear(ru, rv, rp, mtol=mtol,
                                               best_effort=best_effort)
        if self.precon_type == "bgs2":
            # symmetric sweep: re-solve the CD block against the
            # velocity-advection coupling J_{T,(u,v)}·(du,dv) (with dT=0
            # the tangent residual is exactly that off-diagonal block —
            # Dirichlet rows and the σ-shifted diagonal contribute nothing)
            corr = self.cd_comp.apply_linear(jnp.zeros_like(jnp.asarray(rT)),
                                             du, dv)
            dT = self.cd_comp.solve_linear(jnp.asarray(rT) - corr, mtol=mtol,
                                           best_effort=best_effort)
        return dT, du, dv, dp

    def _bgs_rhs(self, dT, rv):
        """Fused block-Gauss-Seidel coupling RHS: forward the buoyancy
        block J_{v,T} = −(Gr/Re)·M (through the cross-mesh transfer) into
        the NS velocity RHS — one program instead of a transfer + mass +
        add dispatch triple."""
        if self._bgs_rhs_jit is None:
            from sem_jax import operators as ops
            from sem_jax.interp import apply_transfer
            from sem_jax.utils.hoist import jit_hoisted
            cd_s, ns_s = self.cd_comp.cd, self.ns_comp.ns

            def f(dT_, rv_):
                dT_ns = apply_transfer(cd_s.grid, ns_s.grid, dT_)
                return rv_ + ns_s._Gr_over_Re * ops.apply_mass(ns_s.grid,
                                                               dT_ns)

            self._bgs_rhs_jit = jit_hoisted(
                f, f"mda.bgs_rhs@{cd_s.grid.tag}|{ns_s.grid.tag}")
        return self._bgs_rhs_jit(dT, rv)

    def _gs_sweep(self, s: CoupledState, mtol=None) -> CoupledState:
        """One nonlinear Gauss-Seidel sweep: CD first, then NS (the
        reference's component ordering, reference :70-71)."""
        T = self.cd_comp.solve_nonlinear(s.u, s.v, T0=s.T, mtol=mtol)
        u, v, p = self.ns_comp.solve_nonlinear(T, u0=s.u, v0=s.v, p0=s.p,
                                               mtol=mtol)
        return CoupledState(T, u, v, p)

    def _print(self, tag, k, norm):
        if self.iprint:
            print(f"Boussinesq {tag}: {k}\t{norm}")

    def _maybe_checkpoint(self, s: CoupledState, k: int, force=False):
        """Persist the coupled iterate every ``checkpoint_every`` accepted
        nonlinear iterations (no-op unless ``checkpoint_path`` is set)."""
        if self.checkpoint_path and (force or k % self.checkpoint_every == 0):
            from sem_jax.utils.checkpoint import save_checkpoint
            self.stats.cd_solves = self.cd_comp.iter_count_solve
            self.stats.ns_solves = self.ns_comp.iter_count_solve
            extras = ({"ptc_dt": float(self._ptc_dt_current)}
                      if self._ptc_dt_current is not None else None)
            save_checkpoint(self.checkpoint_path, s,
                            self.checkpoint_config, self.stats,
                            extras=extras)
            self._last_ckpt_iter = k

    def _check_budget(self, s: CoupledState, k: int, norm: float):
        """Graceful wall-clock-budget exit: checkpoint the iterate and raise
        BEFORE starting another nonlinear iteration.  Checked between
        iterations only — individual dispatches are never interrupted (an
        external SIGTERM mid-dispatch can wedge a remote accelerator)."""
        if self.time_deadline is not None:
            exhausted = time.monotonic() >= self.time_deadline
        elif self.time_budget_s is not None and self._t_start is not None:
            exhausted = (time.monotonic() - self._t_start
                         >= self.time_budget_s)
        else:
            return
        if exhausted:
            self.stats.nonlinear_iters = k
            # skip the forced save if this iterate was JUST checkpointed
            # (four full-field readbacks + a multi-MB write at p16)
            if self._last_ckpt_iter != k:
                self._maybe_checkpoint(s, k, force=True)
            where = (f"; state checkpointed to {self.checkpoint_path}"
                     if self.checkpoint_path else "")
            raise RuntimeError(
                f"Boussinesq {self.mode}: wall-clock budget exhausted "
                f"after {k} iterations at residual {norm:.3e} (target "
                f"{self.atol_nonlin:.3e}){where}")

    # ------------------ on-device coupled FGMRES (JNK) ------------------ #
    def _build_jnk_cycle(self):
        """Jit one flexible-GMRES window over the coupled tangent system.

        The window's every matvec (both disciplines' tangent residuals plus
        the cross-mesh transfers) and every block-Jacobi preconditioner
        application (a full FDM-preconditioned CD solve + a full NS coupled
        saddle solve, nested Krylov loops included) compiles into ONE XLA
        program — the host sees one dispatch per window instead of
        ~4 round-trips per coupled iteration.
        """
        import jax

        from sem_jax.interp import apply_transfer
        from sem_jax.krylov import fgmres

        cd_s = self.cd_comp.cd
        ns_s = self.ns_comp.ns
        Ncd, Nns = self.N_cd, self.N_ns
        # preconditioner tolerances: per-MDA override or solver-internal
        mtol_pre_cd = (cd_s._mtol if self.mtol_precon is None
                       else self.mtol_precon)
        mtol_pre_ns = (ns_s._mtol if self.mtol_precon is None
                       else self.mtol_precon)
        # outer iterations per fused dispatch: each contains a full CD + NS
        # preconditioner solve (nested Krylov included), so the window is
        # kept small to bound the runtime of one dispatch; windows are
        # warm-started so convergence is unaffected
        window = min(self.restart, _env_int(FUSED_WINDOW, 10))

        def unpack(z):
            return (z[:Ncd], z[Ncd:Ncd + Nns],
                    z[Ncd + Nns:Ncd + 2 * Nns], z[Ncd + 2 * Nns:])

        def cycle(x0, b, cd_u, cd_v, cd_jdu, cd_jdv, ns_ul, ns_vl, ns_jac,
                  atol, cd_sigma, ns_sigma):
            # cd_sigma/ns_sigma: pseudo-transient mass shifts (traced
            # scalars, 0 = steady) — the NS tangent needs none (its shift
            # rides in the ns_jac diagonals); the CD tangent and both
            # discipline preconditioner solves take them explicitly
            def mv(dx):
                dT, du, dv, dp = unpack(dx)
                du_cd = apply_transfer(ns_s.grid, cd_s.grid, du)
                dv_cd = apply_transfer(ns_s.grid, cd_s.grid, dv)
                dT_ns = apply_transfer(cd_s.grid, ns_s.grid, dT)
                drT = cd_s._dres_jit(dT, cd_u, cd_v, cd_jdu, cd_jdv,
                                     du_cd, dv_cd, cd_sigma)
                dru, drv, drp = ns_s._dres_jit(du, dv, dp, dT_ns,
                                               ns_ul, ns_vl, ns_jac)
                return jnp.concatenate([drT, dru, drv, drp])

            def pc(r):
                rT, ru, rv, rp = unpack(r)
                dT, _ = cd_s._update_jit(
                    rT, cd_u, cd_v, jnp.zeros(Ncd, rT.dtype),
                    jnp.asarray(mtol_pre_cd, rT.dtype), cd_sigma)
                if self.precon_type in ("bgs", "bgs2"):
                    # block Gauss-Seidel (T first): forward the buoyancy
                    # coupling J_{v,T} = −(Gr/Re)·M into the NS RHS — the
                    # dominant off-diagonal block at high Ra
                    from sem_jax import operators as ops
                    dT_ns = apply_transfer(cd_s.grid, ns_s.grid, dT)
                    rv = rv + ns_s._Gr_over_Re * ops.apply_mass(ns_s.grid,
                                                                dT_ns)
                du, dv, dp = ns_s._update_jit(
                    ru, rv, rp, ns_ul, ns_vl, ns_jac,
                    jnp.zeros(Nns, ru.dtype),
                    jnp.asarray(mtol_pre_ns, ru.dtype), ns_sigma)[:3]
                if self.precon_type == "bgs2":
                    # symmetric sweep: re-solve the CD block against the
                    # velocity-advection coupling (dT=0 tangent = exactly
                    # the J_{T,(u,v)} off-diagonal block)
                    du_cd = apply_transfer(ns_s.grid, cd_s.grid, du)
                    dv_cd = apply_transfer(ns_s.grid, cd_s.grid, dv)
                    corr = cd_s._dres_jit(jnp.zeros_like(rT), cd_u, cd_v,
                                          cd_jdu, cd_jdv, du_cd, dv_cd,
                                          cd_sigma)
                    dT = cd_s._update_jit(
                        rT - corr, cd_u, cd_v, jnp.zeros(Ncd, rT.dtype),
                        jnp.asarray(mtol_pre_cd, rT.dtype), cd_sigma)[0]
                return jnp.concatenate([dT, du, dv, dp])

            return fgmres(mv, b, x0=x0, atol=atol, restart=self.restart,
                          maxiter=window, precon=pc)

        from sem_jax.utils.hoist import jit_hoisted
        # constants out of the executable
        return jit_hoisted(
            cycle, f"mda.cycle@{cd_s.grid.tag}|{ns_s.grid.tag}"
                   f"/w{window}r{self.restart}")

    def _build_fg_fused(self):
        """Jit the fused per-iteration programs of the HOST coupled FGMRES
        (see :func:`_fgmres` ``fused``): the coupled tangent matvec (both
        disciplines + cross-mesh transfers), the flexible-basis write, CGS2
        orthogonalization and the Givens/Hessenberg recurrence all run in
        ONE program per iteration, with the linearization state passed as
        runtime arguments (never baked — Newton/PTC relinearizations reuse
        the same executables).  The un-fused loop paid ~12 glue dispatches
        + an (m+2)-scalar blocking readback per coupled iteration; this
        leaves the block-preconditioner solves
        (host-orchestrated by design) + one step dispatch + one scalar
        read."""
        from sem_jax.interp import apply_transfer
        from sem_jax.krylov import _givens_update
        from sem_jax.utils.hoist import jit_hoisted

        cd_s, ns_s = self.cd_comp.cd, self.ns_comp.ns
        Ncd, Nns = self.N_cd, self.N_ns
        m = self.restart
        lp = jnp.float32
        hi = lax.Precision.HIGHEST
        hdt = jnp.float64  # Hessenberg/Givens recurrence dtype (tiny data)
        eps_tiny = jnp.asarray(1e-300, hdt)

        def split(v):
            return (v[:Ncd], v[Ncd:Ncd + Nns], v[Ncd + Nns:Ncd + 2 * Nns],
                    v[Ncd + 2 * Nns:])

        def mv(zT, zu, zv, zp, cd_u, cd_v, cd_jdu, cd_jdv, ns_ul, ns_vl,
               ns_jac, cd_sigma):
            du_cd = apply_transfer(ns_s.grid, cd_s.grid, zu)
            dv_cd = apply_transfer(ns_s.grid, cd_s.grid, zv)
            dT_ns = apply_transfer(cd_s.grid, ns_s.grid, zT)
            drT = cd_s._dres_jit(zT, cd_u, cd_v, cd_jdu, cd_jdv,
                                 du_cd, dv_cd, cd_sigma)
            dru, drv, drp = ns_s._dres_jit(zu, zv, zp, dT_ns,
                                           ns_ul, ns_vl, ns_jac)
            return jnp.concatenate([drT, dru, drv, drp])

        def start(x, b, *lin):
            r = b - mv(*split(x), *lin)
            beta = jnp.linalg.norm(r)
            # the preconditioner sees the lp-ROUNDED basis row (exactly what
            # the un-fused loop's read_row + astype produced)
            v0 = jnp.where(beta > 0.0,
                           r / jnp.maximum(beta, 1e-300), 0.0).astype(lp)
            V = jnp.zeros((m + 1, b.shape[0]), lp).at[0].set(v0)
            Z = jnp.zeros((m, b.shape[0]), lp)
            H = jnp.zeros((m + 1, m), hdt)
            cs = jnp.ones(m, hdt)   # identity slots (krylov._givens_update)
            sn = jnp.zeros(m, hdt)
            g = jnp.zeros(m + 1, hdt).at[0].set(beta.astype(hdt))
            return (V, Z, H, cs, sn, g) + split(v0.astype(b.dtype)) + (beta,)

        def step(V, Z, H, cs, sn, g, k, zT, zu, zv, zp, *lin):
            w = mv(zT, zu, zv, zp, *lin)
            z = jnp.concatenate([zT, zu, zv, zp])
            Z = lax.dynamic_update_slice(Z, z.astype(lp)[None, :],
                                         (k, jnp.int32(0)))
            # CGS2 against the padded basis (rows above k are zero — they
            # contribute nothing; same algebra as _fg_cgs2)
            wl = w.astype(lp)
            h1 = jnp.matmul(V, wl, precision=hi)
            wl = wl - jnp.matmul(V.T, h1, precision=hi)
            h2 = jnp.matmul(V, wl, precision=hi)
            wl = wl - jnp.matmul(V.T, h2, precision=hi)
            nw = jnp.linalg.norm(wl)
            vk1 = jnp.where(nw > 1e-30, wl / jnp.maximum(nw, 1e-30), 0.0)
            V = lax.dynamic_update_slice(V, vk1[None, :],
                                         (k + 1, jnp.int32(0)))
            # Hessenberg column: projections 0..k (entries past k are
            # exactly zero — projections onto still-zero rows), subdiagonal
            # ‖w‖ at k+1; rotations in f64 on device
            hcol = (h1 + h2).astype(hdt).at[k + 1].set(nw.astype(hdt))
            hrot, cs, sn, g, res = _givens_update(hcol, cs, sn, g, k, m,
                                                  eps_tiny)
            H = lax.dynamic_update_slice(H, hrot[:, None],
                                         (jnp.int32(0), k))
            vnext = vk1.astype(zT.dtype)
            return (V, Z, H, cs, sn, g) + split(vnext) + (res,)

        fgtag = f"@{cd_s.grid.tag}|{ns_s.grid.tag}/r{m}"
        return (jit_hoisted(start, "mda.fg_start" + fgtag),
                jit_hoisted(step, "mda.fg_step" + fgtag))

    def _build_pc_fused(self, k_inner: int):
        """ONE program for the whole block-Jacobi/BGS preconditioner
        application of the host coupled FGMRES: the CD discipline solve,
        the BGS buoyancy-coupling RHS, and the NS discipline solve fuse
        into a single dispatch with ZERO intermediate readbacks.

        The host-orchestrated discipline solves (``solve_linear`` →
        ``krylov.refined_gmres_host``) cost ~6 dispatches + 2 blocking
        scalar readbacks *per discipline per coupled iteration*, each a
        host-device round trip.  For PRECONDITIONER
        applications the adaptive refinement logic (plateau detection,
        learned floors, escalation) is unnecessary — a flexible outer
        FGMRES tolerates any inexact application and a floored f32 iterate
        is a usable preconditioner (the Ra=1e7 lesson) — so this program
        runs the measured-median FIXED policy instead: per discipline, a
        ``lax.scan`` of two (refinement pass → bounded f32 chunk) rounds,
        where a round whose true residual already meets the discipline
        tolerance short-circuits its chunk on device (tolerance set above
        f32 max ⇒ the chunk's while_loop exits at iteration 0).  Update
        solves (Newton/NJ/PTC steps) keep the adaptive host loop and its
        escalation ladder untouched.

        :param k_inner: NS chunk flavor — 0 = plain left-preconditioned
            chunks, k>0 = row-scaled flexible chunks with k inner velocity
            steps (``velo_inner``; the Ra≳1e7 configuration)
        """
        from sem_jax.utils.hoist import jit_hoisted

        cd_s, ns_s = self.cd_comp.cd, self.ns_comp.ns
        Ncd, Nns = self.N_cd, self.N_ns
        lp = jnp.float32
        eps = float(np.finfo(np.float64).eps)
        bgs = self.precon_type in ("bgs", "bgs2")
        bgs2 = self.precon_type == "bgs2"
        RTOL = 1e-5                    # refined_gmres_host inner_rtol
        BIG = jnp.asarray(3e38, lp)    # "skip this chunk" tolerance

        def two_rounds(pass_f, chunk_f, b, n, mtol):
            """Best-effort mixed-precision solve, fixed two-round policy."""
            bn = jnp.linalg.norm(b)
            atol = jnp.maximum(mtol * np.sqrt(n),
                               jnp.maximum(mtol, 50 * eps) * bn)
            zlp = jnp.zeros(b.shape, lp)

            def body(carry, _):
                x, xin, done = carry
                x, rn, rp, rpn = pass_f(x, xin)
                done = done | (rn <= atol)
                atol_lp = jnp.where(done, BIG, RTOL * rpn.astype(lp))
                out = chunk_f(rp, zlp, atol_lp)
                return (x, out[0], done), out[1].iterations

            (x, xin, _), its = lax.scan(
                body, (jnp.zeros_like(b), zlp, jnp.zeros((), bool)),
                None, length=2)
            return x + xin.astype(x.dtype), its.sum()

        def pc_apply(rT, ru, rv, rp,
                     cd_u, cd_v, cd_s64, cd_ul32, cd_vl32, cd_s32,
                     ns_u, ns_v, ns_jac, ns_ul32, ns_vl32, ns_jac32,
                     ns_s32, dinv32, mtol_cd, mtol_ns, *cd_jd):
            # cd_jd = (cd_jdu, cd_jdv) — the CD velocity-advection Jacobian
            # diagonals, passed only for the 'bgs2' symmetric-sweep variant
            dT, its_cd = two_rounds(
                lambda x, xin: cd_s._pass_jit(x, xin, rT, cd_u, cd_v,
                                              cd_s64, cd_s32),
                lambda r, x0, a: cd_s._gmres32_jit(r, x0, a, cd_ul32,
                                                   cd_vl32, cd_s32)[:2],
                rT, Ncd, mtol_cd)
            if bgs:
                # forward the buoyancy block J_{v,T} = −(Gr/Re)·M through
                # the cross-mesh transfer into the NS velocity RHS
                from sem_jax import operators as ops
                from sem_jax.interp import apply_transfer
                dT_ns = apply_transfer(cd_s.grid, ns_s.grid, dT)
                rv = rv + ns_s._Gr_over_Re * ops.apply_mass(ns_s.grid,
                                                            dT_ns)
            b = jnp.concatenate([ru, rv, rp])
            if k_inner > 0:
                chunkf = ns_s._fgmres32_jits[k_inner]
                xn, its_ns = two_rounds(
                    lambda x, xin: ns_s._pass_rs_jit(x, xin, b, ns_u, ns_v,
                                                     ns_jac, dinv32),
                    lambda r, x0, a: chunkf(r, x0, a, ns_ul32, ns_vl32,
                                            ns_jac32, ns_s32, dinv32)[:2],
                    b, 3 * Nns, mtol_ns)
            else:
                xn, its_ns = two_rounds(
                    lambda x, xin: ns_s._pass_pc_jit(x, xin, b, ns_u, ns_v,
                                                     ns_jac, ns_ul32,
                                                     ns_vl32, ns_s32),
                    lambda r, x0, a: ns_s._gmres32_jit(r, x0, a, ns_ul32,
                                                       ns_vl32, ns_jac32,
                                                       ns_s32)[:2],
                    b, 3 * Nns, mtol_ns)
            if bgs2:
                # symmetric sweep: re-solve the CD block against the
                # velocity-advection coupling J_{T,(u,v)}·(du,dv) — with
                # dT=0 the CD tangent is exactly that off-diagonal block
                # (Dirichlet rows and the σ-shifted diagonal contribute 0)
                from sem_jax.interp import apply_transfer
                du_cd = apply_transfer(ns_s.grid, cd_s.grid, xn[:Nns])
                dv_cd = apply_transfer(ns_s.grid, cd_s.grid,
                                       xn[Nns:2 * Nns])
                corr = cd_s._dres_jit(jnp.zeros_like(dT), cd_u, cd_v,
                                      cd_jd[0], cd_jd[1], du_cd, dv_cd,
                                      cd_s64)
                dT, its_cd2 = two_rounds(
                    lambda x, xin: cd_s._pass_jit(x, xin, rT - corr, cd_u,
                                                  cd_v, cd_s64, cd_s32),
                    lambda r, x0, a: cd_s._gmres32_jit(r, x0, a, cd_ul32,
                                                       cd_vl32, cd_s32)[:2],
                    rT - corr, Ncd, mtol_cd)
                its_cd = its_cd + its_cd2
            return (dT, xn[:Nns], xn[Nns:2 * Nns], xn[2 * Nns:],
                    its_cd, its_ns)

        return jit_hoisted(
            pc_apply, f"mda.pc_apply@{cd_s.grid.tag}|{ns_s.grid.tag}"
                      f"/k{k_inner}{'b2' if bgs2 else 'b' if bgs else 'j'}")

    def _pc_fused(self, mtol=None):
        """Bind the fused preconditioner application to the CURRENT
        linearization — or None when structurally unavailable (non-mixed /
        non-coupled solvers) or disabled (``SEM_JAX_FUSED_PC=0``)."""
        cd_s, ns_s = self.cd_comp.cd, self.ns_comp.ns
        if (os.environ.get("SEM_JAX_FUSED_PC", "1") == "0"
                or ns_s._linear_solver != "coupled"
                or not ns_s._mixed_precision or not cd_s._mixed_precision):
            return None
        k = ns_s._velo_inner
        if self._pc_fused_jit is None or self._pc_fused_k != k:
            if k > 0 and k not in ns_s._fgmres32_jits:
                ns_s._fgmres32_jits[k] = ns_s._make_fgmres32(k)
            self._pc_fused_jit = self._build_pc_fused(k)
            self._pc_fused_k = k
        pcj = self._pc_fused_jit
        mtol_cd = float(cd_s._mtol if mtol is None else mtol)
        mtol_ns = float(ns_s._mtol if mtol is None else mtol)
        cd_ul32, cd_vl32, cd_s32, cd_s64 = cd_s._lin32()
        ns_ul32, ns_vl32, ns_jac32, ns_s32 = ns_s._lin32()
        if k > 0:
            dinv32 = ns_s._dinv32
            if dinv32 is None:
                dinv32 = 1.0 / ns_s._rownorm32_jit(ns_ul32, ns_vl32,
                                                   ns_jac32,
                                                   jax.random.PRNGKey(0))
                ns_s._dinv32 = dinv32
        else:
            dinv32 = jnp.zeros((), jnp.float32)  # unused placeholder
        lin = (cd_s._u, cd_s._v, cd_s64, cd_ul32, cd_vl32, cd_s32,
               ns_s._u_lin, ns_s._v_lin, ns_s._jac, ns_ul32, ns_vl32,
               ns_jac32, ns_s32, dinv32,
               jnp.asarray(mtol_cd, jnp.float64),
               jnp.asarray(mtol_ns, jnp.float64))
        if self.precon_type == "bgs2":
            # the symmetric sweep's CD velocity-advection diagonals
            lin = lin + (cd_s._jac_diag_u, cd_s._jac_diag_v)

        def precon_split(rT, ru, rv, rp):
            # normalize program-boundary layouts (lesson: GSPMD auto-layouts
            # leaking between compiled programs produced numerically wrong
            # solves; the host path gets this from place() inside
            # _get_update — sharding.place is a no-op without a mesh)
            from sem_jax.parallel.sharding import place
            out = pcj(place(rT), place(ru), place(rv), place(rp), *lin)
            # parity with the host path's per-application accounting
            self.cd_comp.iter_count_solve += 1
            self.ns_comp.iter_count_solve += 1
            return out[:4]

        return precon_split

    def _fg_fused(self, mtol=None, best_effort=True):
        """Bind the fused host-FGMRES programs to the CURRENT linearization
        and return the ``(start, step, precon_split)`` triple for
        :func:`_fgmres` — or None when disabled (``SEM_JAX_FG_FUSED=0``,
        the escape hatch back to the un-fused reference loop)."""
        if os.environ.get("SEM_JAX_FG_FUSED", "1") == "0":
            return None
        if self._fg_fused_jits is None:
            self._fg_fused_jits = self._build_fg_fused()
        startj, stepj = self._fg_fused_jits
        cd_s, ns_s = self.cd_comp.cd, self.ns_comp.ns
        lin = (cd_s._u, cd_s._v, cd_s._jac_diag_u, cd_s._jac_diag_v,
               ns_s._u_lin, ns_s._v_lin, ns_s._jac, cd_s._sigma64())

        def start(x, b):
            return startj(x, b, *lin)

        def step(*a):
            return stepj(*a, *lin)

        precon_split = (self._pc_fused(mtol=mtol) if best_effort else None)
        if precon_split is None:
            def precon_split(rT, ru, rv, rp):
                return self._block_jacobi_split(rT, ru, rv, rp, mtol=mtol,
                                                best_effort=best_effort)

        return start, step, precon_split

    def _fgmres_device(self, b, atol=None, maxiter=None):
        """Drive on-device FGMRES windows until converged (warm-started).

        :param maxiter: optional per-call iteration cap overriding
            ``gmres_maxiter`` (the PTC Δt controller bounds per-step linear
            effort with it)
        :return: ``(x, iterations, ok, resnorm)`` — ``resnorm`` is the last
            recurrence residual (callers distinguishing "solver hit its
            target" from "stall-accepted far above it", e.g. the PTC Δt
            controller, read it)
        """
        if self._jnk_cycle_jit is None:
            self._jnk_cycle_jit = self._build_jnk_cycle()
        cd_s, ns_s = self.cd_comp.cd, self.ns_comp.ns
        b = jnp.asarray(b)
        atol = jnp.asarray(self.atol_gmres if atol is None else atol,
                           b.dtype)
        x = jnp.zeros_like(b)
        total = 0
        cd_sigma = jnp.asarray(cd_s._sigma, b.dtype)
        ns_sigma = jnp.asarray(ns_s._sigma, b.dtype)
        prev_res = None
        flat_windows = 0
        while True:
            x, info, hist = self._jnk_cycle_jit(
                x, b, cd_s._u, cd_s._v, cd_s._jac_diag_u, cd_s._jac_diag_v,
                ns_s._u_lin, ns_s._v_lin, ns_s._jac, atol,
                cd_sigma, ns_sigma)
            # ONE blocking transfer for all per-window scalars: each host
            # read of a device scalar is a full host-device round trip, and
            # this loop ran 4 reads per window
            info = jax.device_get(info)
            done = int(info.iterations)
            if self.iprint:
                for j in range(done):
                    print(f"   JNK GMRES: {total + j + 1}\t{float(hist[j])}")
            total += done
            # block-Jacobi preconditioner applications = discipline solves
            self.cd_comp.iter_count_solve += done
            self.ns_comp.iter_count_solve += done
            if bool(info.converged):
                return x, total, True, float(info.resnorm)
            if bool(info.stalled) or done == 0:
                # roundoff plateau: accept the best iterate — the Newton
                # loop's check on the TRUE nonlinear residual is
                # authoritative (same policy as the discipline solvers)
                if self.iprint:
                    print(f"   JNK GMRES: stalled at resnorm "
                          f"{float(info.resnorm):.3e} (roundoff plateau)")
                return x, total, True, float(info.resnorm)
            # cross-window plateau: each dispatch is a bounded window that
            # can exit mid-cycle, before the in-cycle stall tests run — a
            # flat-lined solve would otherwise grind to gmres_maxiter
            # (observed: Ra=1e6 PTC endgame at ~5000 its/step).  <2%
            # progress over two consecutive windows = plateau; legitimate
            # slow f64 staircases progress far faster per window (the
            # Ra=1e4 317-iteration solves average ~10%/iteration).
            res = float(info.resnorm)
            if prev_res is not None and res > 0.98 * prev_res:
                flat_windows += 1
                if flat_windows >= 2:
                    if self.iprint:
                        print(f"   JNK GMRES: stalled at resnorm "
                              f"{res:.3e} (cross-window plateau)")
                    return x, total, True, res
            else:
                flat_windows = 0
            prev_res = res
            if total >= (self.gmres_maxiter if maxiter is None else maxiter):
                return x, total, False, float(info.resnorm)

    # --------------------------- modes --------------------------- #
    def solve(self, s0: CoupledState = None) -> CoupledState:
        zcd = jnp.zeros(self.N_cd)
        zns = jnp.zeros(self.N_ns)
        s = s0.copy() if s0 is not None else CoupledState(zcd, zns, zns, zns)
        self.stats = MDAStats()
        self._t_start = time.monotonic()
        self._last_ckpt_iter = None

        warm = s0 is not None
        if self.mode == "GS":
            s = self._solve_gs(s)
        elif self.mode == "NJ":
            s = self._solve_newton(s, krylov=False, warm=warm)
        elif self.mode == "PTC":
            s = self._solve_ptc(s)
        else:  # JNK
            s = self._solve_newton(s, krylov=True, warm=warm)

        self.stats.cd_solves = self.cd_comp.iter_count_solve
        self.stats.ns_solves = self.ns_comp.iter_count_solve
        return s

    def _solve_gs(self, s: CoupledState) -> CoupledState:
        for k in range(1, self.maxiter + 1):
            s = self._gs_sweep(s)
            norm = float(jnp.linalg.norm(self._residuals(s)))
            self._print("GS", k, norm)
            self.stats.nonlinear_iters = k
            if norm <= self.atol_nonlin:
                return s
            self._maybe_checkpoint(s, k)
            self._check_budget(s, k, norm)
        raise RuntimeError(
            f"Boussinesq GS: no convergence in {self.maxiter} iterations")

    def _solve_newton(self, s: CoupledState, krylov: bool,
                      warm: bool = False) -> CoupledState:
        # iteration-0 subsystem solve (solve_subsystems=True, max_sub_solves=0)
        # — an initializer, run loosely (mtol_subsolve); Newton then converges
        # the true coupled residual.  A warm start already at least as good
        # as the loose sweep target (e.g. a p-continuation prolongation,
        # boussinesq.solve_continued) skips the sweep — re-solving the
        # disciplines at mtol_subsolve would *degrade* it.
        if warm:
            norm0 = float(jnp.linalg.norm(self._residuals(s)))
            if norm0 > self.mtol_subsolve * np.sqrt(self.DOF):
                s = self._gs_sweep(s, mtol=self.mtol_subsolve)
        else:
            s = self._gs_sweep(s, mtol=self.mtol_subsolve)
        F = self._residuals(s)
        norm = float(jnp.linalg.norm(F))
        for k in range(1, self.maxiter + 1):
            self._print("NEWTON", k - 1, norm)
            if norm <= self.atol_nonlin:
                self.stats.nonlinear_iters = k - 1
                return s
            self._check_budget(s, k - 1, norm)
            self._linearize(s)
            if krylov:
                atol_k = self.atol_gmres
                if self.forcing is not None:
                    atol_k = max(atol_k, self.forcing * norm)
                if self.device_krylov:
                    dx, iters, ok, _ = self._fgmres_device(-F, atol=atol_k)
                else:
                    precon = lambda r: self._block_jacobi(
                        r, mtol=self.mtol_precon, best_effort=True)
                    dx, iters, ok = _fgmres(
                        self._apply_linear, precon, -F,
                        atol=atol_k, restart=self.restart,
                        maxiter=self.gmres_maxiter,
                        callback=(lambda it, res: print(
                            f"   JNK GMRES: {it}\t{res}")
                            if self.iprint else None),
                        fused=self._fg_fused(mtol=self.mtol_precon))
                self.stats.gmres_iters += iters
                if not ok:
                    raise RuntimeError(
                        f"Boussinesq JNK GMRES: no convergence in {iters} "
                        f"iterations")
            else:
                dx = self._block_jacobi(-F)

            # Armijo-Goldstein backtracking (NJ mode; JNK takes full steps —
            # the reference attaches the line search only in NJ, :83-85)
            alpha = 1.0
            s_new, F_new, norm_new = self._try_step(s, dx, alpha)
            if not krylov:
                ls = 0
                while (norm_new > (1.0 - self.AGc * alpha) * norm
                       and ls < self.AGi):
                    alpha *= self.AGr
                    s_new, F_new, norm_new = self._try_step(s, dx, alpha)
                    ls += 1
            s, F, norm = s_new, F_new, norm_new
            self._maybe_checkpoint(s, k)
        raise RuntimeError(
            f"Boussinesq NEWTON: no convergence in {self.maxiter} iterations")

    def _solve_ptc(self, s: CoupledState) -> CoupledState:
        """Pseudo-transient continuation (PTC): globally-convergent steady
        solve for regimes where the from-zero Newton/JNK iteration fails
        (measured: from-zero coupled solves diverge above Ra≈1e4 and the
        block-Jacobi-preconditioned coupled GMRES flat-lines at Ra=1e5;
        the reference's PETSc GMRES + LinearBlockJac is the same algorithm
        and inherits the same wall).

        Each step solves the damped-Newton / lagged-Jacobian implicit-Euler
        system  ``(J + S(Δt)) δ = −F(x)`` with the block-diagonal mass shift
        ``S = diag(Pe/Δt·M_cd, Re/Δt·M_ns, Re/Δt·M_ns, 0)`` (continuity and
        Dirichlet rows unshifted), reusing the whole JNK machinery: the
        shift rides in the solvers' Jacobian diagonals (GLL mass is
        diagonal) and every preconditioner matches it spectrally (FDM
        ``1/(λ+σ)`` diagonals, spectral Schur ``(λ̂+σ)/ε`` modes) — so the
        coupled tangent systems are block-diagonally dominant exactly when
        the steady ones are intractable.  The Δt schedule is the shared
        :class:`sem_jax.ptc.SERController` (one implementation with the
        standalone :meth:`NavierStokesSolver.solve_ptc`): SER ramp, blowup
        rejection, linear-failure-gated shrink and the Δt trust-region
        ceiling.  As Δt→∞ the step is exact Newton, so convergence is tested
        on the unchanged steady residual and the result meets the same
        tolerances as JNK.
        """
        from sem_jax.ptc import SERController

        Pe = self.cd_comp.cd._Pe
        Re = self.ns_comp.ns._Re
        ctrl = SERController(self.ptc_dt0, growth=self.ptc_growth,
                             dt_max=self.ptc_dt_max)
        F = self._residuals(s)
        norm = float(jnp.linalg.norm(F))
        linfail_rejects = 0
        for k in range(1, self.maxiter + 1):
            dt = ctrl.dt
            self._ptc_dt_current = dt   # persisted by _maybe_checkpoint
            self._print("PTC", k - 1, f"{norm}\tdt={dt:.3g}")
            if norm <= self.atol_nonlin:
                self.stats.nonlinear_iters = k - 1
                return s
            self._check_budget(s, k - 1, norm)
            self._linearize(s, sigma_cd=Pe / dt, sigma_ns=Re / dt)
            atol_k = max(self.atol_gmres, self.ptc_forcing * norm)
            # bound per-step linear effort: a hard tangent system (large Δt)
            # returns a partial step instead of grinding; the resulting
            # smaller contraction feeds back through SER, so Δt equilibrates
            # against what the coupled solver can crack cheaply
            step_maxiter = min(self.gmres_maxiter, 12 * self.restart)
            # Device-fused windows bundle 10 outer iterations WITH their
            # nested discipline solves into one dispatch; at high Ra on
            # ≳100k-DOF grids the convection-dominated inner solves stretch
            # a window to minutes.  The host path's dispatches are
            # individually bounded (the NS block solves run their chunked
            # mixed-precision path), so PTC prefers it beyond small sizes
            # (cut-off chosen on the earlier accelerator).
            use_device = (self.device_krylov
                          and self.DOF <= _env_int(PTC_DEVICE_MAX_DOF,
                                                   150_000))
            if use_device:
                dx, iters, _, lin_res = self._fgmres_device(
                    -F, atol=atol_k, maxiter=step_maxiter)
            else:
                precon = lambda r: self._block_jacobi(
                    r, mtol=self.mtol_precon, best_effort=True)
                fused = self._fg_fused(mtol=self.mtol_precon)
                dx, iters, _ = _fgmres(
                    self._apply_linear, precon, -F,
                    atol=atol_k, restart=self.restart,
                    maxiter=step_maxiter,
                    callback=(lambda it, res: print(
                        f"   PTC GMRES: {it}\t{res}")
                        if self.iprint else None),
                    fused=fused, forecast=True)
                if fused is not None:
                    # the fused window-start program computes exactly
                    # ‖b − A·x‖ — reuse it for the TRUE linear residual
                    # instead of an ~10-dispatch _apply_linear round trip
                    lin_res = float(fused[0](dx, -F)[-1])
                else:
                    lin_res = float(jnp.linalg.norm(
                        -F - self._apply_linear(dx)))
            self.stats.gmres_iters += iters
            lin_failed = lin_res > 10 * atol_k
            s_new, F_new, norm_new = self._try_step(s, dx, 1.0)
            if not np.isfinite(norm_new) or norm_new > 1e3 * max(norm, 1.0):
                # genuine blowup: reject, damp hard, re-solve about same x
                if not ctrl.reject_blowup():
                    raise RuntimeError(
                        f"Boussinesq PTC: pseudo-time step collapsed at "
                        f"residual {norm:.3e} (target "
                        f"{self.atol_nonlin:.3e})")
                continue
            if lin_failed and norm_new > norm and linfail_rejects < 3:
                # the update did not solve the implicit-Euler system AND it
                # raised the residual: not a pseudo-time step — re-solve
                # about the SAME state at smaller Δt instead of walking a
                # garbage direction (bounded: after 3 consecutive
                # rejections fall back to SER's always-accept so a genuinely
                # rough transient cannot deadlock; see SERController
                # .reject_linfail)
                linfail_rejects += 1
                if not ctrl.reject_linfail():
                    raise RuntimeError(
                        f"Boussinesq PTC: pseudo-time step collapsed at "
                        f"residual {norm:.3e} (target "
                        f"{self.atol_nonlin:.3e})")
                continue
            linfail_rejects = 0
            # SER + linear-failure trust region (rationale in sem_jax.ptc)
            ctrl.accept(norm, norm_new, lin_failed)
            s, F, norm = s_new, F_new, norm_new
            self._maybe_checkpoint(s, k)
        raise RuntimeError(
            f"Boussinesq PTC: no convergence in {self.maxiter} iterations")

    def _try_step(self, s, dx, alpha):
        dT, du, dv, dp = self._unpack(alpha * dx)
        s_new = CoupledState(s.T + dT, s.u + du, s.v + dv, s.p + dp)
        F_new = self._residuals(s_new)
        return s_new, F_new, float(jnp.linalg.norm(F_new))
