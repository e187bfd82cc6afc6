"""jit-compiled matrix-free Krylov solvers (restarted GMRES, CG).

Replaces the reference's SciPy LGMRES calls (reference
ConvectionDiffusion_Solver.py:146-148, NavierStokes_Solver.py:222-226) with a
device-resident restarted GMRES built from ``lax.while_loop`` /
``lax.fori_loop``: fixed-size Krylov buffers, incremental Givens rotations,
masked modified-Gram-Schmidt — so the entire solve (including nested solves,
cf. the Uzawa pressure-Schur iteration) compiles into one XLA program.

Design notes:

* **Right preconditioning** (solve ``A M⁻¹ y = b``, ``x = M⁻¹ y``): the
  Arnoldi/Givens recurrence then tracks the *true* residual norm, so the
  ``atol`` convergence test matches the reference's semantics
  (absolute tolerance = mtol·√N, reference ConvectionDiffusion_Solver.py:147).
* All reductions are ``jnp.vdot``/``jnp.linalg`` ops: under ``jit`` over a
  sharded mesh they lower to ``psum`` collectives — the replacement of
  PETSc's internal MPI reductions (reference
  Boussinesq_ParallelCoupler.py:91-93; SURVEY.md §5.8).
* No Python-level control flow on traced values: solvers are safe to call
  inside other jitted code (nested Krylov).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["gmres", "fgmres", "refined_gmres_host", "cg",
           "KrylovInfo", "rownorm_estimate"]


def rownorm_estimate(matvec: "Callable", n: int, dtype, key,
                     probes: int = 8):
    """Stochastic row-norm estimate of a linear operator:
    ``d_i = sqrt(mean_k (A z_k)_i²)`` over Rademacher probes ``z_k`` — an
    unbiased estimator of the squared row 2-norms.  ``diag(d)`` is the
    standard norm conditioner for SEM systems, whose raw rows mix
    stiffness- and unit-Dirichlet scales spanning ~1e7 (used by the
    row-scaled flexible f32 chunks and the adjoint outer solve).  Floored
    at ``1e-12·max(d)`` so reciprocals are safe.  Traceable (jit-safe)."""
    def step(acc, k_):
        z = jax.random.rademacher(k_, (n,), dtype=dtype)
        w = matvec(z)
        return acc + w * w, None

    acc, _ = lax.scan(step, jnp.zeros(n, dtype),
                      jax.random.split(key, probes))
    d = jnp.sqrt(acc / probes)
    return jnp.maximum(d, 1e-12 * jnp.max(d))


class KrylovInfo(NamedTuple):
    """Solver diagnostics (all traced scalars — safe to return from jit)."""

    converged: jax.Array   # bool
    iterations: jax.Array  # int32: number of operator applications
    resnorm: jax.Array     # final true residual 2-norm
    stalled: jax.Array     # bool: stagnated at a roundoff plateau (no
    #                        progress over a full restart cycle) before
    #                        reaching atol — common when atol is set below
    #                        the f64 noise floor of a nested/inexact operator
    resweeps: jax.Array = 0  # int32: iterations whose DGKS test triggered a
    #                        second orthogonalization sweep (each one doubles
    #                        that iteration's basis HBM traffic — the
    #                        dominant per-iteration cost at SEM sizes)
    bnorm: jax.Array = 0.0  # ‖b‖ of the solve (host float; set by
    #                        refined_gmres_host when its fused pass computes
    #                        it on device — callers needing ‖b‖ for
    #                        escalation thresholds read it here instead of
    #                        paying extra blocking readbacks)


def _identity(x):
    return x


_CHUNK = 16  # Krylov-basis rows per orthogonalization chunk (see gmres)


def _mm_precision(dtype):
    """Always HIGHEST.  Measured (p16 64x64 and the CD example): the
    orthogonalization sweeps lower to full-f32 VPU fusions where the knob is
    a no-op, and every matmul-shaped op in the Krylov path (operator applies,
    FDM preconditioner transforms) is accuracy-critical — 3-pass HIGH floors
    the f32 inner solves at ~4e-5 relative (vs ~1e-5 needed), multiplying
    refinement passes ~25x."""
    return lax.Precision.HIGHEST


# ------------------ shared orthogonalization/recurrence ------------------ #
# One implementation of the per-iteration Krylov economics, used by both
# ``gmres`` and ``fgmres``: live-chunk block-MGS sweeps, the
# DGKS-selective reorthogonalization, and the associative-scan Givens chain.

def _mgs_sweep_live(V, w, k, cchunk, hi):
    """One block-MGS sweep of ``w`` against the LIVE rows of ``V``.

    ``V`` is row-padded to a multiple of ``cchunk``; at iteration k only rows
    0..k are live.  A ``fori_loop`` over exactly the ceil((k+1)/cchunk) live
    chunks (contiguous ``dynamic_slice`` reads — never a gather) guarantees
    dead chunks are neither read from HBM nor multiplied: the previous
    formulation (scan over all chunks with a ``lax.cond`` skip) still issued
    every chunk's HBM read as a scan operand, which at p16 sizes (a ~2 GB
    basis) made the skip cosmetic.  Chunk-sequential MGS is at least as
    stable as CGS over the same span.

    Returns ``(w_orthogonalized, h)`` with ``h`` shaped ``(mp,)``.
    """
    mp, n = V.shape
    dtype = w.dtype  # working dtype (V may be stored lower-precision)
    nlive = k // cchunk + 1

    def body(j, carry):
        w, h = carry
        row0 = j * cchunk
        Vj = lax.dynamic_slice(V, (row0, jnp.zeros((), row0.dtype)),
                               (cchunk, n))
        hj = jnp.matmul(Vj, w, precision=hi).astype(dtype)
        w = w - jnp.matmul(Vj.T, hj, precision=hi).astype(dtype)
        h = lax.dynamic_update_slice(h, hj, (row0,))
        return w, h

    return lax.fori_loop(0, nlive, body, (w, jnp.zeros(mp, dtype)))


# default DGKS reorthogonalization threshold η: resweep when the first sweep
# cancelled more than (1-η) of ‖w‖, i.e. ‖w₁‖ < η·‖w₀‖.  1/√2 is the
# classical Daniel-Gragg-Kaufman-Stewart constant ("twice is enough" with
# certainty) but is hyper-conservative for the chunked-MGS sweeps here:
# measured on REAL solves (P=8 32×32 coupled JNK; Re=400 P=8 16×16 lid),
# η=1/√2 resweeps 96% of iterations while η=0.25 resweeps 3% with
# IDENTICAL iteration counts, solutions, and f64-fallback behavior — each
# avoided resweep saves that iteration's second pass over the live Krylov
# basis (the dominant per-iteration HBM cost at SEM sizes; ~3.2 of
# 10.2 ms/it at p16).  The aggressive default applies only to the
# LOW-PRECISION working dtypes (the bandwidth-critical f32/bf16 inner
# chunks, where those measurements live); f64 solves keep the classical
# constant — they are the tight-tolerance/fallback paths, their basis
# traffic is not the hot-loop cost, and an unmeasured solver family
# regressing through silent orthogonality loss would show up only as
# iteration inflation.
DGKS_ETA = 0.25            # f32 / bfloat16 working dtypes
DGKS_ETA_F64 = 2 ** -0.5   # float64: classical "twice is enough"

_LP_DTYPES = (jnp.dtype(jnp.float32), jnp.dtype(jnp.bfloat16))


def _default_eta(dtype):
    return DGKS_ETA if jnp.dtype(dtype) in _LP_DTYPES else DGKS_ETA_F64


def _orthogonalize(V, w, k, cchunk, hi, eta=DGKS_ETA):
    """Block-MGS with a DGKS-selective second sweep.

    The second sweep runs only when the first one cancelled most of ``‖w‖``
    (n1 < η·n0): under a strong preconditioner successive Krylov vectors stay
    well separated and the skip saves half the basis traffic; under weak
    preconditioning it degrades gracefully to CGS2.

    Returns ``(w, h, hk1, resw)`` — the orthogonalized vector, projection
    coefficients ``(mp,)``, its remaining norm, and whether the second sweep
    ran (int32 0/1).
    """
    n0 = jnp.linalg.norm(w)
    w, h1 = _mgs_sweep_live(V, w, k, cchunk, hi)
    n1 = jnp.linalg.norm(w)

    def _resweep(args):
        w1, h1_ = args
        w2, h2 = _mgs_sweep_live(V, w1, k, cchunk, hi)
        return w2, h1_ + h2

    resw = n1 < eta * n0
    w, h = lax.cond(resw, _resweep, lambda a: a, (w, h1))
    return w, h, jnp.linalg.norm(w), resw.astype(jnp.int32)


def _givens_update(h, cs, sn, g, k, m, eps_tiny):
    """Apply the stored Givens rotations to the new column ``h`` and compute
    the rotation zeroing ``h[k+1]``.

    The recurrence α_{j+1} = -s_j α_j + c_j h_{j+1} (α_0 = h_0) is a
    first-order linear recurrence → log-depth associative scan instead of a
    sequential loop (latency-bound on an accelerator).  Unused rotation slots hold the
    identity (c=1, s=0), so no masking on k is needed.

    Returns ``(h, cs, sn, g, res)`` with ``res = |g[k+1]|`` the recurrence
    residual after this iteration.
    """
    A = -sn
    bvec = (cs * h[1:]).at[0].add(A[0] * h[0])

    def _comb(x, y):
        Ax, bx = x
        Ay, by = y
        return Ay * Ax, Ay * bx + by

    _, ys = lax.associative_scan(_comb, (A, bvec))
    alphas = jnp.concatenate([h[:1], ys])        # α_0 .. α_m
    hprime = cs * alphas[:m] + sn * h[1:]        # rotated entries 0..m-1
    h = jnp.concatenate([hprime, alphas[m:m + 1]])
    denom = jnp.sqrt(h[k] ** 2 + h[k + 1] ** 2)
    c = jnp.where(denom > eps_tiny, h[k] / jnp.maximum(denom, eps_tiny), 1.0)
    s = jnp.where(denom > eps_tiny, h[k + 1] / jnp.maximum(denom, eps_tiny),
                  0.0)
    cs = cs.at[k].set(c)
    sn = sn.at[k].set(s)
    h = h.at[k].set(denom).at[k + 1].set(0.0)
    g = g.at[k + 1].set(-s * g[k]).at[k].set(c * g[k])
    return h, cs, sn, g, jnp.abs(g[k + 1])


def _solve_small_triangular(H, g, kk, m, dtype):
    """Masked solve of the kk×kk leading triangular system (unused rows and
    columns → identity, RHS → 0)."""
    used = jnp.arange(m) < kk
    Rm = jnp.where(used[:, None] & used[None, :], H[:m, :m],
                   jnp.eye(m, dtype=dtype))
    rhs = jnp.where(used, g[:m], 0.0)
    return jax.scipy.linalg.solve_triangular(Rm, rhs, lower=False)


def gmres(matvec: Callable, b: jax.Array, x0: Optional[jax.Array] = None, *,
          atol: float, restart: int = 30, maxiter: int = 1000,
          precon: Optional[Callable] = None, return_hist: bool = False,
          basis_dtype=None, dgks_eta: float = None):
    """Restarted GMRES(m) with right preconditioning.

    :param matvec:  linear operator ``A(x)`` (must be traceable)
    :param b:       right-hand side (any pytree-free flat array)
    :param x0:      initial guess (zeros if None) — warm starts supported as in
                    the reference (dT0/du0/dp0 threading)
    :param atol:    absolute tolerance on ||b - A x||₂
    :param restart: Krylov window m
    :param maxiter: max TOTAL inner iterations (matvec applications)
    :param precon:  *linear* right preconditioner ``M⁻¹(r)``
    :param return_hist: also return the per-iteration recurrence residual
        (shape ``(maxiter,)``, padded with the final value) — the data behind
        the reference's ``'LGMRES_iter'`` per-iteration prints (reference
        ConvectionDiffusion_Solver.py:139-144), recorded on device and
        printable after the dispatch
    :param basis_dtype: storage dtype of the Krylov basis ``V`` (default:
        the dtype of ``b``).  ``jnp.bfloat16`` halves the HBM traffic of the
        (bandwidth-bound) orthogonalization sweeps at the cost of a ~1e-3
        attainable-residual floor — only sensible for loose-tolerance inner
        solves; arithmetic stays in the working dtype
    :param dgks_eta: DGKS reorthogonalization threshold (None = the
        dtype-dependent default: :data:`DGKS_ETA` for f32/bf16,
        :data:`DGKS_ETA_F64` for f64); each triggered resweep doubles that
        iteration's basis traffic, reported in ``KrylovInfo.resweeps``
    :return: (x, KrylovInfo) or (x, KrylovInfo, hist)
    """
    if precon is None:
        precon = _identity
    m = int(restart)
    n = b.shape[0]
    dtype = b.dtype
    eta = _default_eta(dtype) if dgks_eta is None else float(dgks_eta)
    bdt = dtype if basis_dtype is None else jnp.dtype(basis_dtype)
    eps_tiny = jnp.asarray(1e-300 if dtype == jnp.float64 else 1e-30, dtype)
    atol = jnp.asarray(atol, dtype)

    # Krylov-basis chunking: the basis buffer is stored row-padded to a
    # multiple of ``_CHUNK`` rows so orthogonalization can run as a scan over
    # row chunks, skipping chunks beyond the current column count k — at
    # iteration k only ~k rows are live, so the (bandwidth-bound) basis
    # sweeps cost ~half of the monolithic (m+1)-row matmuls on average.
    cchunk = min(_CHUNK, m + 1)
    nchunk = -(-(m + 1) // cchunk)
    mp = nchunk * cchunk

    x0 = jnp.zeros_like(b) if x0 is None else x0.astype(dtype)

    def new_cycle(x):
        r = b - matvec(x)
        beta = jnp.linalg.norm(r)
        V = jnp.zeros((mp, n), bdt)
        V = V.at[0].set((r / jnp.maximum(beta, eps_tiny)).astype(bdt))
        H = jnp.zeros((m + 1, m), dtype)
        g = jnp.zeros(m + 1, dtype).at[0].set(beta)
        cs = jnp.ones(m, dtype)   # identity rotations in unused slots
        sn = jnp.zeros(m, dtype)
        return x, V, H, cs, sn, g, beta

    x, V, H, cs, sn, g, beta0 = new_cycle(x0)

    # State: (x, V, H, cs, sn, g, k, it, res, done, cycle_res, stalled, hist,
    #         nresweep)
    state = (x, V, H, cs, sn, g, jnp.int32(0), jnp.int32(0), beta0,
             beta0 <= atol, beta0, jnp.asarray(False),
             jnp.full(maxiter, beta0, dtype), jnp.int32(0))

    def cond(state):
        return ~state[9]

    def body(state):
        (x, V, H, cs, sn, g, k, it, res, done, cycle_res, stalled,
         hist, nresweep) = state

        w = matvec(precon(V[k].astype(dtype)))
        # live-chunk block-MGS + DGKS-selective resweep (shared helper) —
        # these bandwidth-bound basis sweeps are the dominant per-iteration
        # cost at SEM sizes
        hi = _mm_precision(dtype)  # f32 products may otherwise run in TF32
        w, h, hk1, resw = _orthogonalize(V, w, k, cchunk, hi, eta)
        nresweep = nresweep + resw
        h = h[:m + 1].at[k + 1].set(hk1)
        V = V.at[k + 1].set((w / jnp.maximum(hk1, eps_tiny)).astype(bdt))

        h, cs, sn, g, res = _givens_update(h, cs, sn, g, k, m, eps_tiny)
        H = H.at[:, k].set(h)
        hist = hist.at[it].set(res)
        it = it + 1

        conv = res <= atol
        # in-cycle plateau (LOW-PRECISION dtypes only): < 2% progress over
        # the last 40 iterations means the recurrence is grinding at its
        # attainable roundoff floor — end the cycle now instead of burning
        # the rest of the restart window (stall detection at cycle
        # boundaries alone lets a floored f32 chunk waste hundreds of
        # iterations).  f64 solves are exempt: hard systems exhibit
        # legitimate >40-iteration stagnation phases before superlinear
        # convergence (measured: the Re=400 P=8 lid-cavity tangent systems
        # make <2%/40 early yet converge by iteration ~190), and the f64
        # roundoff floor is far below any practical tolerance.
        if dtype in (jnp.dtype(jnp.float32), jnp.dtype(jnp.bfloat16)):
            prev40 = hist[jnp.maximum(it - 1 - 40, 0)]
            stall_in = (it - 1 >= 40) & (res > 0.98 * prev40)
        else:
            stall_in = jnp.asarray(False)
        end_cycle = conv | (k + 1 >= m) | (it >= maxiter) | stall_in

        def finish(_):
            kk = k + 1  # columns in use
            y = _solve_small_triangular(H, g, kk, m, dtype)
            # right-preconditioned update: x += M⁻¹ (Vᵀ y)  (precon is linear)
            dx = precon(jnp.matmul(V[:m].T, y, precision=_mm_precision(dtype)))
            x_new = x + dx
            xn, Vn, Hn, csn, snn, gn, beta = new_cycle(x_new)
            # recompute the true residual at cycle end; use it for the test.
            # stagnation: a full restart cycle improved the true residual by
            # < 10% — a roundoff plateau; further cycles cannot help.  The
            # in-cycle plateau (stall_in) is qualified by the same TRUE
            # residual test: a legitimately slow (<2%/40-iteration in the
            # recurrence) but convergent chunk whose restart still gained
            # >10% true progress continues instead of reporting stalled
            # (otherwise refined_gmres_host classifies it as floored and
            # disables adaptive deepening, forcing the expensive f64 retry).
            stall_new = (beta > atol) & (beta > 0.9 * cycle_res) \
                & ((kk >= m) | stall_in)
            done_new = (beta <= atol) | (it >= maxiter) | stall_new
            return (xn, Vn, Hn, csn, snn, gn, jnp.int32(0), it, beta,
                    done_new, beta, stall_new, hist, nresweep)

        def cont(_):
            return (x, V, H, cs, sn, g, k + 1, it, res, done, cycle_res,
                    stalled, hist, nresweep)

        return lax.cond(end_cycle, finish, cont, None)

    state = lax.while_loop(cond, body, state)
    x, it, res, stalled, hist = (state[0], state[7], state[8], state[11],
                                 state[12])
    info = KrylovInfo(converged=res <= atol, iterations=it, resnorm=res,
                      stalled=stalled, resweeps=state[13])
    if return_hist:
        return x, info, hist
    return x, info


def fgmres(matvec: Callable, b: jax.Array, x0: Optional[jax.Array] = None, *,
           atol, restart: int = 20, maxiter: int = 1000,
           precon: Callable, dgks_eta: float = None, basis_dtype=None):
    """Flexible GMRES(m): right preconditioner may vary per application.

    The coupled-MDA Krylov solver (reference Boussinesq_SequentialCoupler.py
    :86-91 drives ScipyKrylov/PETScKrylov GMRES preconditioned by
    LinearBlockJac): the block-Jacobi preconditioner here contains inner
    Krylov solves, so the preconditioned vectors ``Z`` are stored explicitly
    (Saad's FGMRES) and the solution update uses them.  Runs entirely on
    device — while-loops and all — so one dispatch covers a full restart
    cycle including every inner discipline solve.

    Shares the per-iteration economics of :func:`gmres`:
    live-chunk block-MGS sweeps with the DGKS-selective second sweep, the
    associative-scan Givens chain, the in-cycle plateau detection for
    low-precision dtypes, the true-residual-qualified stall semantics, and
    ``basis_dtype`` (storage dtype of the Arnoldi basis ``V`` only — the
    flexible basis ``Z`` holds the solution update and stays in the working
    dtype).

    :return: ``(x, KrylovInfo, res_hist)`` — ``res_hist[j]`` is the
        recurrence residual after outer iteration j (padded with the final
        value), enabling the reference's per-iteration MDA iprint lines
        without host round trips inside the cycle.
    """
    m = int(restart)
    n = b.shape[0]
    dtype = b.dtype
    bdt = dtype if basis_dtype is None else jnp.dtype(basis_dtype)
    eps_tiny = jnp.asarray(1e-300 if dtype == jnp.float64 else 1e-30, dtype)
    atol = jnp.asarray(atol, dtype)
    hi = _mm_precision(dtype)
    eta = _default_eta(dtype) if dgks_eta is None else float(dgks_eta)
    cchunk = min(_CHUNK, m + 1)
    mp = -(-(m + 1) // cchunk) * cchunk

    x0 = jnp.zeros_like(b) if x0 is None else x0.astype(dtype)

    def new_cycle(x):
        r = b - matvec(x)
        beta = jnp.linalg.norm(r)
        V = jnp.zeros((mp, n), bdt).at[0].set(
            (r / jnp.maximum(beta, eps_tiny)).astype(bdt))
        Z = jnp.zeros((m, n), dtype)
        H = jnp.zeros((m + 1, m), dtype)
        g = jnp.zeros(m + 1, dtype).at[0].set(beta)
        cs = jnp.ones(m, dtype)
        sn = jnp.zeros(m, dtype)
        return x, V, Z, H, cs, sn, g, beta

    x, V, Z, H, cs, sn, g, beta0 = new_cycle(x0)
    hist0 = jnp.full(maxiter, beta0, dtype)

    # state: (x, V, Z, H, cs, sn, g, k, it, res, done, cycle_res, stalled,
    #         hist, nresweep)
    state = (x, V, Z, H, cs, sn, g, jnp.int32(0), jnp.int32(0), beta0,
             beta0 <= atol, beta0, jnp.asarray(False), hist0, jnp.int32(0))

    def cond(state):
        return ~state[10]

    def body(state):
        (x, V, Z, H, cs, sn, g, k, it, res, done, cycle_res, stalled,
         hist, nresweep) = state

        z = precon(V[k].astype(dtype))
        w = matvec(z)
        Z = Z.at[k].set(z)
        w, h, hk1, resw = _orthogonalize(V, w, k, cchunk, hi, eta)
        nresweep = nresweep + resw
        h = h[:m + 1].at[k + 1].set(hk1)
        V = V.at[k + 1].set((w / jnp.maximum(hk1, eps_tiny)).astype(bdt))

        h, cs, sn, g, res = _givens_update(h, cs, sn, g, k, m, eps_tiny)
        H = H.at[:, k].set(h)
        hist = hist.at[it].set(res)
        it = it + 1

        conv = res <= atol
        # in-cycle plateau for low-precision dtypes only (cf. gmres)
        if dtype in (jnp.dtype(jnp.float32), jnp.dtype(jnp.bfloat16)):
            prev40 = hist[jnp.maximum(it - 1 - 40, 0)]
            stall_in = (it - 1 >= 40) & (res > 0.98 * prev40)
        else:
            stall_in = jnp.asarray(False)
        end_cycle = conv | (k + 1 >= m) | (it >= maxiter) | stall_in

        def finish(_):
            kk = k + 1
            y = _solve_small_triangular(H, g, kk, m, dtype)
            x_new = x + jnp.matmul(Z.T, y, precision=hi)  # flexible update
            xn, Vn, Zn, Hn, csn, snn, gn, beta = new_cycle(x_new)
            # stall only when the TRUE residual also failed to progress
            # (a legitimately slow but convergent cycle continues; cf. gmres)
            stall_new = (beta > atol) & (beta > 0.9 * cycle_res) \
                & ((kk >= m) | stall_in)
            done_new = (beta <= atol) | (it >= maxiter) | stall_new
            return (xn, Vn, Zn, Hn, csn, snn, gn, jnp.int32(0), it, beta,
                    done_new, beta, stall_new, hist, nresweep)

        def cont(_):
            return (x, V, Z, H, cs, sn, g, k + 1, it, res, done, cycle_res,
                    stalled, hist, nresweep)

        return lax.cond(end_cycle, finish, cont, None)

    state = lax.while_loop(cond, body, state)
    x, it, res, stalled, hist = (state[0], state[8], state[9], state[12],
                                 state[13])
    return x, KrylovInfo(converged=res <= atol, iterations=it, resnorm=res,
                         stalled=stalled, resweeps=state[14]), hist


def _accum(x, xin):
    """Refinement update ``x + xin`` accumulated in the iterate dtype —
    one program instead of an astype + add dispatch pair (every extra
    dispatch in the refinement loop is a full accelerator round trip)."""
    return x + xin.astype(x.dtype)


def rowscale_prep(r, scale, dinv):
    """Fused per-pass prep for ROW-SCALED refinement chunks: downcast,
    scale by the stochastic row-norm inverse, and compute the chunk
    tolerance — one dispatch instead of three (see
    :func:`refined_gmres_host`'s ``pc_prep``)."""
    rp = r.astype(dinv.dtype) * dinv
    rpn = jnp.linalg.norm(rp)
    return rp, scale * rpn, rpn


# hoisted so these refinement-loop glue programs join the prefetch manifest
# (each first call otherwise compiles mid-solve)
from sem_jax.utils.hoist import jit_hoisted as _jit_hoisted  # noqa: E402

_accum = _jit_hoisted(_accum, "kry.accum")
rowscale_prep = _jit_hoisted(rowscale_prep, "kry.rowscale_prep")


def refined_gmres_host(cres: Callable, pc_lp: Callable, gmres_chunk: Callable,
                       b: jax.Array, x0: jax.Array, *,
                       atol: float = None, maxiter: int, max_refine: int = 12,
                       inner_rtol: float = 1e-5, lp_dtype=jnp.float32,
                       pc_prep: Callable = None, pass_fused: Callable = None,
                       atol_fn: Callable = None):
    """Host-orchestrated mixed-precision GMRES.

    f32 left-preconditioned inner solves inside an f64 iterative-refinement
    loop with best-iterate tracking — the Krylov loop runs in float32 (half
    the basis traffic of float64) while the refinement loop enforces the
    TRUE f64 residual tolerance.  The inner solve is
    left-preconditioned because SEM systems mix stiffness- and mass-scaled
    rows spanning ~1e7, beyond f32 resolution in the raw norm.  Orchestrated
    at the host level with *bounded-size device dispatches*:

    * a single all-fused megakernel (while-in-while-in-cond) provokes XLA
      compile failures at large problem sizes, and
    * a single multi-minute device dispatch gives the host no chance to
      stop, report or check a time budget;

    chunking the inner GMRES into warm-started segments bounds both, at the
    cost of ≤ a few dozen host round trips per solve.

    :param cres: jitted ``cres(x) -> b - A x`` in the outer (f64) dtype
    :param pc_lp: jitted low-precision preconditioner ``M⁻¹(r_lp)``
    :param gmres_chunk: jitted ``gmres_chunk(rhs_lp, x0_lp, atol_lp) ->
        (x_lp, KrylovInfo)`` running a *bounded* number of iterations of
        left-preconditioned GMRES on ``M⁻¹A x = rhs_lp``.  Exactly one chunk
        runs per refinement pass (the f64 pass is ~2 operator applies —
        far cheaper than any same-level retry), so the effective iteration
        budget is ``min(maxiter, (max_refine+1) · chunk_bound)``
    :param pc_prep: optional FUSED per-pass prep
        ``pc_prep(r, scale) -> (rp, atol_lp, rpn_dev)`` replacing the
        downcast + ``pc_lp`` + norm + tolerance sequence with ONE jitted
        dispatch.  Each un-fused op in this loop is a full host-device
        round trip.  ``pc_lp`` may be None when given.
    :param pass_fused: optional FULLY-FUSED refinement pass
        ``pass_fused(x, xin) -> (x_new, rn_dev, rp, rpn_dev)`` — one jitted
        program for accumulate + true residual + norm + low-precision prep
        (``x_new = x + xin``, ``r = b - A x_new``, ``rn = ‖r‖``,
        ``rp``/``rpn`` as in ``pc_prep``).  With it the loop costs ONE
        dispatch + ONE chunk + ONE combined blocking read per pass (the
        chunk tolerance is computed on host from the read-back ``rpn``);
        without it an equivalent shim is built from
        ``cres``+``pc_prep``/``pc_lp`` (more dispatches, same combined
        read).  The chunk's ``atol_lp`` argument then arrives as a host
        scalar instead of a device one.
    :param atol_fn: optional ``atol_fn(normb) -> atol`` evaluated from the
        device-computed ``‖b‖`` that rides the FIRST combined read —
        callers then skip their own blocking ``‖b‖`` readback; ``atol``
        may be None when given.  The resulting ``‖b‖`` is reported in
        ``KrylovInfo.bnorm``.
    :return: (x, KrylovInfo)
    """
    dtype = b.dtype
    if pass_fused is None:
        # shim: same per-pass algebra from the separately-jitted pieces
        # (legacy callers); scale=1 — the chunk tolerance is host-side now
        if pc_prep is not None:
            one = jnp.asarray(1.0, lp_dtype)

            def pass_fused(x_, xin_):
                x_ = _accum(x_, xin_)
                r = cres(x_)
                rp, _, rpn = pc_prep(r, one)
                return x_, jnp.linalg.norm(r), rp, rpn
        else:
            def pass_fused(x_, xin_):
                x_ = _accum(x_, xin_)
                r = cres(x_)
                rp = pc_lp(r.astype(lp_dtype))
                return x_, jnp.linalg.norm(r), rp, jnp.linalg.norm(rp)

    bn_dev = jnp.linalg.norm(b) if atol_fn is not None else None
    normb = 0.0
    x, x_best = x0, x0
    rn_best = float("inf")
    rn0 = None
    prev = float("inf")
    total_it = 0
    rn = float("inf")
    plateau = False   # exited because refinement stopped progressing (vs
    #                   exhausting the refinement/iteration budget)
    floor_rel = 0.0   # learned f32-attainable relative residual of the
    #                   preconditioned system (0 until a chunk fails to
    #                   converge)
    last_inner_floored = False  # the most recent chunk hit its own roundoff
    #                   floor (or had nothing to do) — distinguishes a
    #                   warm start already at the attainable floor from a
    #                   broken preconditioner (chunk converges in the
    #                   preconditioned norm, true residual unmoved)
    inner_eff = inner_rtol  # adaptively deepened (see below)
    passes = 0
    # Effective pass budget: ``max_refine`` bounds the refinement when chunks
    # are productive, but the total-iteration budget stays governed by
    # ``maxiter`` — once the observed per-chunk iteration count is known, the
    # pass cap is raised to ceil(maxiter / chunk_iters) so callers tuning
    # ``maxiter`` alone get the budget they asked for (the plateau /
    # no-progress exits below remain the safety net against unproductive
    # looping).
    passes_cap = max_refine + 1
    chunk_iters_max = 0
    total_resweeps = 0
    # Pipelined accounting: chunk k's KrylovInfo is read back together with
    # pass k+1's residual norms in ONE blocking transfer (``pending``) —
    # each host read of a device scalar is a full host-device round trip,
    # and the un-batched loop paid 2-3 per pass.
    pending = None
    rpn_prev = None
    zlp = jnp.zeros(b.shape, lp_dtype)  # chunk warm start (reused buffer)
    xin = zlp
    while True:
        x_new, rn_dev, rp, rpn_dev = pass_fused(x, xin)
        reads = [rn_dev, rpn_dev]
        if pending is not None:
            reads.append(pending)
        if bn_dev is not None:
            reads.append(bn_dev)
        got = jax.device_get(tuple(reads))
        rn, rpn = float(got[0]), float(got[1])
        idx = 2
        if pending is not None:
            info_h = got[idx]
            idx += 1
            total_it += int(info_h.iterations)
            total_resweeps += int(info_h.resweeps)
            chunk_iters_max = max(chunk_iters_max, int(info_h.iterations), 1)
            passes_cap = max(max_refine + 1, -(-maxiter // chunk_iters_max))
            last_inner_floored = (bool(info_h.stalled)
                                  or int(info_h.iterations) == 0)
            # learned attainable floor: once a chunk ends non-converged, its
            # final residual relative to ITS input ``rpn`` is the f32 floor
            # of this preconditioned system — later passes ask only for what
            # is attainable instead of grinding toward an unreachable fixed
            # inner_rtol
            if (not bool(info_h.converged) and rpn_prev is not None
                    and rpn_prev > 0.0):
                floor_rel = max(floor_rel,
                                float(info_h.resnorm) / rpn_prev)
            pending = None
        if bn_dev is not None:
            normb = float(got[idx])
            atol = atol_fn(normb)
            bn_dev = None
        x = x_new
        if rn0 is None:
            rn0 = rn
        if rn < rn_best:
            x_best, rn_best = x, rn
        if rn <= atol or not np.isfinite(rn):
            plateau = False
            break
        if total_it >= maxiter:
            plateau = False  # iteration budget exhausted, not a plateau
            break
        if passes >= passes_cap:
            plateau = False  # pass budget exhausted
            break
        if rn > 0.9 * prev:
            # the last pass barely moved the TRUE residual.  If its chunk
            # *converged* in the preconditioned norm, the preconditioner is
            # down-weighting exactly the components that remain (a very
            # strong preconditioner can converge the dominant part in a few
            # iterations without ever rotating into the crushed ones) —
            # DEEPEN the inner tolerance and retry rather than giving up;
            # bounded by the f32 roundoff floor (~1e-7 relative).
            if (not last_inner_floored and inner_eff > 2e-7
                    and total_it < maxiter):
                inner_eff = max(inner_eff * 1e-2, 1e-7)
            else:
                plateau = rn > atol
                break
        prev = rn
        # ONE bounded chunk per refinement pass, then always hand back to
        # the f64 refinement: a refinement pass costs ~2 operator applies
        # while a chunk costs hundreds of Krylov iterations, so retrying at
        # the f32 level when a chunk ends at its attainable floor (observed:
        # a chunk reaching 1.7× above atol_lp, then a full second chunk
        # gaining 3%) can never pay off — the f64 pass re-poses the system
        # about the new iterate and the next chunk starts fresh.  Its
        # tolerance is a HOST scalar (rpn arrived with this pass's combined
        # read — no extra round trip).
        atol_lp = np.asarray(max(inner_eff, 2.0 * floor_rel) * rpn,
                             np.dtype(lp_dtype))
        xin, pending = gmres_chunk(rp, zlp, atol_lp)
        rpn_prev = rpn
        passes += 1

    # Exit-reason discrimination (three outcomes, so callers can keep the
    # reference's fail-fast semantics, reference
    # ConvectionDiffusion_Solver.py:149-150 / NavierStokes_Solver.py:225-226):
    #   converged          — reached atol;
    #   stalled            — a genuine roundoff plateau: the refinement made
    #                        real progress (>1% from the initial residual)
    #                        and then stopped improving; the best iterate is
    #                        the attainable solution, outer residual checks
    #                        are authoritative;
    #   neither            — divergence (no progress at all despite inner
    #                        work) or budget exhaustion while *still
    #                        progressing* (maxiter/max_refine too small) —
    #                        callers raise RuntimeError.
    converged = rn_best <= atol
    made_progress = rn0 is not None and (rn_best < 0.99 * rn0
                                         or rn0 <= atol * 10)
    genuine_plateau = plateau and (made_progress or last_inner_floored)
    info = KrylovInfo(converged=jnp.asarray(converged),
                      iterations=jnp.int32(total_it),
                      resnorm=jnp.asarray(rn_best, dtype),
                      stalled=jnp.asarray(bool(not converged
                                               and genuine_plateau)),
                      resweeps=jnp.int32(total_resweeps),
                      bnorm=normb)
    return x_best, info


def cg(matvec: Callable, b: jax.Array, x0: Optional[jax.Array] = None, *,
       atol: float, maxiter: int = 1000,
       precon: Optional[Callable] = None):
    """Preconditioned conjugate gradients for SPD operators.

    Offered alongside GMRES for symmetric systems (e.g. pure-diffusion
    subproblems); convergence test on the true residual 2-norm like ``gmres``.
    """
    if precon is None:
        precon = _identity
    dtype = b.dtype
    atol = jnp.asarray(atol, dtype)
    x = jnp.zeros_like(b) if x0 is None else x0.astype(dtype)

    r = b - matvec(x)
    z = precon(r)
    p = z
    hi = _mm_precision(dtype)
    rz = jnp.vdot(r, z, precision=hi)
    state = (x, r, z, p, rz, jnp.int32(0))

    def cond(s):
        x, r, z, p, rz, it = s
        return (jnp.linalg.norm(r) > atol) & (it < maxiter)

    def body(s):
        x, r, z, p, rz, it = s
        Ap = matvec(p)
        alpha = rz / jnp.vdot(p, Ap, precision=hi)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precon(r)
        rz_new = jnp.vdot(r, z, precision=hi)
        p = z + (rz_new / rz) * p
        return x, r, z, p, rz_new, it + 1

    x, r, z, p, rz, it = lax.while_loop(cond, body, state)
    res = jnp.linalg.norm(r)
    return x, KrylovInfo(converged=res <= atol, iterations=it, resnorm=res,
                         stalled=jnp.asarray(False))
