"""Navier-Stokes solver tests: tangent consistency, small lid-driven cavity
vs the Ghia benchmark, Stokes/zero-forcing sanity (SURVEY.md §7.2 step 6)."""
import numpy as np
import pytest
import jax.numpy as jnp

from sem_jax import NavierStokesSolver
from sem_jax import operators as ops

RNG = np.random.default_rng(11)


@pytest.fixture(scope="module")
def ns_small():
    return NavierStokesSolver(1.0, 1.0, Re=50.0, Gr=10.0, P=3, N_ex=3, N_ey=3,
                              u_N=1.0, mtol=1e-10, mtol_newton=1e-9,
                              iprint=[])


def test_ns_tangent_consistency(ns_small):
    """_get_dresiduals is the exact Jacobian-vector product of _get_residuals."""
    ns = ns_small
    N = ns.N
    u, v, p, T = (RNG.standard_normal(N) * 0.2 for _ in range(4))
    du, dv, dp, dT = (RNG.standard_normal(N) for _ in range(4))

    r0 = [np.asarray(r) for r in ns._get_residuals(u, v, p, T)]
    ns._calc_jacobians(u, v)
    dres = [np.asarray(r) for r in ns._get_dresiduals(du, dv, dp, dT)]

    eps = 1e-7
    r1 = [np.asarray(r) for r in ns._get_residuals(
        u + eps * du, v + eps * dv, p + eps * dp, T + eps * dT)]
    for got, a, b in zip(dres, r1, r0):
        fd = (a - b) / eps
        np.testing.assert_allclose(got, fd, rtol=2e-5, atol=2e-5)


def test_ns_zero_forcing_zero_solution():
    """No lid motion, no buoyancy: (u,v,p)=0 satisfies everything."""
    ns = NavierStokesSolver(1.0, 1.0, Re=10.0, Gr=0.0, P=3, N_ex=2, N_ey=2,
                            mtol=1e-12, mtol_newton=1e-10, iprint=[])
    u, v, p = ns._get_solution(jnp.zeros(ns.N))
    np.testing.assert_allclose(np.asarray(u), 0.0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(v), 0.0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(p), 0.0, atol=1e-7)
    assert ns._k == 0  # converged without any Newton step


def test_ns_update_solves_tangent_system(ns_small):
    """The Uzawa update really inverts the masked coupled Jacobian."""
    ns = ns_small
    N = ns.N
    u, v, p, T = (RNG.standard_normal(N) * 0.1 for _ in range(4))
    ns._get_residuals(u, v, p, T)
    ns._calc_jacobians(u, v)
    bu, bv, bc = (RNG.standard_normal(N) for _ in range(3))
    du, dv, dp = ns._get_update(bu, bv, bc)
    ru, rv, rc = [np.asarray(r) for r in ns._get_dresiduals(du, dv, dp)]
    scale = np.sqrt(N)
    assert np.linalg.norm(ru - bu) / scale < 1e-7
    assert np.linalg.norm(rv - bv) / scale < 1e-7
    assert np.linalg.norm(rc - bc) / scale < 1e-6


def test_ns_lid_driven_divergence_free():
    """Lid-driven Re=10: interior weak divergence vanishes at the solution."""
    ns = NavierStokesSolver(1.0, 1.0, Re=10.0, Gr=0.0, P=4, N_ex=4, N_ey=4,
                            u_N=1.0, mtol=1e-11, mtol_newton=1e-10, iprint=[])
    u, v, p = ns._get_solution(jnp.zeros(ns.N))
    div = np.asarray(ops.apply_grad_x(ns.grid, u)
                     + ops.apply_grad_y(ns.grid, v))
    # continuity is enforced at interior nodes except the pressure-pin node
    # (whose row is replaced by the pin constraint, reference :116)
    interior = ~np.asarray(ns._mask_bound) & ~np.asarray(ns._mask_pin)
    assert np.max(np.abs(div[interior])) < 1e-9
    # BCs: u=1 on lid, zero elsewhere on walls
    lid = ns.grid.side_mask("N")
    np.testing.assert_allclose(np.asarray(u)[lid], 1.0, atol=1e-12)
    walls = np.asarray(ns._mask_bound) & ~lid
    np.testing.assert_allclose(np.asarray(u)[walls], 0.0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(v)[np.asarray(ns._mask_bound)], 0.0,
                               atol=1e-12)


def test_ns_uzawa_matches_coupled():
    """The structural-parity Uzawa path (nested Krylov, reference
    NavierStokes_Solver.py:162-236) and the coupled saddle path
    converge to the same solution."""
    kw = dict(Re=50.0, Gr=100.0, P=3, N_ex=3, N_ey=3, u_N=1.0,
              mtol=1e-11, mtol_newton=1e-9, iprint=[])
    sol = {}
    for ls in ("coupled", "uzawa"):
        ns = NavierStokesSolver(1.0, 1.0, linear_solver=ls, **kw)
        sol[ls] = [np.asarray(f) for f in ns._get_solution(
            jnp.asarray(0.3 * np.sin(np.pi * ns.points[0])))]
    for a, b, tol in zip(sol["coupled"], sol["uzawa"],
                         (1e-7, 1e-7, 1e-4)):  # p carries a ~20 scale
        np.testing.assert_allclose(a, b, atol=tol)


def test_ns_pcd_schur_update_solves_tangent_system():
    """schur_precon='pcd' converges the linear solve to the same tangent
    solution as the default mass preconditioner."""
    ns = NavierStokesSolver(1.0, 1.0, Re=50.0, Gr=10.0, P=3, N_ex=3, N_ey=3,
                            u_N=1.0, mtol=1e-10, mtol_newton=1e-9,
                            schur_precon="pcd", iprint=[])
    N = ns.N
    u, v, p, T = (RNG.standard_normal(N) * 0.1 for _ in range(4))
    ns._get_residuals(u, v, p, T)
    ns._calc_jacobians(u, v)
    bu, bv, bc = (RNG.standard_normal(N) for _ in range(3))
    du, dv, dp = ns._get_update(bu, bv, bc)
    ru, rv, rc = [np.asarray(r) for r in ns._get_dresiduals(du, dv, dp)]
    scale = np.sqrt(N)
    assert np.linalg.norm(ru - bu) / scale < 1e-7
    assert np.linalg.norm(rv - bv) / scale < 1e-7
    assert np.linalg.norm(rc - bc) / scale < 1e-6


def test_ns_spectral_schur_update_solves_tangent_system():
    """schur_precon='spectral' (default) solves the tangent system exactly
    like the reference-parity mass preconditioner does."""
    ns = NavierStokesSolver(1.0, 1.0, Re=50.0, Gr=10.0, P=3, N_ex=3, N_ey=3,
                            u_N=1.0, mtol=1e-10, mtol_newton=1e-9,
                            schur_precon="spectral", iprint=[])
    N = ns.N
    u, v, p, T = (RNG.standard_normal(N) * 0.1 for _ in range(4))
    ns._get_residuals(u, v, p, T)
    ns._calc_jacobians(u, v)
    bu, bv, bc = (RNG.standard_normal(N) for _ in range(3))
    du, dv, dp = ns._get_update(bu, bv, bc)
    ru, rv, rc = [np.asarray(r) for r in ns._get_dresiduals(du, dv, dp)]
    scale = np.sqrt(N)
    assert np.linalg.norm(ru - bu) / scale < 1e-7
    assert np.linalg.norm(rv - bv) / scale < 1e-7
    assert np.linalg.norm(rc - bc) / scale < 1e-6


def test_ns_spectral_schur_resolution_robust():
    """The 'spectral' Schur block keeps inner GMRES counts nearly flat under
    mesh refinement (<2× per 2× refinement),
    where the reference's diag-mass block degrades ~linearly in 1/h
    (measured 52→181 over 4× refinement, study/schur_spectrum.py)."""
    counts = {}
    for precon in ("spectral", "mass"):
        for Ne in (8, 16):
            ns = NavierStokesSolver(
                1.0, 1.0, Re=1e3, Gr=1e3 / 0.71, P=4, N_ex=Ne, N_ey=Ne,
                mtol=1e-9, mtol_newton=1e-7, schur_precon=precon, iprint=[])
            T = jnp.asarray(0.5 - ns.points[0])
            z = jnp.zeros(ns.N)
            ru, rv, rc = ns._get_residuals(z, z, z, T)
            ns._calc_jacobians(z, z)
            ns._get_update(-ru, -rv, -rc)
            counts[precon, Ne] = int(ns.last_schur_info.iterations)
    assert counts["spectral", 16] < 2 * counts["spectral", 8]
    # and it beats the mass block outright at the finer resolution
    assert counts["spectral", 16] < counts["mass", 16]


def test_ns_pure_f64_matches_mixed_precision():
    """mixed_precision=False (single-level f64 saddle GMRES) agrees with the
    default mixed-precision refinement path."""
    kw = dict(Re=50.0, Gr=100.0, P=3, N_ex=3, N_ey=3, u_N=1.0,
              mtol=1e-11, mtol_newton=1e-9, iprint=[])
    T = None
    sol = {}
    for mp in (True, False):
        ns = NavierStokesSolver(1.0, 1.0, mixed_precision=mp, **kw)
        if T is None:
            T = jnp.asarray(0.3 * np.sin(np.pi * ns.points[0]))
        sol[mp] = [np.asarray(f) for f in ns._get_solution(T)]
    for a, b, tol in zip(sol[True], sol[False],
                         (1e-7, 1e-7, 1e-5)):  # p carries a ~20 scale
        np.testing.assert_allclose(a, b, atol=tol)


def test_ns_velo_inner_flexible_mixed_parity():
    """``velo_inner=5`` routes the mixed path through the row-scaled
    right-preconditioned FLEXIBLE f32 chunks (inner FDM-preconditioned GMRES
    on the true velocity Jacobian inside every preconditioner application)
    and lands on the same solution as the default left-preconditioned plain
    chunks — parity within the Newton-convergence resolution."""
    kw = dict(Re=50.0, Gr=100.0, P=3, N_ex=3, N_ey=3, u_N=1.0,
              mtol=1e-11, mtol_newton=1e-9, iprint=[])
    T = None
    sol = {}
    for k in (0, 5):
        ns = NavierStokesSolver(1.0, 1.0, velo_inner=k, **kw)
        if T is None:
            T = jnp.asarray(0.3 * np.sin(np.pi * ns.points[0]))
        sol[k] = [np.asarray(f) for f in ns._get_solution(T)]
        assert ns.f64_fallback_count == 0
    for a, b, tol in zip(sol[0], sol[5], (1e-6, 1e-6, 1e-4)):
        np.testing.assert_allclose(a, b, atol=tol)


@pytest.mark.slow
def test_ns_re400_p8_f32_path_zero_fallbacks():
    """The Re=400 lid cavity at P=8 16×16 — the round-3 f32 stall case
    (plain chunks floor; 4 single-level f64 fallbacks) — converges entirely
    on the f32 mixed path via the flexible velo_inner=5 escalation
    (0 f64 fallbacks).  Also pins the
    no-progress rescue: without it the accepted zero-update stalls froze
    Newton at 3.3× target with bit-identical residuals."""
    ns = NavierStokesSolver(1.0, 1.0, Re=400.0, Gr=0.0, P=8, N_ex=16,
                            N_ey=16, u_N=1.0, mtol=1e-9, mtol_newton=1e-8,
                            iprint=[])
    u, v, p = ns._get_solution(jnp.zeros(ns.N))
    assert ns.f64_fallback_count == 0          # never left the f32 path
    assert ns.flex_retry_count >= 1            # the flexible ladder fired
    ru, rv, rc = ns._get_residuals(u, v, p, jnp.zeros(ns.N))
    rms = float(jnp.sqrt(jnp.vdot(ru, ru) + jnp.vdot(rv, rv)
                         + jnp.vdot(rc, rc))) / np.sqrt(3 * ns.N)
    assert rms <= 1e-8


def test_ns_solve_continued_matches_direct():
    """Standalone-NS p-continuation reaches the direct solution within the
    Newton tolerance with a warm-started fine level."""
    from sem_jax.models.navier_stokes import solve_ns_continued

    kw = dict(u_N=1.0, mtol=1e-12, mtol_newton=1e-11, iprint=[])
    ns_d = NavierStokesSolver(1.0, 1.0, Re=100.0, Gr=0.0, P=4, N_ex=4,
                              N_ey=4, **kw)
    u_d, v_d, _ = ns_d._get_solution(jnp.zeros(ns_d.N))
    ns_c, u_c, v_c, _ = solve_ns_continued(1.0, 1.0, Re=100.0, Gr=0.0,
                                           P=4, N_ex=4, N_ey=4, levels=1,
                                           **kw)
    # both land at rms residual ≲1e-11, but the equal-order discretization
    # carries near-spurious coupled modes along which a 1e-12 residual only
    # pins the iterate to ~1e-5 (measured: perturbations there change the
    # residual ~1e-7× their size) — compare at that physical resolution
    np.testing.assert_allclose(np.asarray(u_c), np.asarray(u_d), atol=5e-5)
    np.testing.assert_allclose(np.asarray(v_c), np.asarray(v_d), atol=5e-5)
    # the warm-started fine level does less Newton work than the direct one
    assert ns_c._k <= ns_d._k


@pytest.mark.slow
def test_ns_ghia_re100():
    """Lid cavity Re=100 at P=4, 8×8 matches the Ghia table to ~1e-3."""
    ns = NavierStokesSolver(1.0, 1.0, Re=100.0, Gr=0.0, P=4, N_ex=8, N_ey=8,
                            u_N=1.0, iprint=[])
    x_plot, y_plot = np.meshgrid(np.full(41, 0.5), np.linspace(0, 1, 41),
                                 indexing="ij")
    u_plot, _, _ = ns.run(lambda x, y: 0 * x, (x_plot, y_plot))
    ghia_y = np.array([0.0547, 0.1016, 0.2813, 0.4531, 0.5000, 0.7344])
    ghia_u = np.array([-0.03717, -0.06434, -0.15662, -0.21090, -0.20581,
                       0.00332])
    u_line = np.interp(ghia_y, y_plot[0], u_plot[0])
    assert np.max(np.abs(u_line - ghia_u)) < 5e-3


@pytest.mark.slow
def test_ns_ghia_re400():
    """Lid cavity at the reference example config (Re=400, P=4, 16×16 —
    reference Examples/NavierStokes_Example.py:15-29) matches the Ghia
    et al. (1982) Table I centerline values (pin the
    previously prose-only anchor in CI; measured deviation 4.3e-3)."""
    ns = NavierStokesSolver(1.0, 1.0, Re=400.0, Gr=0.0, P=4, N_ex=16,
                            N_ey=16, u_N=1.0, iprint=[])
    u, _, _ = ns._get_solution(jnp.zeros(ns.N))
    x_plot, y_plot = np.meshgrid(np.full(101, 0.5), np.linspace(0, 1, 101),
                                 indexing="ij")
    u_plot = ns._get_interpol(u, (x_plot, y_plot))
    ghia_y = np.array([0.0547, 0.1016, 0.2813, 0.4531, 0.5000, 0.7344])
    ghia_u = np.array([-0.08186, -0.14612, -0.32726, -0.17119, -0.11477,
                       0.16256])
    u_line = np.interp(ghia_y, y_plot[0], u_plot[0])
    assert np.max(np.abs(u_line - ghia_u)) < 1e-2


@pytest.mark.slow
def test_ns_ghia_re1000_ptc_mixed_path():
    """Re=1000 lid cavity through pseudo-transient continuation, entirely
    on the f32 mixed-precision path (the steady from-zero
    Newton at Re≥400 needed a full-f64 fallback; the σ-shifted PTC systems
    stay inside the mixed path's attainable range — asserted via the
    fallback counter).  Ghia et al. (1982) Re=1000 centerline anchor;
    measured deviation 0.021 at this (resolution-limited) grid."""
    ns = NavierStokesSolver(1.0, 1.0, Re=1000.0, Gr=0.0, P=4, N_ex=16,
                            N_ey=16, u_N=1.0, iprint=[])
    u, _, _ = ns.solve_ptc(jnp.zeros(ns.N))
    assert ns.f64_fallback_count == 0  # never left the mixed path
    x_plot, y_plot = np.meshgrid(np.full(101, 0.5), np.linspace(0, 1, 101),
                                 indexing="ij")
    u_plot = ns._get_interpol(u, (x_plot, y_plot))
    ghia_y = np.array([0.0547, 0.1016, 0.2813, 0.4531, 0.5000, 0.7344])
    ghia_u = np.array([-0.18109, -0.29730, -0.27805, -0.10648, -0.06080,
                       0.18719])
    u_line = np.interp(ghia_y, y_plot[0], u_plot[0])
    assert np.max(np.abs(u_line - ghia_u)) < 3.5e-2


def test_ns_lgmres_iter_prints_per_iteration(capsys):
    """'LGMRES_iter' emits per-iteration lines on the NS linear solve
    (reference NavierStokes_Solver.py:215-220)."""
    ns = NavierStokesSolver(1.0, 1.0, Re=10.0, Gr=0.0, P=3, N_ex=2, N_ey=2,
                            u_N=1.0, mtol=1e-9, mtol_newton=1e-8,
                            iprint=["LGMRES_iter"])
    ns._get_solution(jnp.zeros(ns.N))
    out = capsys.readouterr().out
    lines = [l for l in out.splitlines()
             if l.startswith("NavierStokes LGMRES: ")]
    assert len(lines) >= 2


def test_best_effort_update_skips_f64_escalation(monkeypatch):
    """``_get_update(best_effort=True)`` (preconditioner applications inside
    a flexible outer Krylov loop) must return the floored mixed-precision
    iterate without the single-level f64 retry and without raising; the
    default path must still escalate.  The dispatch is pinned with a
    monkeypatched mixed path so the test stays cheap (the real trigger is a
    convection-dominated tangent block, measured at Ra=1e7 p16 — each f64
    escalation there costs minutes)."""
    from sem_jax.krylov import KrylovInfo

    ns = NavierStokesSolver(1.0, 1.0, Re=50.0, Gr=0.0, P=3, N_ex=3, N_ey=3,
                            u_N=1.0, iprint=[])
    z = jnp.zeros(ns.N)
    floored = KrylovInfo(converged=jnp.asarray(False),
                         iterations=jnp.asarray(7, jnp.int32),
                         resnorm=jnp.asarray(1e3),   # far above any atol
                         stalled=jnp.asarray(True))
    ok = KrylovInfo(converged=jnp.asarray(True),
                    iterations=jnp.asarray(3, jnp.int32),
                    resnorm=jnp.asarray(0.0), stalled=jnp.asarray(False))
    mixed_calls = []
    monkeypatch.setattr(ns, "_update_coupled_mixed",
                        lambda *a, **k: mixed_calls.append(k) or
                        (z, z, z, floored, ok))
    f64_calls = []
    monkeypatch.setattr(ns, "_update_jit",
                        lambda *a: f64_calls.append(1) or
                        (z, z, z, ok, ok, jnp.zeros(4)))

    b = jnp.ones(ns.N)
    ns._get_update(b, b, b, mtol=1e-6, best_effort=True)
    assert not f64_calls                      # no f64 escalation
    assert ns.besteffort_floor_count == 1
    assert ns.f64_fallback_count == 0
    assert ns.flex_retry_count == 0           # best-effort: no retries at all

    ns._get_update(b, b, b, mtol=1e-6)        # default: escalates
    # escalation ladder: flexible velo_inner=5 f32 retry first, f64 second
    assert ns.flex_retry_count == 1
    assert any(k.get("velo_inner") == 5 for k in mixed_calls)
    assert f64_calls
    assert ns.f64_fallback_count == 1


def test_ns_lin32_cache_invalidates_on_relinearization():
    """The cached f32 casts of the linearization (``_lin32``, one dispatch
    set per linearization instead of per discipline solve) must refresh
    when _calc_jacobians stores new fields — a stale cache would silently
    precondition with the PREVIOUS Newton iterate's operator."""
    ns = NavierStokesSolver(1.0, 1.0, Re=50.0, Gr=10.0, P=3, N_ex=3, N_ey=3,
                            u_N=1.0, mtol=1e-10, mtol_newton=1e-9, iprint=[])
    N = ns.N
    u1 = jnp.asarray(RNG.standard_normal(N) * 0.1)
    ns._calc_jacobians(u1, u1)
    ul32_a, _, jac32_a, sig_a = ns._lin32()
    assert ns._lin32()[0] is ul32_a          # second call: cache hit
    np.testing.assert_allclose(np.asarray(ul32_a),
                               np.asarray(ns._u_lin).astype(np.float32))

    u2 = jnp.asarray(RNG.standard_normal(N) * 0.1)
    ns._calc_jacobians(u2, u2, sigma=3.0)    # new linearization + shift
    ul32_b, _, jac32_b, sig_b = ns._lin32()
    assert ul32_b is not ul32_a
    np.testing.assert_allclose(np.asarray(ul32_b),
                               np.asarray(ns._u_lin).astype(np.float32))
    assert float(sig_b) == np.float32(3.0)
    assert any(np.any(np.asarray(a) != np.asarray(b))
               for a, b in zip(jac32_a, jac32_b))
