"""Coupling-layer tests: cross-mesh transfer exactness, MDA mode agreement,
the de Vahl Davis benchmark (SURVEY.md §7.2 step 7 acceptance)."""
import numpy as np
import pytest
import jax.numpy as jnp

from sem_jax.interp import apply_transfer
from sem_jax.mesh import Grid2D
from sem_jax.coupling import run, build_coupled

# de Vahl Davis (1983) at Ra=1e3, Pr=0.71
DVD_UMAX, DVD_VMAX = 3.649, 3.697


def test_transfer_reproduces_polynomials():
    """Re-basis between grids of different (P, N_e) is exact for polynomials
    up to the source order."""
    src = Grid2D(P=4, N_ex=3, N_ey=2, L_x=1.0, L_y=2.0)
    dst = Grid2D(P=3, N_ex=5, N_ey=4, L_x=1.0, L_y=2.0)
    xs, ys = src.points
    f = 1.0 + xs**3 - 2 * ys**2 + xs * ys
    got = np.asarray(apply_transfer(src, dst, jnp.asarray(f)))
    xd, yd = dst.points
    expect = 1.0 + xd**3 - 2 * yd**2 + xd * yd
    np.testing.assert_allclose(got, expect, rtol=1e-11, atol=1e-12)


def test_transfer_roundtrip_same_grid_identity():
    g = Grid2D(P=3, N_ex=2, N_ey=2, L_x=1.0, L_y=1.0)
    f = np.random.default_rng(3).standard_normal(g.N)
    got = np.asarray(apply_transfer(g, g, jnp.asarray(f)))
    np.testing.assert_allclose(got, f, atol=1e-12)


QUICK = dict(Re=1e3, Ra=1e3, Pr=0.71, P_cd=3, N_ex_cd=3, N_ey_cd=3,
             P_ns=3, N_ex_ns=3, N_ey_ns=3, iprint=False)

PLOT21 = np.meshgrid(np.linspace(0, 1, 21), np.linspace(0, 1, 21),
                     indexing="ij")


@pytest.fixture(scope="module")
def gs_reference():
    """Reference coupled solution (GS mode), computed once per module so
    every parametrized mode compares against the same fields regardless of
    execution order or -k selection."""
    return run(PLOT21, 1.0, 1.0, mode="GS", **QUICK)


@pytest.mark.parametrize("mode", ["NJ", "JNK"])
def test_mda_modes_agree(mode, gs_reference):
    """All three coupling modes converge to the same coupled solution."""
    T0, u0, v0 = gs_reference
    T, u, v = run(PLOT21, 1.0, 1.0, mode=mode, **QUICK)
    np.testing.assert_allclose(T, T0, atol=1e-7)
    np.testing.assert_allclose(u, u0, atol=1e-8)
    np.testing.assert_allclose(v, v0, atol=1e-8)


def test_jnk_forcing_matches_reference_tolerance_path(gs_reference):
    """JNK with inexact-Newton forcing (default) and with the reference's
    fixed-tolerance coupled GMRES (forcing=None) converge to the same
    solution; forcing never does more total coupled GMRES work."""
    T0, u0, v0 = gs_reference
    gmres_its = {}
    for forcing in (1e-3, None):
        cd, ns, mda = build_coupled(1.0, 1.0, mode="JNK", forcing=forcing,
                                    **QUICK)
        s = mda.solve()
        gmres_its[forcing] = mda.stats.gmres_iters
        T = cd._get_interpol(s.T, PLOT21)
        np.testing.assert_allclose(T, T0, atol=1e-7)
    assert gmres_its[1e-3] <= gmres_its[None]


def test_jnk_device_matches_host_krylov(gs_reference):
    """The on-device coupled FGMRES (one dispatch per window, inner block
    solves included) reproduces the host-orchestrated NumPy FGMRES."""
    T0, u0, v0 = gs_reference
    for device in (True, False):
        T, u, v = run(PLOT21, 1.0, 1.0, mode="JNK",
                      device_krylov=device, **QUICK)
        np.testing.assert_allclose(T, T0, atol=1e-7)
        np.testing.assert_allclose(u, u0, atol=1e-8)
        np.testing.assert_allclose(v, v0, atol=1e-8)


def test_host_fgmres_fused_matches_unfused():
    """The fused host-FGMRES path (one program + one scalar readback per
    coupled iteration: matvec + CGS2 + on-device Givens) reproduces the
    un-fused reference loop on the SAME coupled tangent system — same
    solution to roundoff and the same iteration count."""
    from sem_jax.coupling.mda import _fgmres, CoupledState

    cd, ns, mda = build_coupled(1.0, 1.0, mode="JNK", **QUICK)
    z = jnp.zeros(mda.N_cd)
    zn = jnp.zeros(mda.N_ns)
    s = mda._gs_sweep(CoupledState(z, zn, zn, zn), mtol=1e-4)
    mda._linearize(s)
    F = mda._residuals(s)
    atol = 1e-9 * float(np.sqrt(mda.DOF))

    precon = lambda r: mda._block_jacobi(r, mtol=1e-4, best_effort=True)
    x_ref, it_ref, ok_ref = _fgmres(
        mda._apply_linear, precon, -F, atol=atol,
        restart=mda.restart, maxiter=200)
    fused = mda._fg_fused(mtol=1e-4)
    assert fused is not None
    x_f, it_f, ok_f = _fgmres(
        None, None, -F, atol=atol,
        restart=mda.restart, maxiter=200, fused=fused)

    assert ok_ref and ok_f
    assert it_f == it_ref
    np.testing.assert_allclose(np.asarray(x_f), np.asarray(x_ref),
                               rtol=1e-10, atol=1e-12 * atol)
    # TRUE residuals agree (the recurrence's f32-basis floor sits above
    # atol here — identical in both paths, so compare, don't bound)
    rn_f = float(jnp.linalg.norm(-F - mda._apply_linear(x_f)))
    rn_ref = float(jnp.linalg.norm(-F - mda._apply_linear(x_ref)))
    assert rn_f <= 1.01 * rn_ref + 1e-13


def test_fused_pc_matches_host_pc(monkeypatch):
    """The one-dispatch fused block-Jacobi/BGS preconditioner application
    (SEM_JAX_FUSED_PC=1, fixed two-round best-effort policy) and the
    host-orchestrated adaptive refinement (=0) drive the host coupled
    FGMRES to the same solution — a preconditioner difference may shift
    iteration counts slightly but never the converged state."""
    monkeypatch.setenv("SEM_JAX_DEVICE_KRYLOV_MAX_DOF", "0")  # host path
    sols = {}
    for pc in ("1", "0"):
        monkeypatch.setenv("SEM_JAX_FUSED_PC", pc)
        cd, ns, mda = build_coupled(1.0, 1.0, mode="JNK", **QUICK)
        s = mda.solve()
        sols[pc] = np.asarray(s.u)
        assert mda.stats.nonlinear_iters <= 6
    np.testing.assert_allclose(sols["1"], sols["0"], atol=1e-7)


def test_mda_different_disciplinary_resolutions():
    """CD and NS run at different (P, N_e) like the study harness
    (reference study/Boussinesq_run.py:50-51: CD at N_e/2)."""
    x_plot, y_plot = np.meshgrid(np.linspace(0, 1, 21),
                                 np.linspace(0, 1, 21), indexing="ij")
    T, u, v = run((x_plot, y_plot), 1.0, 1.0, Re=1e3, Ra=1e3, Pr=0.71,
                  P_cd=3, N_ex_cd=2, N_ey_cd=2,
                  P_ns=3, N_ex_ns=4, N_ey_ns=4,
                  mode="JNK", iprint=False)
    umax = np.max(u) * 1e3 * 0.71
    assert abs(umax - DVD_UMAX) / DVD_UMAX < 0.05


def test_unknown_mode_raises():
    with pytest.raises(ValueError):
        build_coupled(1.0, 1.0, mode="XX")


def test_host_fgmres_matches_scipy_restarted():
    """The padded device-buffer host FGMRES must agree with SciPy's GMRES
    under identical restart budgets (guards the Arnoldi index wiring: a
    broken subdiagonal degrades it into a Richardson iteration that still
    converges through the outer true-residual check — invisible end-to-end,
    so pin the per-window algebra directly)."""
    from scipy.sparse.linalg import gmres as sp_gmres
    from sem_jax.coupling.mda import _fgmres

    rng = np.random.default_rng(0)
    n = 200
    A = np.eye(n) * 4 + 0.1 * rng.standard_normal((n, n))
    b = rng.standard_normal(n)
    atol = 1e-10 * np.linalg.norm(b)

    x, it, ok = _fgmres(lambda v: jnp.asarray(A) @ v, lambda r: r,
                        jnp.asarray(b), atol=atol, restart=10, maxiter=100)
    assert ok
    assert np.linalg.norm(A @ np.asarray(x) - b) <= 10 * atol
    # well-conditioned system: a correct GMRES(10) needs only a few windows
    # (the default f32 basis costs a couple of extra refinement-style
    # windows relative to f64 on this deep 1e-10 target)
    assert it <= 60

    # exact agreement with SciPy on a hard (stagnating) system: any wiring
    # error in the Hessenberg/Givens recurrence breaks this to all digits.
    # Algebra pinned with the f64 basis — the f32 default differs from
    # SciPy in roundoff, not wiring.
    # (two windows only — beyond that _fgmres correctly stall-exits where
    # SciPy keeps grinding, which the assertion below pins)
    A2 = np.eye(n) + 0.1 * rng.standard_normal((n, n))
    x_sp, _ = sp_gmres(A2, b, rtol=1e-10, restart=10, maxiter=2)
    x2, _, _ = _fgmres(lambda v: jnp.asarray(A2) @ v, lambda r: r,
                       jnp.asarray(b), atol=atol, restart=10, maxiter=20,
                       basis_dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(x2), x_sp, rtol=1e-9, atol=1e-12)
    # the f32-basis default reaches the same solution to f32-level accuracy
    x2_lp, _, _ = _fgmres(lambda v: jnp.asarray(A2) @ v, lambda r: r,
                          jnp.asarray(b), atol=atol, restart=10, maxiter=20)
    np.testing.assert_allclose(np.asarray(x2_lp), x_sp, rtol=2e-4, atol=1e-7)

    # stall detection: a flat window (<2% estimated progress) followed by a
    # <2% true-residual restart must exit early with ok=False instead of
    # burning the full budget (measured: Ra=1e7 PTC steps sat >100 flat
    # iterations before this exit existed)
    x3, it3, ok3 = _fgmres(lambda v: jnp.asarray(A2) @ v, lambda r: r,
                           jnp.asarray(b), atol=atol, restart=10,
                           maxiter=1000)
    assert not ok3
    assert it3 <= 60


def test_solve_continued_matches_direct():
    """p-continuation (coarse-order warm starts) reaches the same solution
    as a direct solve within the coupled tolerance, with strictly less
    fine-level work."""
    from sem_jax.coupling.boussinesq import solve_continued

    kw = dict(Re=1e3, Ra=1e3, Pr=0.71, N_ex_cd=4, N_ey_cd=4,
              N_ex_ns=4, N_ey_ns=4, mode="JNK", mtol_nonlin=1e-9,
              iprint=False)
    cd, ns, mda = build_coupled(1.0, 1.0, P_cd=4, P_ns=4, **kw)
    s_direct = mda.solve()
    direct_solves = mda.stats.cd_solves + mda.stats.ns_solves

    cd2, ns2, mda2, s_cont = solve_continued(1.0, 1.0, levels=1,
                                             P_cd=4, P_ns=4, **kw)
    cont_fine_solves = mda2.stats.cd_solves + mda2.stats.ns_solves
    np.testing.assert_allclose(np.asarray(s_cont.u), np.asarray(s_direct.u),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(s_cont.T), np.asarray(s_direct.T),
                               atol=1e-6)
    assert cont_fine_solves < direct_solves

    # explicit ladder override (skips intermediate orders)
    cd3, ns3, mda3, s_lad = solve_continued(1.0, 1.0,
                                            ladder=[(2, 2), (4, 4)],
                                            P_cd=4, P_ns=4, **kw)
    np.testing.assert_allclose(np.asarray(s_lad.u), np.asarray(s_direct.u),
                               atol=1e-6)


@pytest.mark.slow
def test_solve_ra_continued_high_ra():
    """Ra continuation reaches a high-Ra solution (from-zero solves fail
    beyond Ra~1e4: the iteration-0 subsystem sweep's NS solve is
    convection-dominated past what the FDM-preconditioned Krylov handles)."""
    from sem_jax.coupling.boussinesq import solve_ra_continued

    cd, ns, mda, s = solve_ra_continued(1.0, 1.0, Ra=1e4, decades=1,
                                        Re=1e3, Pr=0.71,
                                        P_cd=3, N_ex_cd=2, N_ey_cd=2,
                                        P_ns=3, N_ex_ns=4, N_ey_ns=4,
                                        mode="JNK", iprint=False)
    # converged to the MDA tolerance at the target Ra
    r = mda._residuals(s)
    assert np.linalg.norm(r) <= mda.atol_nonlin
    # buoyancy-driven flow much stronger than at Ra=1e3
    assert float(np.max(np.abs(np.asarray(s.u)))) * 1e3 * 0.71 > 8.0


@pytest.mark.slow
def test_de_vahl_davis_ra_1e4():
    """Ra=1e4 from zero (JNK) lands on the de Vahl Davis (1983) benchmark
    u_max·RePr = 16.18 (pin the previously prose-only
    Ra=1e4 anchor in CI; measured 16.204 at this grid, 0.15%)."""
    from sem_jax.coupling.boussinesq import build_coupled

    cd, ns, mda = build_coupled(1.0, 1.0, Re=1e3, Ra=1e4, Pr=0.71,
                                P_cd=4, N_ex_cd=8, N_ey_cd=8,
                                P_ns=4, N_ex_ns=16, N_ey_ns=16,
                                mode="JNK", mtol_nonlin=1e-9, iprint=False)
    s = mda.solve()
    umax = float(jnp.max(jnp.abs(s.u))) * 1e3 * 0.71
    assert abs(umax - 16.18) / 16.18 < 0.01, umax


@pytest.mark.slow
def test_de_vahl_davis_benchmark():
    """Full reference configuration: Ra=1e3, P=4, 8×8, JNK (reference
    Examples/Boussinesq_Sequential_Example.py), validated against the
    de Vahl Davis (1983) values."""
    x_plot, y_plot = np.meshgrid(np.linspace(0, 1, 101),
                                 np.linspace(0, 1, 101), indexing="ij")
    T, u, v, state, stats = run((x_plot, y_plot), 1.0, 1.0,
                                Re=1e3, Ra=1e3, Pr=0.71,
                                P_cd=4, N_ex_cd=8, N_ey_cd=8,
                                P_ns=4, N_ex_ns=8, N_ey_ns=8,
                                mode="JNK", iprint=False, return_state=True)
    umax = np.max(u) * 1e3 * 0.71
    vmax = np.max(v) * 1e3 * 0.71
    assert abs(umax - DVD_UMAX) / DVD_UMAX < 0.01, umax
    assert abs(vmax - DVD_VMAX) / DVD_VMAX < 0.01, vmax
    assert stats.nonlinear_iters <= 6


def test_dispatch_threshold_env_knobs(monkeypatch):
    """The dispatch-size thresholds are env-overridable
    (README "Environment knobs"): device_krylov auto-selection honors
    SEM_JAX_DEVICE_KRYLOV_MAX_DOF, and a tiny JNK solve still converges
    with both the window size and threshold overridden."""
    from sem_jax.coupling import mda as mda_mod

    # default auto: QUICK's DOF (~few hundred) is far below 1e6 -> device
    cd, ns, mda = build_coupled(1.0, 1.0, mode="JNK", **QUICK)
    assert mda.device_krylov
    # force the auto-threshold below this problem's DOF -> host path
    monkeypatch.setenv("SEM_JAX_DEVICE_KRYLOV_MAX_DOF", "1")
    cd, ns, mda_host = build_coupled(1.0, 1.0, mode="JNK", **QUICK)
    assert not mda_host.device_krylov
    assert mda_host.DOF == mda.DOF > 1
    # explicit request still wins over the env auto-threshold
    cd, ns, mda_exp = build_coupled(1.0, 1.0, mode="JNK",
                                    device_krylov=True, **QUICK)
    assert mda_exp.device_krylov
    # solve end-to-end with a non-default fused window: same solution as
    # the default window (windows are warm-started -> size-independent)
    ref = mda.solve()
    monkeypatch.setenv("SEM_JAX_FUSED_WINDOW", "3")
    monkeypatch.setenv("SEM_JAX_PTC_DEVICE_MAX_DOF", "0")
    state = mda_exp.solve()
    np.testing.assert_allclose(np.asarray(state.u), np.asarray(ref.u),
                               atol=1e-7)


def test_fgmres_forecast_exit():
    """The convergence-forecast exit (mda._forecast_doomed): a solve whose
    most optimistic recent contraction rate cannot reach atol within 1.5x
    the remaining budget returns early with the partial iterate (the Ra=1e8
    p16 PTC probes ground a 240-iteration effort cap at ~0.06%/iteration --
    real progress, so the plateau tests never fired)."""
    from sem_jax.coupling.mda import _fgmres, _forecast_doomed

    # helper semantics on synthetic geometric histories
    slow = [0.6 * 0.9994 ** k for k in range(80)]     # ~0.06%/it
    assert _forecast_doomed(slow, atol=0.024, remaining=160)
    fast = [0.6 * 0.9 ** k for k in range(80)]        # 10%/it: fine
    assert not _forecast_doomed(fast, atol=1e-8, remaining=160)
    # too little history: never fires
    assert not _forecast_doomed(slow[:50], atol=0.024, remaining=200)
    # stalled-but-short remaining budget: the plateau tests own that case,
    # but the forecast must still report doomed on a non-converging tail
    flat = [0.6] * 80
    assert _forecast_doomed(flat, atol=0.024, remaining=10)

    # end-to-end: forecast=True must not perturb a healthy solve
    rng = np.random.default_rng(0)
    n = 200
    A = np.eye(n) * 4 + 0.1 * rng.standard_normal((n, n))
    b = rng.standard_normal(n)
    atol = 1e-10 * np.linalg.norm(b)
    x_ref, it_ref, ok_ref = _fgmres(lambda v: jnp.asarray(A) @ v,
                                    lambda r: r, jnp.asarray(b),
                                    atol=atol, restart=10, maxiter=100)
    x_fc, it_fc, ok_fc = _fgmres(lambda v: jnp.asarray(A) @ v,
                                 lambda r: r, jnp.asarray(b),
                                 atol=atol, restart=10, maxiter=100,
                                 forecast=True)
    assert ok_fc and it_fc == it_ref
    np.testing.assert_allclose(np.asarray(x_fc), np.asarray(x_ref))


def test_bgs2_symmetric_precon():
    """The 'bgs2' symmetric block-Gauss-Seidel preconditioner (CD → NS →
    CD re-solve against the velocity-advection coupling J_{T,(u,v)}):

    * end-to-end PTC (device-Krylov path → _build_jnk_cycle's bgs2 branch)
      reaches the same steady state as 'bgs' — a preconditioner never moves
      the fixed point — and here in no more coupled iterations;
    * the fused one-dispatch application (_build_pc_fused 'b2' flavor) and
      the host-orchestrated _block_jacobi_split agree on the same residual
      (policy differences only: fixed two-round vs adaptive refinement).
    """
    from sem_jax.coupling.mda import CoupledState

    KW = dict(Re=1e3, Ra=1e4, Pr=0.71, P_cd=3, N_ex_cd=2, N_ey_cd=2,
              P_ns=3, N_ex_ns=4, N_ey_ns=4, mode="PTC", mtol_nonlin=1e-8,
              iprint=False, ptc_dt0=0.5)
    cd, ns, mda = build_coupled(1.0, 1.0, precon="bgs", **KW)
    s_ref = mda.solve()
    its_ref = mda.stats.as_list()
    cd, ns, mda2 = build_coupled(1.0, 1.0, precon="bgs2", **KW)
    s2 = mda2.solve()
    np.testing.assert_allclose(np.asarray(s2.u), np.asarray(s_ref.u),
                               atol=2e-7)
    np.testing.assert_allclose(np.asarray(s2.T), np.asarray(s_ref.T),
                               atol=2e-7)
    # the symmetric sweep must not be WEAKER than one-directional bgs on
    # this strongly-coupled config (measured: 72 vs 135 discipline solves)
    assert mda2.stats.as_list()[0] <= its_ref[0]

    # fused vs host application parity at a nontrivial linearization
    z = jnp.zeros(mda2.N_cd)
    zn = jnp.zeros(mda2.N_ns)
    s = mda2._gs_sweep(CoupledState(z, zn, zn, zn), mtol=1e-4)
    mda2._linearize(s, sigma_cd=7.1, sigma_ns=10.0)
    F = mda2._residuals(s)
    rT, ru, rv, rp = mda2._unpack(-F)
    host = mda2._block_jacobi_split(rT, ru, rv, rp, mtol=1e-6,
                                    best_effort=True)
    fpc = mda2._pc_fused(mtol=1e-6)
    assert fpc is not None
    fused = fpc(rT, ru, rv, rp)
    for h, f in zip(host, fused):
        h, f = np.asarray(h), np.asarray(f)
        assert (np.linalg.norm(h - f)
                <= 5e-3 * np.linalg.norm(h) + 1e-12)


def test_bgs2_rejected_for_bad_precon_name():
    with pytest.raises(ValueError):
        build_coupled(1.0, 1.0, mode="PTC", precon="bogus", **QUICK)
