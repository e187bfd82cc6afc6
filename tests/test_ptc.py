"""Pseudo-transient continuation (PTC) and mass-shift (sigma) tests.

PTC is the round-3 capability that breaks the high-Rayleigh ceiling
(from-zero JNK diverges above Ra≈1e4 and the coupled
GMRES flat-lines at Ra=1e5; the reference's PETSc GMRES + LinearBlockJac is
the same algorithm).  The shift machinery is shared: solver Jacobian
diagonals carry σ·diag(M), the FDM preconditioner solves (K + (α+σ)M), and
the spectral Schur block matches (λ̂+σ)/ε — all with *traced* σ, so ramping
Δt never recompiles.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from sem_jax.fdm import FDM2D
from sem_jax.mesh import Grid2D

RNG = np.random.default_rng(11)


def test_fdm_traced_sigma_matches_static_alpha():
    """FDM2D(alpha=0)(r, sigma=s) == FDM2D(alpha=s)(r): the traced-shift
    path solves exactly the statically-shifted system."""
    grid = Grid2D(P=4, N_ex=4, N_ey=3, L_x=1.0, L_y=2.0)
    r = jnp.asarray(RNG.standard_normal(grid.N))
    s = 7.3
    fdm0 = FDM2D(grid)
    fdm_s = FDM2D(grid, alpha=s)
    got = np.asarray(fdm0(r, sigma=jnp.asarray(s)))
    ref = np.asarray(fdm_s(r))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-13)


def test_ns_sigma_shift_is_mass_diagonal():
    """The σ-linearized NS tangent differs from the steady tangent by
    exactly σ·M on the (u,u)/(v,v) blocks (non-Dirichlet rows only)."""
    from sem_jax.models.navier_stokes import NavierStokesSolver

    ns = NavierStokesSolver(1.0, 1.0, Re=50.0, Gr=0.0, P=3, N_ex=4, N_ey=4,
                            iprint=[])
    u = jnp.asarray(RNG.standard_normal(ns.N))
    v = jnp.asarray(RNG.standard_normal(ns.N))
    du = jnp.asarray(RNG.standard_normal(ns.N))
    dv = jnp.asarray(RNG.standard_normal(ns.N))
    dp = jnp.asarray(RNG.standard_normal(ns.N))
    sigma = 3.7

    ns._calc_jacobians(u, v)
    d0 = ns._get_dresiduals(du, dv, dp)
    ns._calc_jacobians(u, v, sigma=sigma)
    d1 = ns._get_dresiduals(du, dv, dp)

    md = ns.grid.mass_diag
    free = ~np.asarray(ns._mask_bound)
    np.testing.assert_allclose(np.asarray(d1[0] - d0[0])[free],
                               (sigma * md * np.asarray(du))[free],
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(d1[1] - d0[1])[free],
                               (sigma * md * np.asarray(dv))[free],
                               rtol=1e-9, atol=1e-12)
    # continuity rows and Dirichlet rows are unshifted
    np.testing.assert_allclose(np.asarray(d1[2]), np.asarray(d0[2]),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.asarray(d1[0] - d0[0])[~free], 0.0,
                               atol=1e-14)


def test_cd_sigma_shift_is_mass_diagonal():
    """Same property for the CD T-block tangent."""
    from sem_jax.models.convection_diffusion import ConvectionDiffusionSolver

    cd = ConvectionDiffusionSolver(1.0, 1.0, Pe=10.0, P=3, N_ex=4, N_ey=4,
                                   T_W=0.5, T_E=-0.5)
    u = jnp.asarray(RNG.standard_normal(cd.N))
    v = jnp.asarray(RNG.standard_normal(cd.N))
    dT = jnp.asarray(RNG.standard_normal(cd.N))
    cd._get_residuals(jnp.zeros(cd.N), u, v)
    sigma = 2.1

    cd._calc_jacobians(jnp.zeros(cd.N))
    d0 = cd._get_dresiduals(dT)
    cd._calc_jacobians(jnp.zeros(cd.N), sigma=sigma)
    d1 = cd._get_dresiduals(dT)

    md = cd.grid.mass_diag
    free = ~np.asarray(cd._mask_dir)
    np.testing.assert_allclose(np.asarray(d1 - d0)[free],
                               (sigma * md * np.asarray(dT))[free],
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(d1 - d0)[~free], 0.0, atol=1e-14)


def test_ser_controller_semantics():
    """Unit-pins the shared Δt controller (one implementation for the NS and
    MDA PTC loops): SER ramp with growth/shrink caps, blowup
    damping, the linear-failure shrink, and the trust-region ceiling with
    its relaxation."""
    from sem_jax.ptc import SERController

    c = SERController(1.0, growth=3.0, dt_max=100.0)
    # healthy 2x progress: dt *= 2
    c.accept(1.0, 0.5, lin_failed=False)
    assert c.dt == pytest.approx(2.0)
    # huge progress is growth-capped at 3x
    c.accept(1.0, 1e-9, lin_failed=False)
    assert c.dt == pytest.approx(6.0)
    # regression (residual up 100x) is shrink-capped at 10x
    c.accept(1.0, 100.0, lin_failed=False)
    assert c.dt == pytest.approx(0.6)
    # blowup: reject, damp 10x, state caller-side unchanged
    assert c.reject_blowup()
    assert c.dt == pytest.approx(0.06)
    # linear failure + no progress: cut 4x AND ceiling at half the failing dt
    c.accept(1.0, 0.99, lin_failed=True)
    assert c.dt == pytest.approx(0.015)
    assert c.dt_ceil == pytest.approx(0.03)
    # healthy steps relax the ceiling CEIL_RELAX x (1.25 since round 5:
    # 1.5 re-probed the uncrackable Ra=1e8 band every ~3 steps) and SER
    # growth respects it
    c.accept(1.0, 1e-9, lin_failed=False)
    assert c.dt == pytest.approx(0.03 * SERController.CEIL_RELAX)
    assert c.dt_ceil == pytest.approx(0.03 * SERController.CEIL_RELAX)
    # a linear failure WITH progress keeps SER but still lowers the ceiling
    c.accept(1.0, 0.5, lin_failed=True)
    assert c.dt_ceil == pytest.approx(0.015 * SERController.CEIL_RELAX)
    assert c.dt == pytest.approx(0.015 * SERController.CEIL_RELAX)
    # dt_min floors the collapse and reject_blowup reports death below it
    c2 = SERController(1e-10)
    assert not c2.reject_blowup()
    # lin-fail rejection: damp 4x AND ceiling at half the failing dt
    c3 = SERController(1.0, dt_max=100.0)
    assert c3.reject_linfail()
    assert c3.dt == pytest.approx(0.25)
    assert c3.dt_ceil == pytest.approx(0.5)
    c4 = SERController(1e-10)
    assert not c4.reject_linfail()


def test_ptc_matches_jnk_at_moderate_ra():
    """PTC from zero lands on the same steady state as JNK (Ra=1e4,
    coarse grid): the shift vanishes as Δt→∞, so the converged answer
    satisfies the identical steady tolerances."""
    from sem_jax.coupling.boussinesq import build_coupled

    kw = dict(Re=1e3, Ra=1e4, Pr=0.71, P_cd=3, N_ex_cd=4, N_ey_cd=4,
              P_ns=3, N_ex_ns=8, N_ey_ns=8, mtol_nonlin=1e-8, iprint=False)
    cd, ns, mda_j = build_coupled(1.0, 1.0, mode="JNK", **kw)
    s_jnk = mda_j.solve()
    cd, ns, mda_p = build_coupled(1.0, 1.0, mode="PTC", **kw)
    s_ptc = mda_p.solve()

    # both converged to the same steady state (state agreement is bounded by
    # ‖J⁻¹‖·atol — the residual tolerance 1e-8·√DOF admits ~1e-5 in state)
    assert np.linalg.norm(mda_p._residuals(s_ptc)) <= mda_p.atol_nonlin
    np.testing.assert_allclose(np.asarray(s_ptc.u), np.asarray(s_jnk.u),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(s_ptc.T), np.asarray(s_jnk.T),
                               atol=1e-4)


def test_ptc_fused_host_fgmres_matches_unfused_under_shift():
    """The fused host-FGMRES step (one program per coupled iteration) is
    exactly equivalent to the un-fused loop on a PTC-SHIFTED tangent
    system (σ > 0 — covers the mass-shift plumbing through the fused
    matvec, which the steady JNK equivalence test cannot).

    March-level host-vs-device equality is deliberately NOT asserted:
    inexact-Newton directions differ between the two preconditioner
    stacks, and on this coarse grid the pseudo-trajectories can select
    different discrete roots (measured: at Ra=1e3, Δt₀=1 the host march
    converges to rms 8e-9 on a state with u ~40× the physical anchor —
    fused and un-fused bit-identically)."""
    from sem_jax.coupling.boussinesq import build_coupled
    from sem_jax.coupling.mda import _fgmres, CoupledState

    kw = dict(Re=1e3, Ra=1e4, Pr=0.71, P_cd=3, N_ex_cd=4, N_ey_cd=4,
              P_ns=3, N_ex_ns=8, N_ey_ns=8, mtol_nonlin=1e-8, iprint=False)
    cd, ns, mda = build_coupled(1.0, 1.0, mode="PTC",
                                device_krylov=False, **kw)
    z = jnp.zeros(mda.N_cd)
    zn = jnp.zeros(mda.N_ns)
    s = mda._gs_sweep(CoupledState(z, zn, zn, zn), mtol=1e-4)
    dt = 0.25
    mda._linearize(s, sigma_cd=mda.cd_comp.cd._Pe / dt,
                   sigma_ns=mda.ns_comp.ns._Re / dt)
    F = mda._residuals(s)
    atol = 1e-2 * float(jnp.linalg.norm(F))

    precon = lambda r: mda._block_jacobi(r, mtol=1e-4, best_effort=True)
    x_ref, it_ref, ok_ref = _fgmres(mda._apply_linear, precon, -F,
                                    atol=atol, restart=mda.restart,
                                    maxiter=100)
    fused = mda._fg_fused(mtol=1e-4)
    x_f, it_f, ok_f = _fgmres(None, None, -F, atol=atol,
                              restart=mda.restart, maxiter=100, fused=fused)
    assert ok_ref and ok_f
    assert it_f == it_ref
    np.testing.assert_allclose(np.asarray(x_f), np.asarray(x_ref),
                               rtol=1e-10, atol=1e-14)


@pytest.mark.slow
def test_ptc_reaches_ra_1e5_from_zero():
    """The round-3 headline: steady Ra=1e5 from zero via PTC — beyond both
    the round-2 ceiling (Ra≈3.2e4 via warm-started ladders) and the
    reference's algorithm.  The v-velocity anchor lands on the de Vahl
    Davis (1983) benchmark value v_max·RePr ≈ 68.59 (the domain maximum of
    v is attained at the horizontal centerline where the benchmark reports
    it; even this coarse grid resolves it to ~0.05%)."""
    from sem_jax.coupling.boussinesq import build_coupled

    cd, ns, mda = build_coupled(1.0, 1.0, Re=1e3, Ra=1e5, Pr=0.71,
                                P_cd=4, N_ex_cd=8, N_ey_cd=8,
                                P_ns=4, N_ex_ns=16, N_ey_ns=16,
                                mode="PTC", mtol_nonlin=1e-8, iprint=False)
    s = mda.solve()
    assert np.linalg.norm(mda._residuals(s)) <= mda.atol_nonlin
    v_anchor = float(jnp.max(jnp.abs(s.v))) * 1e3 * 0.71
    assert abs(v_anchor - 68.59) < 2.0, v_anchor
