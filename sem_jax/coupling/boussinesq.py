"""Boussinesq coupler drivers — capability parity with the reference's
sequential and parallel OpenMDAO couplers
(reference OpenMDAO/Boussinesq_SequentialCoupler.py:10-108,
OpenMDAO/Boussinesq_ParallelCoupler.py:12-121).

Solves the dimensionless steady Boussinesq equations on [0,L_x]×[0,L_y]::

    Re ([u,v]∘∇)[u,v] = -∇p + ∇²[u,v] + Gr/Re [0, T]
    ∇∘[u,v] = 0
    Pe [u,v]∘∇T = ∇²T

with isothermal vertical walls T(0,y)=+0.5, T(L_x,y)=-0.5, adiabatic
floor/ceiling, and no-slip velocity everywhere; Pe = Re·Pr, Gr = Ra/Pr.

``run`` is the single-program driver (the reference's sequential coupler);
``run_parallel`` runs the same MDA with both disciplines' element batches
sharded over a ``jax.sharding.Mesh`` — the replacement of the
reference's 2-rank MPI ``ParallelGroup`` (disciplinary MPMD becomes SPMD
sharding + XLA collectives; SURVEY.md §2.4-2.5).
"""
from __future__ import annotations

import typing

import numpy as np

from sem_jax.coupling.components import (ConvectionDiffusionComponent,
                                         NavierStokesComponent)
from sem_jax.coupling.mda import BoussinesqMDA, CoupledState
from sem_jax.models.convection_diffusion import ConvectionDiffusionSolver
from sem_jax.models.navier_stokes import NavierStokesSolver

__all__ = ["run", "run_parallel", "build_coupled", "solve_continued",
           "solve_ra_continued"]


def solve_continued(L_x, L_y, levels: int = 2, state0: CoupledState = None,
                    grids0=None, ladder=None, **kwargs):
    """p-continuation solve of the coupled Boussinesq problem.

    Solves the problem on a ladder of ``levels`` coarser polynomial orders
    (P halved per level, floored at 2; element counts fixed), prolonging
    each level's solution to the next via the cross-mesh transfer operators
    (:func:`sem_jax.interp.apply_transfer`) and warm-starting the MDA with
    it.  For the smooth Boussinesq cavity flows, a P/2 solution prolonged to
    order P already satisfies the coupled equations to near its truncation
    error, so the fine level converges in 1-2 iterations instead of from
    scratch — the decisive lever for the large-p wall-clock targets (each
    coarse level costs ~(1/4)^levels of the fine level per iteration).

    Capability beyond the reference (which always solves each configuration
    from zero, reference Boussinesq_SequentialCoupler.py:66-73); the fine
    level's convergence test is unchanged, so the result satisfies exactly
    the same tolerances.

    :param levels: number of coarser levels below the target order
    :param state0: optional warm-start state.  Must live either on the
        *coarsest ladder level's* grids (default interpretation) or, when
        ``grids0=(cd_grid, ns_grid)`` is given, on those grids — it is then
        transferred to the coarsest level automatically (the natural way to
        chain a previous fine-grid solve into a new continuation run).
        A state with mismatched sizes raises a clear error.
    :param grids0: optional ``(cd_grid, ns_grid)`` pair (``Grid2D``)
        describing the grids ``state0`` lives on
    :param ladder: optional explicit ladder as a list of ``(P_cd, P_ns)``
        pairs ending at the target order, overriding ``levels`` and the
        default P-halving schedule (e.g. ``[(4, 4), (16, 16)]`` skips the
        P8 level — every level costs a set of program compiles or cache
        loads, so a shorter ladder can beat a geometrically denser one on
        time-to-first-solution)
    :param kwargs: forwarded to :func:`build_coupled` (P_cd/P_ns etc.)
    :return: (cd, ns, mda, state) of the finest level
    """
    P_cd = kwargs.pop("P_cd", 4)
    P_ns = kwargs.pop("P_ns", 4)
    iprint = kwargs.get("iprint", True)
    if ladder is None:
        ladder = [(max(2, P_cd >> k), max(2, P_ns >> k))
                  for k in range(levels, 0, -1)] + [(P_cd, P_ns)]
        # drop duplicate coarse levels created by the floor
        ladder = [lv for i, lv in enumerate(ladder)
                  if i == 0 or lv != ladder[i - 1]]
    else:
        ladder = [tuple(lv) for lv in ladder]

    state = state0
    src = grids0  # grids the current ``state`` lives on (None = this level's)
    # Overlap construction with solving: while level i solves (device-bound),
    # level i+1's solvers build in a worker thread (host-LAPACK-bound —
    # eigendecompositions, spectral Schur constants).  At p16 this hides most
    # of the fine level's construction behind the coarse solves
    # (time-to-first-solution).
    import time as _time
    timing = kwargs.pop("timing", False)
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(build_coupled, L_x, L_y,
                          P_cd=ladder[0][0], P_ns=ladder[0][1], **kwargs)
        for i, (Pc, Pn) in enumerate(ladder):
            t_lv = _time.perf_counter()
            cd, ns, mda = fut.result()
            t_build = _time.perf_counter() - t_lv
            if i + 1 < len(ladder):
                fut = pool.submit(build_coupled, L_x, L_y,
                                  P_cd=ladder[i + 1][0],
                                  P_ns=ladder[i + 1][1], **kwargs)
            if state is not None and src is not None:
                from sem_jax.interp import apply_transfer
                cd_g, ns_g = src
                state = CoupledState(
                    T=apply_transfer(cd_g, cd.grid, state.T),
                    u=apply_transfer(ns_g, ns.grid, state.u),
                    v=apply_transfer(ns_g, ns.grid, state.v),
                    p=apply_transfer(ns_g, ns.grid, state.p))
            elif state is not None and (state.T.shape[0] != cd.N
                                        or state.u.shape[0] != ns.N):
                raise ValueError(
                    f"state0 sizes (T {state.T.shape[0]}, "
                    f"u {state.u.shape[0]}) do not match the coarsest ladder "
                    f"level (N_cd={cd.N}, N_ns={ns.N}); pass "
                    f"grids0=(cd_grid, ns_grid) to have it transferred from "
                    f"its own grids")
            if iprint:
                print(f"Boussinesq continuation level P_cd={Pc} P_ns={Pn}")
            t_sv = _time.perf_counter()
            state = mda.solve(state)
            if timing:
                # time-to-first-solution attribution (chip_smoke.py): the
                # build-wait is only what the worker thread did NOT hide
                # behind the previous level's solve
                print(f"  [ttfs] level P_cd={Pc} P_ns={Pn}: build-wait "
                      f"{t_build:.1f}s solve "
                      f"{_time.perf_counter() - t_sv:.1f}s "
                      f"stats={mda.stats.as_list()}", flush=True)
            src = (cd.grid, ns.grid)
    return cd, ns, mda, state


def solve_ra_continued(L_x, L_y, Ra, decades: int = None,
                       ptc_above: float = 1.0e4, **kwargs):
    """Ra-continuation solve of the coupled Boussinesq problem.

    At high Rayleigh number the from-zero solve fails: the iteration-0
    subsystem sweep asks the NS discipline for a full nonlinear solve under
    the entire buoyancy forcing at once, which is convection-dominated
    beyond what the FDM(Laplacian)-preconditioned Krylov can handle.
    Classical parameter continuation fixes this: solve at Ra/10^decades,
    then re-solve at each decade warm-started by the previous solution
    (each level's MDA skips or warm-starts its subsystem sweep, and every
    Newton linear system stays in the mildly-nonlinear regime).

    Above ``ptc_above`` even the warm-started coupled JNK fails (measured
    round 2: the block-Jacobi-preconditioned coupled GMRES flat-lines at
    Ra=1e5, capping the ladder at ≈3.2e4) — those levels run in ``'PTC'``
    mode instead (pseudo-transient continuation, mass-shifted Jacobians +
    spectrally shifted preconditioners), whose decade steps are robust, so
    the ladder uses full decades there.

    :param Ra: target Rayleigh number
    :param decades: ``None`` (default) — automatic ladder from Ra=1e3 with
        decade steps up to 1e4, √10 (half-decade) steps in the JNK band
        above 1e4, and full decades in the PTC band;
        an int gives the legacy fixed-decade ladder
    :param ptc_above: Rayleigh number above which levels switch to PTC
        (``None`` disables the switch)
    :param kwargs: forwarded to :func:`build_coupled`
    :return: (cd, ns, mda, state) at the target Ra
    """
    def use_ptc(Ra_k):
        return ptc_above is not None and Ra_k > ptc_above * 1.00001

    if decades is None:
        ladder = [Ra]
        while ladder[0] > 1.5e3:
            prev = ladder[0]
            step = (10.0 if use_ptc(prev / 3.0) else
                    10.0 ** 0.5 if prev > 1.00001e4 else 10.0)
            ladder.insert(0, max(1e3, prev / step))
    else:
        ladder = [Ra / 10 ** k for k in range(decades, 0, -1)
                  if Ra / 10 ** k >= 1e3] + [Ra]
    iprint = kwargs.get("iprint", True)
    base_mode = kwargs.pop("mode", "JNK")
    state = None
    for Ra_k in ladder:
        mode_k = "PTC" if use_ptc(Ra_k) else base_mode
        if iprint:
            print(f"Boussinesq Ra-continuation level Ra={Ra_k:.1e} "
                  f"({mode_k})")
        cd, ns, mda = build_coupled(L_x, L_y, Ra=Ra_k, mode=mode_k, **kwargs)
        state = mda.solve(state)
    return cd, ns, mda, state


def build_coupled(L_x: float, L_y: float,
                  Re=1.e3, Ra=1.e3, Pr=0.71,
                  P_cd=4, N_ex_cd=8, N_ey_cd=8,
                  P_ns=4, N_ex_ns=8, N_ey_ns=8,
                  mode="JNK",
                  mtol_nonlin=1e-9, AGi=8, AGr=0.8, AGc=0.2,
                  mtol_gmres=1e-10, restart=20,
                  mtol_internal=1e-13, mtol_precon=1e-4, iprint=True,
                  device_krylov=None, forcing=1e-3, mtol_subsolve=1e-6,
                  velo_inner=0, schur_precon=None, **mda_kwargs):
    """Construct solvers, components, and the MDA for the Boussinesq problem.

    Parameter names and defaults mirror the reference coupler's ``run``
    signature (reference Boussinesq_SequentialCoupler.py:10-17); the two
    disciplines may use different polynomial orders and element counts
    (exploited by the study harness, reference study/Boussinesq_run.py:50-51).
    ``mode`` additionally accepts ``'PTC'`` (pseudo-transient continuation —
    capability beyond the reference, see
    :meth:`sem_jax.coupling.mda.BoussinesqMDA._solve_ptc`); extra keyword
    arguments (``ptc_dt0`` etc.) pass through to :class:`BoussinesqMDA`.

    ``velo_inner`` passes through to the NS solver: k>0 strengthens every
    coupled-preconditioner application with k FDM-preconditioned GMRES steps
    on the true shifted velocity Jacobian (flexible chunks) — the knob for
    the strongly convection-dominated regimes (Ra ≳ 1e7) where the plain
    FDM velocity blocks no longer hold the block preconditioner together.
    ``schur_precon`` (when not ``None``) overrides the NS solver's Schur
    approximation ('mass'|'pcd'|'spectral'; solver default 'spectral') —
    exposed for offline strong-wind diagnostics (study/ptc_band_probe.py).
    """
    cd = ConvectionDiffusionSolver(L_x=L_x, L_y=L_y, Pe=Re * Pr,
                                   P=P_cd, N_ex=N_ex_cd, N_ey=N_ey_cd,
                                   T_W=0.5, T_E=-0.5,
                                   mtol=mtol_internal)
    ns = NavierStokesSolver(L_x=L_x, L_y=L_y, Re=Re, Gr=Ra / Pr,
                            P=P_ns, N_ex=N_ex_ns, N_ey=N_ey_ns,
                            mtol=mtol_internal, mtol_newton=mtol_internal,
                            velo_inner=velo_inner,
                            **({"schur_precon": schur_precon}
                               if schur_precon is not None else {}),
                            iprint=["NEWTON_suc"] if iprint else [])
    cd_comp = ConvectionDiffusionComponent(cd, ns)
    ns_comp = NavierStokesComponent(cd, ns)
    if "checkpoint_path" in mda_kwargs:
        # auto-fill the config stamp checkpoints are verified against on
        # resume (utils.checkpoint raises on a mismatched discretization)
        mda_kwargs.setdefault("checkpoint_config", dict(
            Re=Re, Ra=Ra, Pr=Pr, P_cd=P_cd, N_ex_cd=N_ex_cd,
            N_ey_cd=N_ey_cd, P_ns=P_ns, N_ex_ns=N_ex_ns, N_ey_ns=N_ey_ns,
            mode=mode))
    mda = BoussinesqMDA(cd_comp, ns_comp, mode=mode,
                        mtol_nonlin=mtol_nonlin,
                        AGi=AGi, AGr=AGr, AGc=AGc,
                        mtol_gmres=mtol_gmres, restart=restart,
                        mtol_precon=mtol_precon, iprint=iprint,
                        device_krylov=device_krylov, forcing=forcing,
                        mtol_subsolve=mtol_subsolve, **mda_kwargs)
    return cd, ns, mda


def run(points_plot: typing.Tuple[np.ndarray, np.ndarray],
        L_x: float, L_y: float,
        Re=1.e3, Ra=1.e3, Pr=0.71,
        P_cd=4, N_ex_cd=8, N_ey_cd=8,
        P_ns=4, N_ex_ns=8, N_ey_ns=8,
        mode="JNK",
        mtol_nonlin=1e-9, AGi=8, AGr=0.8, AGc=0.2,
        mtol_gmres=1e-10, restart=20,
        mtol_internal=1e-13, mtol_precon=1e-4, iprint=True,
        return_state=False, device_krylov=None):
    """Solve the coupled Boussinesq problem; return (T, u, v) at plot points.

    Signature parity with reference Boussinesq_SequentialCoupler.py:10-17
    (same physics parameters, per-discipline resolutions, coupling mode, and
    tolerance conventions).
    """
    cd, ns, mda = build_coupled(L_x, L_y, Re, Ra, Pr,
                                P_cd, N_ex_cd, N_ey_cd,
                                P_ns, N_ex_ns, N_ey_ns,
                                mode, mtol_nonlin, AGi, AGr, AGc,
                                mtol_gmres, restart, mtol_internal,
                                mtol_precon, iprint,
                                device_krylov=device_krylov)
    state = mda.solve()

    T_plot = cd._get_interpol(state.T, points_plot)
    u_plot = ns._get_interpol(state.u, points_plot)
    v_plot = ns._get_interpol(state.v, points_plot)
    if return_state:
        return T_plot, u_plot, v_plot, state, mda.stats
    return T_plot, u_plot, v_plot


def run_parallel(points_plot, L_x, L_y, *args, devices=None, **kwargs):
    """Sharded-execution variant of :func:`run`.

    The reference's parallel coupler distributes the CD and NS disciplines
    onto 2 MPI ranks and runs PETSc GMRES across them (reference
    Boussinesq_ParallelCoupler.py:70-121).  Here the same capability is a
    single SPMD program over a ``jax.sharding.Mesh``: both disciplines'
    element batches and grid fields are sharded over all devices (element-
    domain decomposition — more parallel than the reference's 2-way
    disciplinary split), collectives run between the devices (NCCL over
    NVLink on one GPU host), and results land fully
    replicated — so no final MPI gather is needed.
    """
    from sem_jax.parallel import sharding as sh
    mesh = sh.make_mesh(devices=devices)
    with sh.use_mesh(mesh):
        return run(points_plot, L_x, L_y, *args, **kwargs)
