"""Parameter-sweep study harness for the coupled Boussinesq problem.

Capability parity with reference study/Boussinesq_run.py:14-170: a CLI that
sweeps polynomial order / element count / Re / Ra / coupling mode, tees
stdout to a per-run log file, and saves element-scattered solution fields
plus iteration counts ``[cd_solves, ns_solves, nonlinear_iters]`` to ``.npz``
under ``Boussinesq_study/`` with a config-encoding run title.

Flags (comma-separated sweep lists, like the reference's hand-rolled parser):

    -P 4,8          polynomial orders
    -Ne 8,16        element counts (CD runs at Ne/2 like the reference study)
    -Re 1e3         Reynolds numbers
    -Ra 1e3,1e4     Rayleigh numbers
    -mode JNK       GS | NJ | JNK | PTC (pseudo-transient continuation —
                    capability beyond the reference; the high-Ra path)
    -log True       tee stdout to Boussinesq_study/<title>.log
    -save True      save .npz results
    -backend single single | mesh (mesh = shard over all visible devices,
                    the replacement of the reference's PETSc backend)
    -ckpt True      checkpoint the coupled iterate every few nonlinear
                    iterations to Boussinesq_study/<title>.ckpt.npz
                    (capability beyond the reference — SURVEY §5.4)
    -resume True    warm-start from that checkpoint if present (implies
                    checkpointing the continued run)
    -ptc_dt0 0.1, -ptc_growth 3, -ptc_forcing 1e-2, -ptc_dtmax 1e12
                    PTC controller overrides (initial pseudo-timestep, SER
                    growth factor, linear forcing, hard Δt ceiling) for
                    hard-regime tuning — pin -ptc_dtmax below a measured
                    doomed Δt band (study/ptc_band_probe.py) to stop the
                    controller re-probing it
    -schur spectral NS Schur-block override (mass | pcd | spectral)
    -budget 9000    wall-clock budget in seconds: the MDA checkpoints and
                    exits GRACEFULLY between nonlinear iterations instead
                    of being SIGTERM'd mid-dispatch by an external timeout
                    (a mid-dispatch kill can wedge a remote accelerator)
    -init path.npz  warm-start from a checkpoint of a DIFFERENT physics
                    config on the same grid (manual Ra/Re continuation;
                    ignored when -resume finds a same-config checkpoint)
    -precon bgs2    coupled-preconditioner override (bj | bgs | bgs2;
                    bgs2 = symmetric sweep — re-solve the CD block against
                    the velocity-advection coupling after the NS solve)
    -velo_inner 5   strengthen every coupled-preconditioner application
                    with k FDM-preconditioned GMRES steps on the true
                    shifted velocity Jacobian (flexible f32 chunks) — the
                    knob for Ra ≳ 1e7 where plain FDM velocity blocks
                    no longer hold the block preconditioner together

Run: ``python study/boussinesq_run.py -P 4 -Ne 8 -mode JNK``
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax

import jax.numpy as jnp


class Logger:
    """stdout tee into a log file (parity: reference study :14-23)."""

    def __init__(self, file):
        self.terminal = sys.__stdout__
        self.log = open(file, "w")

    def write(self, message):
        self.log.write(message)
        self.terminal.write(message)

    def flush(self):
        self.log.flush()


def run(log=False, save=True,
        L_x=1., L_y=1.,
        Re=1.e3, Ra=1.e3, Pr=0.71,
        P=4, N_e=8,
        mode="JNK", backend="single",
        mtol_nonlin=1e-10, AGi=8, AGr=0.8, AGc=0.2,
        mtol_gmres=1e-13, restart=20,
        mtol_internal=1e-13, forcing=None, racont=False, ckpt=False,
        resume=False, velo_inner=0, init=None, budget=None,
        ptc_dt0=None, ptc_growth=None, ptc_forcing=None, precon=None,
        ptc_dtmax=None, schur=None):
    # forcing=None: reference-parity fixed-tolerance coupled GMRES, so the
    # saved iteration counts compare against the reference study's
    from sem_jax import operators as ops
    from sem_jax.coupling import build_coupled
    from sem_jax.parallel.sharding import make_mesh, use_mesh
    import contextlib

    title = f"Boussinesq{mode}_{Re:.1e}~{Ra:.1e}~{Pr}_{P}~{N_e}_"
    if mode == "GS":
        title += f"{mtol_nonlin:.0e}_{mtol_internal:.0e}"
    elif mode == "NJ":
        title += f"{mtol_nonlin:.0e}~{AGi}~{AGr}~{AGc}_{mtol_internal:.0e}"
    elif mode in ("JNK", "PTC"):
        title += f"{mtol_nonlin:.0e}_{mtol_gmres:.0e}~{restart}_{mtol_internal:.0e}"
    else:
        raise RuntimeError("Unknown method")
    print(title)

    if log:
        os.makedirs("Boussinesq_study", exist_ok=True)
        sys.stdout = Logger(f"Boussinesq_study/{title}.log")

    try:
        ctx = (use_mesh(make_mesh()) if backend == "mesh"
               else contextlib.nullcontext())
        with ctx:
            # CD at half the NS element count (reference study :50-51)
            kw = dict(Re=Re, Pr=Pr,
                      P_cd=P, N_ex_cd=max(1, int(N_e / 2)),
                      N_ey_cd=max(1, int(N_e / 2)),
                      P_ns=P, N_ex_ns=N_e, N_ey_ns=N_e,
                      mode=mode, mtol_nonlin=mtol_nonlin,
                      AGi=AGi, AGr=AGr, AGc=AGc,
                      mtol_gmres=mtol_gmres, restart=restart,
                      mtol_internal=mtol_internal, forcing=forcing,
                      velo_inner=velo_inner)
            if budget is not None:
                # ABSOLUTE deadline, not a per-solve budget: continuation
                # modes (-racont) build a fresh MDA per ladder level, and a
                # per-solve budget would restart at every level — blowing
                # the cumulative wall clock through the external bound the
                # flag exists to stay under
                import time as _time
                kw["time_deadline"] = _time.monotonic() + float(budget)
            for kname, v in (("ptc_dt0", ptc_dt0), ("ptc_growth", ptc_growth),
                             ("ptc_forcing", ptc_forcing),
                             ("ptc_dt_max", ptc_dtmax)):
                if v is not None:
                    kw[kname] = float(v)
            if schur is not None:
                # NS Schur-block override ('mass'/'pcd'/'spectral')
                kw["schur_precon"] = schur
            if precon is not None:
                # coupled-preconditioner override ('bj'/'bgs'/'bgs2'; the
                # default is mode-dependent — see BoussinesqMDA.__init__)
                kw["precon"] = precon
            if init and racont:
                raise ValueError(
                    "-init is not supported with -racont True (the Ra "
                    "ladder owns its warm starts); drop -racont to seed a "
                    "single-level run from the checkpoint")
            if ckpt or resume:
                os.makedirs("Boussinesq_study", exist_ok=True)
                kw["checkpoint_path"] = f"Boussinesq_study/{title}.ckpt.npz"
            if racont:
                # Ra continuation for high-Ra configs (from-zero solves
                # fail there); recorded stats are the target level's
                from sem_jax.coupling.boussinesq import solve_ra_continued
                cd, ns, mda, state = solve_ra_continued(L_x, L_y, Ra, **kw)
            else:
                cd, ns, mda = build_coupled(L_x, L_y, Ra=Ra, **kw)
                state0 = None
                if resume and os.path.exists(kw["checkpoint_path"]):
                    from sem_jax.utils.checkpoint import load_checkpoint
                    state0, _, it0, extras = load_checkpoint(
                        kw["checkpoint_path"],
                        expect_config=mda.checkpoint_config,
                        with_extras=True)
                    # continue the SER Δt ramp where the checkpoint left it
                    # (unless the user pinned -ptc_dt0 explicitly) — a
                    # restarted ramp re-crawls dozens of cheap steps
                    if extras.get("ptc_dt") and ptc_dt0 is None:
                        mda.ptc_dt0 = float(extras["ptc_dt"])
                    print(f"resuming from {kw['checkpoint_path']} "
                          f"(saved iters "
                          f"{list(it0) if it0 is not None else '?'}"
                          + (f", dt={extras['ptc_dt']:.3g}"
                             if extras.get("ptc_dt") else "") + ")")
                elif init:
                    # warm-start from a checkpoint of a DIFFERENT physics
                    # config (manual Ra/Re continuation: e.g. seed the
                    # Ra=1e8 PTC run with the converged Ra=1e7 state).
                    # Only the discretization must match — physics keys
                    # (Re/Ra/Pr/mode) are allowed to differ by design.
                    from sem_jax.utils.checkpoint import load_checkpoint
                    state0, cfg0, _ = load_checkpoint(init)
                    grid_keys = ("P_cd", "N_ex_cd", "N_ey_cd",
                                 "P_ns", "N_ex_ns", "N_ey_ns")
                    mism = {k: (cfg0.get(k), kw[k]) for k in grid_keys
                            if cfg0.get(k) != kw[k]}
                    if mism:
                        raise ValueError(
                            f"-init checkpoint discretization mismatch: "
                            f"{mism}")
                    print(f"init from {init} "
                          f"(Ra={cfg0.get('Ra')}, Re={cfg0.get('Re')})")
                state = mda.solve(state0)
    finally:
        if log:
            sys.stdout = sys.__stdout__

    # element-scattered fields (parity: reference study :114-124 saves
    # SEM.scatter'd coefficient arrays)
    def escatter(grid, f):
        return np.asarray(ops.gather(grid, jnp.asarray(f))).reshape(
            grid.N_ex, grid.N_ey, grid.P + 1, grid.P + 1)

    T_e = escatter(cd.grid, state.T)
    u_e = escatter(ns.grid, state.u)
    v_e = escatter(ns.grid, state.v)
    iters = mda.stats.as_list()
    print(iters)

    if save:
        os.makedirs("Boussinesq_study", exist_ok=True)
        np.savez("Boussinesq_study/" + title, T_e, u_e, v_e, np.array(iters))
        # compact committed record (the ~20 MB field .npz is gitignored and
        # does not survive workspace resets): iteration counts + raw domain
        # anchors.  ``study/summarize.py`` refreshes this sidecar with
        # literature-grade centerline anchors when the .npz is still around.
        import json
        stats = dict(mode=mode, Re=Re, Ra=Ra, Pr=Pr, P=P, Ne=N_e,
                     iters=[int(x) for x in iters],
                     u_anchor=round(float(np.abs(u_e).max()) * Re * Pr, 4),
                     v_anchor=round(float(np.abs(v_e).max()) * Re * Pr, 4),
                     anchor_kind="domain_max")
        with open(f"Boussinesq_study/{title}.stats.json", "w") as fh:
            json.dump(stats, fh, indent=1)
    return state, mda.stats


if __name__ == "__main__":
    save = True
    log = False
    mode = "JNK"
    racont = False
    ckpt = False
    resume = False
    velo_inner = 0
    init = None
    budget = None
    ptc_dt0 = None
    ptc_growth = None
    ptc_forcing = None
    ptc_dtmax = None
    schur = None
    precon = None
    backend = "single"
    P_set = [4]
    Ne_set = [8]
    Re_set = [1.e3]
    Ra_set = [1.e3]

    args = sys.argv
    for i, arg in enumerate(args):
        if arg == "-P":
            P_set = [int(s) for s in args[i + 1].split(",")]
        if arg == "-Ne":
            Ne_set = [int(s) for s in args[i + 1].split(",")]
        if arg == "-Re":
            Re_set = [float(s) for s in args[i + 1].split(",")]
        if arg == "-Ra":
            Ra_set = [float(s) for s in args[i + 1].split(",")]
        if arg == "-mode":
            mode = args[i + 1]
        if arg == "-log":
            log = args[i + 1].lower() in ("true", "1", "yes")
        if arg == "-save":
            save = args[i + 1].lower() in ("true", "1", "yes")
        if arg == "-backend":
            backend = args[i + 1]
        if arg == "-racont":
            racont = args[i + 1].lower() in ("true", "1", "yes")
        if arg == "-ckpt":
            ckpt = args[i + 1].lower() in ("true", "1", "yes")
        if arg == "-resume":
            resume = args[i + 1].lower() in ("true", "1", "yes")
        if arg == "-velo_inner":
            velo_inner = int(args[i + 1])
        if arg == "-init":
            init = args[i + 1]
        if arg == "-budget":
            budget = float(args[i + 1])
        if arg == "-ptc_dt0":
            ptc_dt0 = float(args[i + 1])
        if arg == "-ptc_growth":
            ptc_growth = float(args[i + 1])
        if arg == "-ptc_forcing":
            ptc_forcing = float(args[i + 1])
        if arg == "-precon":
            precon = args[i + 1]
        if arg == "-ptc_dtmax":
            ptc_dtmax = float(args[i + 1])
        if arg == "-schur":
            schur = args[i + 1]

    for Re in Re_set:
        for Ra in Ra_set:
            for P in P_set:
                for Ne in Ne_set:
                    run(mode=mode, log=log, save=save, Re=Re, Ra=Ra,
                        P=int(P), N_e=int(Ne), backend=backend,
                        racont=racont, ckpt=ckpt, resume=resume,
                        velo_inner=velo_inner, init=init, budget=budget,
                        ptc_dt0=ptc_dt0, ptc_growth=ptc_growth,
                        ptc_forcing=ptc_forcing, precon=precon,
                        ptc_dtmax=ptc_dtmax, schur=schur)
