"""Adjoint cost at a checkpointed high-Ra coupled state.

The forward solver reaches p16 Ra=1e7; the implicit adjoint
(sem_jax.coupling.implicit) was previously measured only to Ra=1e5 at
P=4 16x16.  This harness loads a converged study checkpoint (the
``-ckpt True`` artifact of study/boussinesq_run.py), rebuilds the solvers
at its recorded configuration, verifies the state's residual, and measures
``solve_adjoint`` + the parameter gradient w.r.t. Ra/Re/Pr: wall-clock,
outer FGMRES iterations, and the gradient values.

The loss is the mean-kinetic-energy functional used by
tests/test_implicit.py (sum of u^2 + v^2 over NS nodes).

Usage:
  python study/adjoint_hi.py -ckpt Boussinesq_study/<title>.ckpt.npz \
      [-inner_rtol 1e-4] [-atol 1e-10] [-restart 60] [-maxiter 2000] \
      [-inner_maxiter 600] [-max_basis_gb 0.5] [-iprint 1] [-fd 0]

``-fd 1`` additionally validates d(loss)/d(Ra) by central finite
differences via warm-started re-solves from the checkpointed state
(rel step 1e-4, the measured sweet spot between FD truncation and the
re-solves' state-resolution floor) — affordable at Ra<=1e6, hours at 1e7.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax

import jax.numpy as jnp

from sem_jax.coupling.boussinesq import build_coupled
from sem_jax.coupling.implicit import (coupled_residual_fn, gradients,
                                       solve_adjoint)
from sem_jax.utils.checkpoint import load_checkpoint


def _flag(name, default, cast=float):
    args = sys.argv
    if name in args:
        return cast(args[args.index(name) + 1])
    return default


def main():
    path = _flag("-ckpt", None, str)
    if not path:
        sys.exit("usage: adjoint_hi.py -ckpt <study ckpt.npz> [...]")
    inner_rtol = _flag("-inner_rtol", 1e-4)
    atol = _flag("-atol", 1e-10)
    restart = _flag("-restart", 60, int)
    maxiter = _flag("-maxiter", 2000, int)
    inner_maxiter = _flag("-inner_maxiter", 600, int)
    max_basis_gb = _flag("-max_basis_gb", 0.5)
    do_fd = _flag("-fd", 0, int)

    state, cfg, iters = load_checkpoint(path)
    print(f"checkpoint: {path}\n  config {cfg}  iters {iters}", flush=True)
    params = {k: float(cfg[k]) for k in ("Re", "Ra", "Pr")}

    t0 = time.perf_counter()
    cd, ns, mda = build_coupled(
        1.0, 1.0, Re=cfg["Re"], Ra=cfg["Ra"], Pr=cfg["Pr"],
        P_cd=cfg["P_cd"], N_ex_cd=cfg["N_ex_cd"], N_ey_cd=cfg["N_ey_cd"],
        P_ns=cfg["P_ns"], N_ex_ns=cfg["N_ex_ns"], N_ey_ns=cfg["N_ey_ns"],
        mode="JNK", iprint=False)
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)

    x = jnp.concatenate([jnp.asarray(f) for f in
                         (state.T, state.u, state.v, state.p)])
    F = coupled_residual_fn(cd, ns)
    pj = {k: jnp.asarray(v, jnp.float64) for k, v in params.items()}
    r = F(x, pj)
    rms = float(jnp.linalg.norm(r)) / np.sqrt(x.shape[0])
    print(f"state residual rms: {rms:.3e} (converged study states are "
          f"<= ~1e-10)", flush=True)

    N_cd, N_ns = cd.N, ns.N

    def loss_fn(xf):
        u = xf[N_cd:N_cd + N_ns]
        v = xf[N_cd + N_ns:N_cd + 2 * N_ns]
        return jnp.sum(u**2 + v**2)

    # adjoint solve, separately timed from the theta-gradient epilogue
    loss, gbar = jax.value_and_grad(loss_fn)(x)
    t0 = time.perf_counter()
    lam, its = solve_adjoint(cd, ns, x, np.asarray(gbar), params,
                             atol=atol, restart=restart, maxiter=maxiter,
                             inner_rtol=inner_rtol,
                             inner_maxiter=inner_maxiter,
                             max_basis_gb=max_basis_gb,
                             raise_on_fail=False,
                             iprint=bool(_flag("-iprint", 0, int)))
    wall = time.perf_counter() - t0
    print(f"adjoint solve: {wall:.1f}s, {its} outer FGMRES iterations "
          f"({wall / max(its, 1):.2f} s/it)", flush=True)

    import jax as _jax
    _, vjp_theta = _jax.vjp(lambda th: F(x, th), pj)
    dtheta = vjp_theta(lam)[0]
    grads = {k: -float(v) for k, v in dtheta.items()}
    print(f"loss = {float(loss):.8e}", flush=True)
    for k, g in sorted(grads.items()):
        print(f"  d(loss)/d({k}) = {g:.8e}", flush=True)

    if do_fd:
        from sem_jax.coupling.mda import CoupledState
        h = params["Ra"] * 1e-4
        vals = {}
        for sgn in (+1, -1):
            pp = dict(cfg)
            pp["Ra"] = params["Ra"] + sgn * h
            t0 = time.perf_counter()
            _, _, mda_p = build_coupled(
                1.0, 1.0, Re=pp["Re"], Ra=pp["Ra"], Pr=pp["Pr"],
                P_cd=pp["P_cd"], N_ex_cd=pp["N_ex_cd"],
                N_ey_cd=pp["N_ey_cd"], P_ns=pp["P_ns"],
                N_ex_ns=pp["N_ex_ns"], N_ey_ns=pp["N_ey_ns"],
                mode="JNK", iprint=False)
            sp = mda_p.solve(CoupledState(state.T, state.u,
                                          state.v, state.p))
            vals[sgn] = float(loss_fn(jnp.concatenate(
                [sp.T, sp.u, sp.v, sp.p])))
            print(f"FD re-solve Ra{'+' if sgn > 0 else '-'}h: "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
        fd = (vals[+1] - vals[-1]) / (2 * h)
        print(f"FD d(loss)/d(Ra) = {fd:.8e}  "
              f"(adjoint {grads['Ra']:.8e}, rel diff "
              f"{abs(fd - grads['Ra']) / max(abs(fd), 1e-300):.2e})",
              flush=True)


if __name__ == "__main__":
    main()
