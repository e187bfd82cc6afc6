"""Measure NS solve wall-clock + inner iteration counts across resolutions.

Quantifies the Schur/velocity preconditioner degradation that was once the
#1 blocker (diag-mass Schur: ~20 → ~3000 inner iterations between
P=4 8×8 and p=16 64×64; reference sidesteps it with an exact SuperLU inner
solve, reference NavierStokes_Solver.py:176-187).

Usage: python study/ns_scale.py [P Ne [P Ne ...]] [--precon mass|pcd]
"""
import sys
import os
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

import jax.numpy as jnp

from sem_jax.models.navier_stokes import NavierStokesSolver


def run_config(P, Ne, precon="mass", Re=400.0, mode="lid"):
    """``mode='lid'``: lid-driven cavity at ``Re`` (strong convection).
    ``mode='bouss'``: the north-star NS physics — buoyancy-driven at
    Re=1e3, Ra=1e3, Pr=0.71 (Gr=Ra/Pr), no-slip walls, differentially
    heated temperature profile (velocities ~5e-3 ⇒ mild convection)."""
    t0 = time.perf_counter()
    if mode == "bouss":
        Re, Gr, u_N = 1e3, 1e3 / 0.71, 0.0
    else:
        Gr, u_N = 0.0, 1.0
    ns = NavierStokesSolver(1.0, 1.0, Re=Re, Gr=Gr, P=P, N_ex=Ne, N_ey=Ne,
                            u_N=u_N, mtol=1e-10, mtol_newton=1e-8,
                            schur_precon=precon,
                            iprint=["NEWTON_iter", "LGMRES_suc"])
    t_build = time.perf_counter() - t0
    if mode == "bouss":
        T = jnp.asarray(0.5 - ns.points[0])
    else:
        T = jnp.zeros(ns.N)
    t0 = time.perf_counter()
    u, v, p = ns._get_solution(T)
    t_solve = time.perf_counter() - t0
    ru, rv, rc = ns._get_residuals(u, v, p, T)
    rms = float(np.sqrt((np.linalg.norm(ru) ** 2 + np.linalg.norm(rv) ** 2
                         + np.linalg.norm(rc) ** 2) / (3 * ns.N)))
    print(f"[ns_scale] P={P} Ne={Ne} N={ns.N} precon={precon} mode={mode}: "
          f"build {t_build:.1f}s solve {t_solve:.1f}s "
          f"newton={ns._k} last_inner={int(ns.last_schur_info.iterations)} "
          f"rms={rms:.2e}", flush=True)
    return t_solve


if __name__ == "__main__":
    args = sys.argv[1:]
    precon = "mass"
    if "--precon" in args:
        i = args.index("--precon")
        precon = args[i + 1]
        args = args[:i] + args[i + 2:]
    mode = "lid"
    if "--mode" in args:
        i = args.index("--mode")
        mode = args[i + 1]
        args = args[:i] + args[i + 2:]
    vals = [int(a) for a in args]
    configs = (list(zip(vals[::2], vals[1::2])) if vals
               else [(8, 16), (8, 32), (16, 64)])
    for (P, Ne) in configs:
        run_config(P, Ne, precon=precon, mode=mode)
