"""Antisymmetry defect of the CD circular-flow example against the solver
tolerance and the precision of its Krylov loop.

The example's ``--check`` asks for an antisymmetry defect below 1e-8.  The
solver's absolute tolerance is ``mtol·√N``, so at a fixed ``mtol`` the
residual it accepts grows with the grid.  For each ``mtol`` this solves the
example once with the float32 Krylov loop inside float64 refinement (the
default) and once in float64 throughout, and prints the final |r|, the
iterations and the defect: a defect that moves with ``mtol`` and not with
the precision comes from the tolerance, not from the arithmetic.

Usage: python study/cd_tolerance.py [P] [Ne]      (default: p16 64×64)
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax

from sem_jax import ConvectionDiffusionSolver


def main(P: int = 16, Ne: int = 64):
    d = jax.devices()[0]
    print(f"device={d.platform} {d.device_kind} P{P} {Ne}x{Ne}", flush=True)
    x, y = np.meshgrid(np.linspace(0, 1, 51), np.linspace(0, 1, 51),
                       indexing="ij")
    for mtol in (1e-7, 1e-9):
        for mixed in (True, False):
            t0 = time.perf_counter()
            cd = ConvectionDiffusionSolver(1.0, 1.0, 40.0, P, Ne, Ne,
                                           T_E=-0.5, T_W=0.5, mtol=mtol,
                                           mixed_precision=mixed)
            T = cd.run(lambda x, y: y - 0.5, lambda x, y: 0.5 - x, (x, y))
            info = cd.last_info
            asym = float(np.max(np.abs(T + T[::-1, ::-1])))
            print(f"mtol={mtol:.0e} krylov={'f32-in-f64' if mixed else 'f64'}"
                  f" converged={bool(info.converged)} "
                  f"iterations={int(info.iterations)} "
                  f"|r|={float(info.resnorm):.3e} "
                  f"atol={mtol * np.sqrt(cd.N):.3e} antisymmetry={asym:.3e} "
                  f"wall={time.perf_counter() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
