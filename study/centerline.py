"""De Vahl Davis centerline anchors from a study .npz artifact.

The de Vahl Davis (1983) benchmark reports u_max on the vertical centerline
x=0.5 and v_max on the horizontal centerline y=0.5 (both scaled by Re·Pr).
The examples print the *domain* maxima, which coincide with the centerline
maxima at low Ra but exceed them at high Ra (the u peak moves off-center) —
so high-Ra comparisons need the true centerline values.

Literature values (u_max·RePr / v_max·RePr):
  de Vahl Davis (1983), 41^2 FD + Richardson extrapolation:
    Ra=1e3: 3.649 / 3.697      Ra=1e4: 16.178 / 19.617
    Ra=1e5: 34.73 / 68.59      Ra=1e6: 64.63 / 219.36
  Le Quere (1991), pseudo-spectral "accurate solutions" (the canonical
  high-Ra values; measured here the p16 64x64 PTC solves match these to
  ~4 digits at Ra=1e6 — the 1983 extrapolation carries ~0.3-0.5% error):
    Ra=1e6: 64.8344 / 220.559  Ra=1e7: 148.58 / 699.18

Usage: python study/centerline.py Boussinesq_study/<run>.npz P_ns Ne_ns
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# pure .npz post-processing (two tiny point-evaluator matmuls): the CPU
# is enough, and leaves the accelerator to whatever else runs
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import jax

import jax.numpy as jnp

from sem_jax.interp import PointEvaluator
from sem_jax.mesh import Grid2D


def centerline_anchors(u_e, v_e, P, N_e, Re=1e3, Pr=0.71, L=1.0, n=2001):
    """(u_max·RePr on x=L/2, v_max·RePr on y=L/2) from element-scattered
    velocity fields (the study's .npz layout)."""
    grid = Grid2D(P, N_e, N_e, L, L)
    # element-scattered -> global (any owner copy works: C0 continuity)
    def to_global(f_e):
        g = np.zeros(grid.N)
        g[grid.gidx_flat] = np.asarray(f_e).reshape(-1)
        return jnp.asarray(g)

    u = to_global(u_e)
    v = to_global(v_e)
    line = np.linspace(0.0, L, n)
    half = np.full(n, 0.5 * L)
    xv, yv = np.meshgrid(np.array([0.5 * L]), line, indexing="ij")
    u_line = PointEvaluator(grid, (xv, yv))(u)
    xh, yh = np.meshgrid(line, np.array([0.5 * L]), indexing="ij")
    v_line = PointEvaluator(grid, (xh, yh))(v)
    scale = Re * Pr
    return (float(np.max(np.abs(u_line))) * scale,
            float(np.max(np.abs(v_line))) * scale)


if __name__ == "__main__":
    path, P, Ne = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    with np.load(path) as z:
        arrays = [z[k] for k in z.files]
    T_e, u_e, v_e = arrays[0], arrays[1], arrays[2]
    umax, vmax = centerline_anchors(u_e, v_e, P, Ne)
    print(f"u_max*RePr (x=0.5 centerline) = {umax:.4f}")
    print(f"v_max*RePr (y=0.5 centerline) = {vmax:.4f}")
