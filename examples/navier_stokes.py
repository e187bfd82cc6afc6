"""Steady Navier-Stokes demo: lid-driven cavity.

Capability parity with reference Examples/NavierStokes_Example.py:
Re=400, P=4, 16×16 elements, u=1 on the moving lid, validated against the
Ghia, Ghia & Shin (1982) centerline velocity tables
(doi.org/10.1016/0021-9991(82)90058-4).

Usage::

    python examples/navier_stokes.py                   # Re=400 16x16 + plot
    python examples/navier_stokes.py --quick           # Re=100 8x8
    python examples/navier_stokes.py --check [--quick] # assert vs Ghia
"""
import sys
import os

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


import numpy as np

from sem_jax import NavierStokesSolver

# Ghia et al. (1982) Table I: u through the vertical centerline (x=0.5).
GHIA_Y = np.array([0.0547, 0.1016, 0.2813, 0.4531, 0.5000, 0.7344])
GHIA_U_RE100 = np.array([-0.03717, -0.06434, -0.15662, -0.21090, -0.20581,
                         0.00332])
GHIA_U_RE400 = np.array([-0.08186, -0.14612, -0.32726, -0.17119, -0.11477,
                         0.16256])


def main(check: bool = False, quick: bool = False):
    L_x = L_y = 1.0
    Re = 100 if quick else 400
    P = 4
    N_e = 8 if quick else 16
    ghia_u = GHIA_U_RE100 if quick else GHIA_U_RE400

    ns = NavierStokesSolver(L_x, L_y, Re, 0, P, N_e, N_e, u_N=1,
                            iprint=["NEWTON_suc", "NEWTON_iter"])

    x_plot, y_plot = np.meshgrid(np.linspace(0, L_x, 101),
                                 np.linspace(0, L_y, 101), indexing="ij")
    u_plot, v_plot, p_plot = ns.run(T_func=lambda x, y: 0 * x * y,
                                    points_plot=(x_plot, y_plot))

    u_center = u_plot[50, :]
    y_line = y_plot[50, :]
    u_at_ghia = np.interp(GHIA_Y, y_line, u_center)
    err = np.max(np.abs(u_at_ghia - ghia_u))
    print(f"Re={Re}: Newton iterations {ns._k}")
    print("centerline u vs Ghia:", np.array2string(u_at_ghia, precision=4),
          "vs", np.array2string(ghia_u, precision=4))
    print(f"max abs deviation from Ghia table: {err:.4f}")

    if check:
        tol = 0.02 if quick else 0.015  # coarse-grid tolerance
        assert err < tol, f"Ghia deviation {err:.4f} exceeds {tol}"
        print("CHECK OK")
        return

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available; skipping plot")
        return
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.streamplot(x_plot.T, y_plot.T, u_plot.T, v_plot.T, density=2)
    ax.set_title(f"Re={Re:.0e}, P={P}, N_e={N_e}", fontsize="small")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    fig.savefig("navier_stokes.png", dpi=fig.dpi)
    print("saved navier_stokes.png")


if __name__ == "__main__":
    main(check="--check" in sys.argv, quick="--quick" in sys.argv)
