"""Steady convection-diffusion demo: circular flow in a box.

Capability parity with reference Examples/ConvectionDiffusion_Example.py:
Pe=40, P=4, 16×16 elements, Dirichlet T=+0.5 (west) / -0.5 (east),
homogeneous Neumann north/south, circular velocity field
[u, v] = [y - L_y/2, L_x/2 - x].

Usage::

    python examples/convection_diffusion.py           # solve + save plot
    python examples/convection_diffusion.py --check   # assert sanity, no plot
"""
import sys
import os

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


import numpy as np

from sem_jax import ConvectionDiffusionSolver


def main(check: bool = False):
    L_x = L_y = 1.0
    P, N_ex, N_ey, Pe = 4, 16, 16, 40.0
    u = lambda x, y: y - L_y / 2
    v = lambda x, y: L_x / 2 - x

    cd = ConvectionDiffusionSolver(L_x, L_y, Pe, P, N_ex, N_ey,
                                   T_E=-0.5, T_W=0.5,
                                   iprint=["LGMRES_suc"])

    x_plot, y_plot = np.meshgrid(np.linspace(0, L_x, 51),
                                 np.linspace(0, L_y, 51), indexing="ij")
    T_plot = cd.run(u, v, (x_plot, y_plot))

    print(f"T range: [{T_plot.min():.6f}, {T_plot.max():.6f}]")
    print(f"GMRES iterations: {int(cd.last_info.iterations)}")

    if check:
        assert abs(T_plot.max() - 0.5) < 1e-10, "west Dirichlet violated"
        assert abs(T_plot.min() + 0.5) < 1e-10, "east Dirichlet violated"
        # the configuration is antisymmetric under (x,y) -> (L-x, L-y);
        # the defect bound matches the solver contract (GMRES converges to
        # atol = mtol*sqrt(N) ~ 1.3e-9 absolute; solution junk along
        # weakly-observable directions is of the same order)
        asym = np.max(np.abs(T_plot + T_plot[::-1, ::-1]))
        assert asym < 1e-8, f"antisymmetry defect {asym:.2e}"
        print("CHECK OK")
        return

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available; skipping plot")
        return
    fig, ax = plt.subplots(figsize=(L_x * 4, L_y * 4))
    CS = ax.contour(x_plot, y_plot, T_plot, levels=11, colors="k",
                    linestyles="solid")
    ax.streamplot(x_plot.T, y_plot.T, u(x_plot, y_plot).T,
                  v(x_plot, y_plot).T, density=1)
    ax.clabel(CS, inline=True)
    ax.set_title(f"P={P}, N_ex={N_ex}, N_ey={N_ey}, Pe={Pe}",
                 fontsize="small")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    fig.savefig("convection_diffusion.png", dpi=fig.dpi)
    print("saved convection_diffusion.png")


if __name__ == "__main__":
    main(check="--check" in sys.argv)
