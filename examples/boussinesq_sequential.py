"""Coupled Boussinesq demo: differentially heated cavity (natural convection).

Capability parity with reference Examples/Boussinesq_Sequential_Example.py:
Re=1e3, Ra=1e3, Pr=0.71, P=4, 8×8 elements, JNK coupling; prints
``u_max·Re·Pr`` and ``v_max·Re·Pr`` for comparison with de Vahl Davis (1983),
doi.org/10.1002/fld.1650030305 (literature: ≈3.649 and ≈3.697 at Ra=10³).

Usage::

    python examples/boussinesq_sequential.py [--check] [--quick] [--mode GS|NJ|JNK]
"""
import sys
import os

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


import numpy as np

from sem_jax.coupling import run

# de Vahl Davis (1983) benchmark values at Ra=1e3, Pr=0.71
DVD_UMAX = 3.649
DVD_VMAX = 3.697


def main(check=False, quick=False, mode="JNK"):
    L_x = L_y = 1.0
    Re, Ra, Pr = 1e3, 1e3, 0.71
    P = 4
    N_e = 4 if quick else 8

    x_plot, y_plot = np.meshgrid(np.linspace(0, L_x, 101),
                                 np.linspace(0, L_y, 101), indexing="ij")
    T_plot, u_plot, v_plot = run((x_plot, y_plot), L_x, L_y,
                                 Re, Ra, Pr,
                                 P, N_e, N_e,
                                 P, N_e, N_e,
                                 mode=mode)

    umax = np.max(u_plot) * Re * Pr
    vmax = np.max(v_plot) * Re * Pr
    print(f"u_max*RePr = {umax:.3f}  (de Vahl Davis: {DVD_UMAX})")
    print(f"v_max*RePr = {vmax:.3f}  (de Vahl Davis: {DVD_VMAX})")

    if check:
        tol = 0.05 if quick else 0.02
        assert abs(umax - DVD_UMAX) < tol * DVD_UMAX, f"u_max {umax}"
        assert abs(vmax - DVD_VMAX) < tol * DVD_VMAX, f"v_max {vmax}"
        print("CHECK OK")
        return

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available; skipping plot")
        return
    fig, ax = plt.subplots(figsize=(L_x * 6, L_y * 6))
    ax.streamplot(x_plot.T, y_plot.T, u_plot.T, v_plot.T, density=3)
    CS = ax.contour(x_plot, y_plot, T_plot, levels=11, colors="k",
                    linestyles="solid")
    ax.clabel(CS, inline=True)
    ax.set_title(f"Ra={Ra:.1e}, P={P}, N_e={N_e}, mode={mode}",
                 fontsize="small")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    fig.savefig("boussinesq.png", dpi=fig.dpi)
    print("saved boussinesq.png")


if __name__ == "__main__":
    argv = sys.argv
    mode = argv[argv.index("--mode") + 1] if "--mode" in argv else "JNK"
    main(check="--check" in argv, quick="--quick" in argv, mode=mode)
