"""Coupled Boussinesq demo on a device mesh (sharded execution).

Capability parity with reference Examples/Boussinesq_Parallel_Example.py,
which runs the coupler under ``mpirun -n 2``.  Here the parallel resource is
a ``jax.sharding.Mesh`` over all visible devices (GPUs, or virtual CPU
devices via ``XLA_FLAGS=--xla_force_host_platform_device_count=8``); the
disciplines' fields shard over the mesh and XLA collectives replace the MPI
transfers.  There is no rank-0 gather — results come back fully replicated.

Usage::

    python examples/boussinesq_parallel.py [--check] [--quick]
    # virtual 8-device run on CPU:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python examples/boussinesq_parallel.py --check --quick
"""
import sys
import os

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


import numpy as np

import jax

from sem_jax.coupling import run_parallel

DVD_UMAX, DVD_VMAX = 3.649, 3.697


def main(check=False, quick=False):
    L_x = L_y = 1.0
    Re, Ra, Pr = 1e3, 1e3, 0.71
    # quick mode: GS coupling at a tiny size — sharded runs on *virtual* CPU
    # devices are compile-bound (GSPMD partitions every jitted variant), so
    # the smoke configuration minimizes distinct compilations.  On GPUs use
    # the full configuration.
    P = 3 if quick else 4
    N_e = 3 if quick else 8
    mode = "GS" if quick else "JNK"

    print(f"devices: {jax.devices()}")
    x_plot, y_plot = np.meshgrid(np.linspace(0, L_x, 101),
                                 np.linspace(0, L_y, 101), indexing="ij")
    T_plot, u_plot, v_plot = run_parallel((x_plot, y_plot), L_x, L_y,
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
        assert abs(umax - DVD_UMAX) < tol * DVD_UMAX
        assert abs(vmax - DVD_VMAX) < tol * DVD_VMAX
        print("CHECK OK")
        return

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available; skipping plot")
        return
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.streamplot(x_plot.T, y_plot.T, u_plot.T, v_plot.T, density=3)
    CS = ax.contour(x_plot, y_plot, T_plot, levels=11, colors="k",
                    linestyles="solid")
    ax.clabel(CS, inline=True)
    ax.set_title(f"Ra={Ra:.1e}, P={P}, N_e={N_e} (sharded over "
                 f"{jax.device_count()} devices)", fontsize="small")
    fig.savefig("temp.png", dpi=fig.dpi)
    print("saved temp.png")


if __name__ == "__main__":
    main(check="--check" in sys.argv, quick="--quick" in sys.argv)
