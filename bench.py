"""Benchmark on one NVIDIA GPU: operator-apply rate and a small coupled
solve, named by the device and the card they ran on.

* ``value``: sustained application rate of the hot SEM operator
  ``(K + Pe·(u∂x + v∂y)) w`` at p16 64×64 float32, in GDOF/s (grid nodes
  per second, best of 3), through the dispatcher users get
  (:func:`sem_jax.ops.apply_system_best`);
* ``coupled_solve_p8_16x16_s``: wall time of a cached coupled Boussinesq
  JNK solve (de Vahl Davis Ra=1e3) at P8 16×16, with its u_max·Re·Pr
  anchor.

Prints ONE JSON line.  Exits non-zero without a GPU: a CPU run would time
XLA's CPU backend, which is not what users of the device path get.
"""
import json
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)) or ".")

from chip_smoke import card_line, require_gpu  # noqa: E402


def device_apply_rate(grid, dtype, iters: int, pe: float = 40.0):
    """Sustained BARE (K + Pe·conv) apply rate in GDOF/s.

    The timed region contains only the chained operator applies: the chain
    ``x ← c·(A x)`` uses a *constant* scalar ``c ≈ 1/ρ(A)`` (estimated
    from three power steps outside the timed region) to keep magnitudes
    bounded, so no norm, reduction, or extra memory pass is timed.
    """
    from sem_jax.ops import apply_system_best
    u = jnp.asarray(np.random.default_rng(0).standard_normal(grid.N), dtype)
    v = jnp.asarray(np.random.default_rng(1).standard_normal(grid.N), dtype)
    pe = jnp.asarray(pe, dtype)

    x = u / jnp.linalg.norm(u)
    for _ in range(3):
        y = apply_system_best(grid, u, v, x, pe)
        lam = float(jnp.linalg.norm(y))
        x = y / lam
    c = 1.0 / lam  # Python float: baked into the compiled program

    @jax.jit
    def many(x):
        def body(_, x):
            return c * apply_system_best(grid, u, v, x, pe)
        return lax.fori_loop(0, iters, body, x)

    jax.block_until_ready(many(x))  # compile + warm
    t0 = time.perf_counter()
    jax.block_until_ready(many(x))
    dt = time.perf_counter() - t0
    return grid.N * iters / dt / 1e9, dt


def coupled_solve_wall(P=8, N_e=16):
    """Cached coupled Boussinesq JNK solve wall-clock: de Vahl Davis config
    solved from zero to coupled rms 1e-9 (the reference example's
    tolerance, reference Boussinesq_SequentialCoupler.py:15-17).
    Returns (wall seconds of the second solve, u_max·Re·Pr anchor)."""
    from sem_jax.coupling import build_coupled

    cd, ns, mda = build_coupled(1.0, 1.0, Re=1e3, Ra=1e3, Pr=0.71,
                                P_cd=P, N_ex_cd=N_e // 2, N_ey_cd=N_e // 2,
                                P_ns=P, N_ex_ns=N_e, N_ey_ns=N_e,
                                mode="JNK", iprint=False)
    s = mda.solve()  # includes compile; re-solve below is the measured one
    t0 = time.perf_counter()
    s = mda.solve()
    wall = time.perf_counter() - t0
    u_anchor = float(jnp.max(jnp.abs(s.u))) * 1e3 * 0.71
    return wall, u_anchor


def main():
    devices = require_gpu(1)
    from sem_jax.mesh import Grid2D
    from sem_jax.ops import apply_impl

    big = Grid2D(P=16, N_ex=64, N_ey=64, L_x=1.0, L_y=1.0)
    value = max(device_apply_rate(big, jnp.float32, iters=100)[0]
                for _ in range(3))
    solve_wall, u_anchor = coupled_solve_wall()
    d = devices[0]
    print(json.dumps({
        "metric": "sem_operator_apply_p16_64x64_f32",
        "value": round(value, 3),
        "unit": "GDOF/s",
        "apply_impl": apply_impl(),
        "coupled_solve_p8_16x16_s": round(solve_wall, 3),
        "coupled_solve_u_anchor": round(u_anchor, 4),
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())},
        "card": card_line(),
    }), flush=True)


if __name__ == "__main__":
    main()
