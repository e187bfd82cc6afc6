#!/usr/bin/env python3
"""Smoke test of sem_jax on NVIDIA GPUs: the quickest proof that the system
still starts, runs its kernels as compiled for the card, and solves.

    python chip_smoke.py          # one card, all single-card phases
    python chip_smoke.py --four   # four cards: the coupled solve under a
                                  # 4-card mesh against card 0 alone

Single-card phases, in order, in one process:

1. identity — device kind and count, JAX version, ``XLA_FLAGS``, the
   compile-cache directory, and the card's name and power limit;
2. operator parity at p16 64×64 float32 — the CD system apply and the
   coupled saddle matvec through the dispatcher (the in-band einsum form on
   one GPU), against the plain reference in float64 on the card, within
   2e-5·max|ref| (TF32 would give ~1e-3);
3. the two plain XLA forms — per-call wall time (median of warm calls,
   each ending in ``block_until_ready``) and device time per call (from a
   ``jax.profiler`` trace) of the dense form and the in-band einsum form,
   at p16 64×64 and P8 32×32;
4. the CD circular-flow example at p16 64×64 with its ``--check`` bounds;
5. the main path: the coupled Boussinesq heated cavity (de Vahl Davis,
   Ra=1e3, Pr=0.71) at p16 with 64×64 NS / 32×32 CD elements, checked
   against u_max·Re·Pr = 3.6532 — first by the P4→P8→P16 continuation
   ladder (its P16 level starts converged, so it mostly exercises set-up
   and the coarse levels), then directly at p16 (Newton and coupled GMRES
   iterations on the p16 matvec), each solved cold and again.

Any failed check raises, and the script exits non-zero.  The last line of
standard output is ``{"ok": true, "device": {...}}``.  Without a GPU, it
exits non-zero and prints no such line.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# de Vahl Davis Ra=1e3 cavity at p16 (Boussinesq_study/BoussinesqJNK_*16~64*)
ANCHOR_P16 = 3.6532
ANCHOR_TOL = 0.002
PARITY_TOL = 2e-5        # the CPU tests' bound, relative to max|ref|
MAIN_KW = dict(Re=1e3, Ra=1e3, Pr=0.71, N_ex_cd=32, N_ey_cd=32,
               N_ex_ns=64, N_ey_ns=64, mode="JNK", mtol_nonlin=1e-8,
               iprint=False)
LADDER = [(4, 4), (8, 8), (16, 16)]
DIRECT = [(16, 16)]


def log(*a):
    print(*a, flush=True)


def check(ok, msg: str):
    """Raise when a smoke check fails (kept under ``python -O``)."""
    if not ok:
        raise AssertionError(msg)


def card_line() -> str:
    """The cards' name and power limit as nvidia-smi reports them (read in
    a child process that does not touch JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def require_gpu(count: int = 1):
    """The first ``count`` GPUs; exits non-zero when JAX has fewer."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        sys.exit(f"chip_smoke: needs {count} GPU(s); JAX found "
                 f"{len(devs)} {devs[0].platform} device(s) — no result")
    return devs[:count]


def phase_identity(devices) -> dict:
    import jax
    from sem_jax.utils import diskcache
    d = devices[0]
    info = {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}
    log(f"[identity] device={info} jax={jax.__version__} "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"compile_cache={jax.config.jax_compilation_cache_dir!r} "
        f"npz_cache={diskcache.cache_dir()!r}")
    log(f"[identity] card: {card_line()}")
    return info


# ---------------------------------------------------------------- operators

def _operator_inputs(P: int, Ne: int, seed: int):
    import jax.numpy as jnp
    from sem_jax.mesh import Grid2D
    grid = Grid2D(P=P, N_ex=Ne, N_ey=Ne, L_x=1.0, L_y=1.0)
    rng = np.random.default_rng(seed)
    N = grid.N
    r = lambda n: jnp.asarray(rng.standard_normal(n), jnp.float32)
    mb = np.zeros(N, bool)
    mb[rng.choice(N, size=N // 7, replace=False)] = True
    return grid, dict(u=r(N), v=r(N), w=r(N), q=r(3 * N),
                      jac=tuple(r(N) for _ in range(4)), mb=mb)


def _coupled_reference(grid, q, ul, vl, jac, mb, Re):
    """The NS tangent rows composed from the single operators (the
    composition tests/test_banded.py checks the banded form against)."""
    import jax.numpy as jnp
    from sem_jax import operators as ops
    N = grid.N
    du, dv, dp = q[:N], q[N:2 * N], q[2 * N:]
    jxx, jxy, jyx, jyy = jac
    sysapply = lambda w: (ops.apply_stiffness(grid, w)
                          + Re * ops.apply_convection(grid, ul, vl, w))
    dru = sysapply(du) + jxx * du + jxy * dv + ops.apply_grad_x(grid, dp)
    drv = sysapply(dv) + jyx * du + jyy * dv + ops.apply_grad_y(grid, dp)
    drc = ops.apply_grad_x(grid, du) + ops.apply_grad_y(grid, dv)
    return jnp.concatenate([jnp.where(mb, du, dru), jnp.where(mb, dv, drv),
                            jnp.where(mb, ops.apply_stiffness(grid, dp),
                                      drc)])


def phase_parity(P: int = 16, Ne: int = 64, seed: int = 0,
                 expect_impl: str | None = "xla-banded") -> dict:
    """Both fused operators through the dispatcher (float32) against the
    float64 reference on the same device."""
    import jax.numpy as jnp
    from sem_jax import operators as ops
    from sem_jax.ops import (apply_impl, apply_system_best,
                             apply_coupled_system_best)
    grid, a = _operator_inputs(P, Ne, seed)
    impl = apply_impl()
    check(expect_impl is None or impl == expect_impl,
          f"dispatcher chose {impl}, not {expect_impl}")
    f64 = lambda x: x.astype(jnp.float64)
    c, Re = 7.5, 37.0
    out = {}
    got = apply_system_best(grid, a["u"], a["v"], a["w"], jnp.float32(c))
    ref = ops.apply_system(grid, f64(a["u"]), f64(a["v"]), f64(a["w"]), c)
    out["cd_apply"] = (got, ref)
    got = apply_coupled_system_best(grid, a["q"], a["u"], a["v"], a["jac"],
                                    a["mb"], jnp.float32(Re))
    ref = _coupled_reference(grid, f64(a["q"]), f64(a["u"]), f64(a["v"]),
                             tuple(map(f64, a["jac"])), a["mb"], Re)
    out["coupled_matvec"] = (got, ref)
    errs = {}
    for name, (got, ref) in out.items():
        got, ref = np.asarray(got, np.float64), np.asarray(ref)
        check(got.shape == ref.shape and np.all(np.isfinite(got)), name)
        err, tol = np.abs(got - ref).max(), PARITY_TOL * np.abs(ref).max()
        log(f"[parity] P{P} {Ne}x{Ne} {name}: impl={impl} "
            f"max|got-ref|={err:.3e} tol={tol:.3e} "
            f"(rel {err / np.abs(ref).max():.2e})")
        check(err <= tol, f"{name} parity {err:.3e} > {tol:.3e}")
        errs[name] = float(err)
    return {"impl": impl, "errors": errs}


def _wall_median_us(fn, reps: int) -> float:
    fn().block_until_ready()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn().block_until_ready()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e6


def _device_us(fn, reps: int, tracedir: str) -> float:
    """Device time per call: the summed durations of every operation the
    profiler records on the GPU over ``reps`` calls, divided by ``reps``."""
    import shutil
    import glob
    import jax
    from jax.profiler import ProfileData
    fn().block_until_ready()
    shutil.rmtree(tracedir, ignore_errors=True)
    jax.profiler.start_trace(tracedir)
    for _ in range(reps):
        fn().block_until_ready()
    jax.profiler.stop_trace()
    path = glob.glob(os.path.join(tracedir, "**", "*.xplane.pb"),
                     recursive=True)[0]
    total = 0
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            total += sum(ev.duration_ns for ev in line.events
                         if not ev.name.startswith("Memcpy"))
    shutil.rmtree(tracedir, ignore_errors=True)
    return total / reps / 1e3


def phase_timing(shapes=((16, 64), (8, 32)), reps: int = 20,
                 device_time: bool = True) -> dict:
    """Dense and in-band einsum XLA forms of both operators."""
    import jax.numpy as jnp
    from sem_jax import operators as ops
    from sem_jax.ops import banded
    tracedir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "chiprun_out", "chip_smoke_trace")
    res = {}
    for P, Ne in shapes:
        grid, a = _operator_inputs(P, Ne, 1)
        c = jnp.float32(7.5)
        u, v, w, q, jac, mb = (a[k] for k in
                               ("u", "v", "w", "q", "jac", "mb"))
        forms = {
            "cd_apply": {
                "xla-dense": lambda: ops.apply_system(grid, u, v, w, c),
                "xla-banded": lambda: banded.apply_system_banded_xla(
                    grid, u, v, w, c)},
            "coupled_matvec": {
                "xla-dense": lambda: ops.apply_coupled_system(
                    grid, q, u, v, jac, mb, c),
                "xla-banded": lambda: banded.apply_coupled_system_banded_xla(
                    grid, q, u, v, jac, mb, c)},
        }
        for op, fns in forms.items():
            for name, fn in fns.items():
                wall = _wall_median_us(fn, reps)
                dev = (_device_us(fn, reps, tracedir) if device_time
                       else float("nan"))
                res[(P, Ne, op, name)] = (wall, dev)
                log(f"[timing] P{P} {Ne}x{Ne} {op} {name}: "
                    f"wall median {wall:.1f} us/call ({reps} calls), "
                    f"device {dev:.1f} us/call")
    return res


# ---------------------------------------------------------------- solves

def phase_cd(P: int = 16, Ne: int = 64, mtol: float = 1e-9) -> dict:
    """examples/convection_diffusion.py's circular flow, checked with the
    example's --check bounds and for convergence.

    At p16 64×64 the default ``mtol=1e-7`` stops the refinement after its
    first float32 correction, whose roundoff (float32 eps·|T| ≈ 3e-8) is
    the antisymmetry defect: 2.7e-8 on an H100, against 3.8e-11 with a
    float64 Krylov loop at the same tolerance (``study/cd_tolerance.py``).
    This phase keeps the default float32 loop and asks for ``mtol=1e-9``,
    which meets the example's 1e-8 bound."""
    from sem_jax import ConvectionDiffusionSolver
    from sem_jax.ops import apply_impl
    t0 = time.perf_counter()
    cd = ConvectionDiffusionSolver(1.0, 1.0, 40.0, P, Ne, Ne,
                                   T_E=-0.5, T_W=0.5, mtol=mtol)
    x, y = np.meshgrid(np.linspace(0, 1, 51), np.linspace(0, 1, 51),
                       indexing="ij")
    T = cd.run(lambda x, y: y - 0.5, lambda x, y: 0.5 - x, (x, y))
    wall = time.perf_counter() - t0
    info = cd.last_info
    asym = float(np.max(np.abs(T + T[::-1, ::-1])))
    log(f"[cd] P{P} {Ne}x{Ne} N={cd.N}: matvec impl={apply_impl()} "
        f"converged="
        f"{bool(info.converged)} iterations={int(info.iterations)} "
        f"|r|={float(info.resnorm):.3e} atol={mtol * np.sqrt(cd.N):.3e} "
        f"T=[{T.min():.12f}, {T.max():.12f}] "
        f"antisymmetry={asym:.2e} wall={wall:.1f}s (compile included)")
    check(bool(info.converged), "CD solve did not converge")
    check(abs(T.max() - 0.5) < 1e-10, "west Dirichlet violated")
    check(abs(T.min() + 0.5) < 1e-10, "east Dirichlet violated")
    check(asym < 1e-8, f"antisymmetry defect {asym:.2e}")
    return {"wall_s": wall, "asym": asym}


def _main_solve(ladder, P, kw):
    import jax.numpy as jnp
    from sem_jax.coupling.boussinesq import solve_continued
    t0 = time.perf_counter()
    cd, ns, mda, s = solve_continued(1.0, 1.0, ladder=ladder, P_cd=P,
                                     P_ns=P, timing=True, **kw)
    s.u.block_until_ready()
    wall = time.perf_counter() - t0
    anchor = float(jnp.max(jnp.abs(s.u))) * kw["Re"] * kw["Pr"]
    res = float(np.linalg.norm(np.asarray(mda._residuals(s))))
    return wall, anchor, res, cd, ns, mda, s


def phase_main(ladder=LADDER, P: int = 16, kw=MAIN_KW,
               anchor: float | None = ANCHOR_P16) -> dict:
    """The coupled solve twice in-process: cold (compile included, the
    set-up time) and again (programs cached)."""
    import jax
    from sem_jax.ops import apply_impl
    out = {}
    for run in ("cold", "second"):
        wall, u_anchor, res, cd, ns, mda, s = _main_solve(ladder, P, kw)
        log(f"[main] {run}: ladder={ladder} NS N={ns.N} CD N={cd.N} "
            f"matvec impl={apply_impl()} "
            f"finest-level stats [cd, ns, newton]={mda.stats.as_list()} "
            f"gmres_iters={mda.stats.gmres_iters} wall={wall:.1f}s "
            f"u_max*Re*Pr={u_anchor:.6f} |r|={res:.3e} "
            f"atol={mda.atol_nonlin:.3e}")
        check(np.isfinite(u_anchor) and res <= mda.atol_nonlin,
              f"coupled solve not converged: |r|={res:.3e}")
        if anchor is not None:
            check(abs(u_anchor - anchor) <= ANCHOR_TOL,
                  f"anchor {u_anchor:.5f} vs {anchor} ± {ANCHOR_TOL}")
        out[run] = {"wall_s": wall, "anchor": u_anchor, "res": res}
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[main] peak_bytes_in_use={stats.get('peak_bytes_in_use')}")
    return out


def phase_four(devices, ladder=LADDER, P: int = 16, kw=MAIN_KW,
               anchor: float | None = ANCHOR_P16) -> dict:
    """The main-path solve on the first device alone, then under a 1D mesh
    over ``devices``; the states must agree to 1e-6 and the anchors to the
    printed digits."""
    import jax
    from sem_jax.ops import apply_impl
    from sem_jax.parallel.sharding import make_mesh, use_mesh
    with jax.default_device(devices[0]):
        wall1, a1, r1, _, ns, _, s1 = _main_solve(ladder, P, kw)
    log(f"[four] one device: wall={wall1:.1f}s u_max*Re*Pr={a1:.6f} "
        f"|r|={r1:.3e}")
    mesh = make_mesh(devices)
    with use_mesh(mesh):
        impl = apply_impl()
        wall4, a4, r4, _, _, mda, s4 = _main_solve(ladder, P, kw)
    diff = max(float(np.max(np.abs(np.asarray(x) - np.asarray(y))))
               for x, y in ((s1.T, s4.T), (s1.u, s4.u), (s1.v, s4.v)))
    log(f"[four] {len(devices)}-device mesh {dict(mesh.shape)}: matvec "
        f"impl={impl} wall={wall4:.1f}s u_max*Re*Pr={a4:.6f} |r|={r4:.3e} "
        f"atol={mda.atol_nonlin:.3e} max|state diff|={diff:.3e}")
    check(r4 <= mda.atol_nonlin, f"mesh solve not converged: {r4:.3e}")
    check(diff <= 1e-6, f"mesh and single-device states differ: {diff:.3e}")
    check(f"{a1:.4f}" == f"{a4:.4f}", f"anchors differ: {a1} vs {a4}")
    if anchor is not None:
        check(abs(a4 - anchor) <= ANCHOR_TOL, f"anchor {a4:.5f}")
    return {"impl": impl, "diff": diff, "anchors": (a1, a4)}


def main(argv) -> int:
    import sem_jax  # noqa: F401  (fails first when run outside the repo)
    four = "--four" in argv
    devices = require_gpu(4 if four else 1)
    info = phase_identity(devices)
    t0 = time.perf_counter()
    if four:
        phase_four(devices)
    else:
        phase_parity()
        phase_timing()
        phase_cd()
        phase_main(LADDER)
        phase_main(DIRECT)
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f}s")
    log(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
