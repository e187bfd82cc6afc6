"""Krylov per-iteration economics on the north-star ladder.

A p16 coupled f32 GMRES iteration splits into preconditioner, matvec, MGS
sweep and DGKS resweep — the resweep doubles the bandwidth-bound basis
traffic whenever it fires.  This harness
measures, on the REAL ladder solve (not a synthetic worst case):

  * per-level NS inner-f32 iteration and resweep counts
    (``KrylovInfo.resweeps``),
  * cached ladder wall-clock and convergence stats,

under a configurable DGKS threshold η (``--eta``, default
``krylov.DGKS_ETA``) and NS GMRES window (``--restart``, default auto) — the
data behind the η/restart defaults.

Usage:  python study/krylov_econ.py [--eta X] [--restart N] [--ra 1e3]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax

import jax.numpy as jnp

from sem_jax import krylov
from sem_jax.coupling.boussinesq import build_coupled
from sem_jax.coupling.mda import CoupledState
from sem_jax.interp import apply_transfer


def instrument_phases(ns, cd, mda=None):
    """Wall-clock attribution of the jitted solver programs (synchronized —
    adds per-call block_until_ready, so totals are upper bounds).

    Hooks EVERY ``*_jit`` attribute on the discipline solvers generically,
    plus the lazily-built programs (the NS flexible f32 chunks per
    ``velo_inner`` k, the MDA device-JNK cycle) and the MDA host-FGMRES
    device helpers — the round-4 direct-p16 profile showed ~19 s of a 28 s
    cached solve outside the previously hooked set."""
    import jax
    phases = {}

    def timed_fn(fn, key):
        phases.setdefault(key, {"t": 0.0, "n": 0})

        def timed(*a, **k):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(*a, **k))
            phases[key]["t"] += time.perf_counter() - t0
            phases[key]["n"] += 1
            return out

        return timed

    def wrap(obj, name, key):
        setattr(obj, name, timed_fn(getattr(obj, name), key))

    for obj, tag in ((ns, "ns"), (cd, "cd")):
        for name in sorted(vars(obj)):
            if name.endswith("_jit") and callable(getattr(obj, name)):
                wrap(obj, name, f"{tag}.{name.strip('_')[:-4]}")

    # lazily-built flexible f32 chunk programs (escalation ladder / PTC)
    for obj, tag in ((ns, "ns"), (cd, "cd")):
        mk = getattr(obj, "_make_fgmres32", None)
        if mk is not None:
            def make_wrapped(mk=mk, tag=tag):
                def wrapped(k):
                    return timed_fn(mk(k), f"{tag}.fgmres32_k{k}")
                return wrapped
            obj._make_fgmres32 = make_wrapped()

    if mda is not None:
        orig_build = mda._build_jnk_cycle

        def build_wrapped():
            return timed_fn(orig_build(), "mda.jnk_cycle")

        mda._build_jnk_cycle = build_wrapped
        # fused host-FGMRES programs (start / per-iteration step)
        orig_build_fused = mda._build_fg_fused

        def build_fused_wrapped():
            startj, stepj = orig_build_fused()
            return (timed_fn(startj, "mda.fg_start"),
                    timed_fn(stepj, "mda.fg_step"))

        mda._build_fg_fused = build_fused_wrapped
        mda._bgs_rhs = timed_fn(mda._bgs_rhs, "mda.bgs_rhs")
        # host-FGMRES device helpers (module-level jits, small per call)
        import sem_jax.coupling.mda as mdamod
        for name in ("_fg_row", "_fg_read_row", "_fg_cgs2", "_fg_update"):
            if hasattr(mdamod, name) and name not in _FG_WRAPPED:
                setattr(mdamod, name,
                        timed_fn(getattr(mdamod, name), f"mda.{name[1:]}"))
                _FG_WRAPPED.add(name)
    # refinement-loop module-level helpers (krylov.refined_gmres_host)
    import sem_jax.krylov as krymod
    for name in ("_accum", "rowscale_prep"):
        if hasattr(krymod, name) and name not in _FG_WRAPPED:
            setattr(krymod, name,
                    timed_fn(getattr(krymod, name),
                             f"kry.{name.strip('_')}"))
            _FG_WRAPPED.add(name)
    return phases


_FG_WRAPPED = set()


def print_phases(phases, label):
    tot = sum(p["t"] for p in phases.values())
    parts = "  ".join(f"{k}={p['t']:.2f}s/{p['n']}x"
                      for k, p in sorted(phases.items()))
    print(f"phases [{label}] (sum {tot:.2f}s): {parts}", flush=True)
    for p in phases.values():
        p["t"], p["n"] = 0.0, 0


def instrument_ns(ns):
    """Accumulate f32 inner iteration/resweep totals across _get_update."""
    orig = ns._get_update
    tot = {"calls": 0, "iters": 0, "resweeps": 0}

    def wrapped(*a, **k):
        out = orig(*a, **k)
        info = ns.last_schur_info
        tot["calls"] += 1
        tot["iters"] += int(info.iterations)
        tot["resweeps"] += int(info.resweeps)
        return out

    ns._get_update = wrapped
    return tot


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--eta", type=float, default=None,
                    help="DGKS resweep threshold (default krylov.DGKS_ETA)")
    ap.add_argument("--restart", type=int, default=None,
                    help="NS GMRES window (default: auto-sized)")
    ap.add_argument("--ra", type=float, default=1e3)
    ap.add_argument("--direct", action="store_true",
                    help="single-level p16 solve from zero (no ladder): "
                         "hundreds of f32 iterations — the clean ms/it "
                         "signal (the warm-started ladder p16 level runs "
                         "only ~36)")
    args = ap.parse_args()

    if args.eta is not None:
        krylov.DGKS_ETA = args.eta
    if args.restart is not None:
        # build_coupled does not forward an NS restart — inject the override
        # at the constructor level for this experiment
        import sem_jax.models.navier_stokes as nsmod
        orig_init = nsmod.NavierStokesSolver.__init__

        def patched(self, *a, **k):
            k.setdefault("restart", args.restart)
            return orig_init(self, *a, **k)

        nsmod.NavierStokesSolver.__init__ = patched

    print(f"config: eta={krylov.DGKS_ETA} restart={args.restart or 'auto'} "
          f"Ra={args.ra:g}", flush=True)

    KW = dict(Re=1e3, Ra=args.ra, Pr=0.71,
              N_ex_cd=32, N_ey_cd=32, N_ex_ns=64, N_ey_ns=64,
              mode="JNK", mtol_nonlin=1e-8, iprint=False)

    if args.direct:
        t0 = time.perf_counter()
        cd, ns, mda = build_coupled(1.0, 1.0, P_cd=16, P_ns=16, **KW)
        tot = instrument_ns(ns)
        phases = instrument_phases(ns, cd, mda)
        print(f"build p16: {time.perf_counter() - t0:.1f}s", flush=True)
        for tag in ("compile", "cached"):
            tot.update(calls=0, iters=0, resweeps=0)
            mda.cd_comp.iter_count_solve = mda.ns_comp.iter_count_solve = 0
            t0 = time.perf_counter()
            s = mda.solve()
            wall = time.perf_counter() - t0
            its, rs = tot["iters"], tot["resweeps"]
            print(f"[{tag}] direct p16: {wall:.2f}s "
                  f"stats={mda.stats.as_list()} NS f32 iters={its} "
                  f"resweeps={rs} ({100 * rs / max(its, 1):.0f}%) "
                  f"~{1e3 * wall / max(its, 1):.1f} ms/it-incl-overhead",
                  flush=True)
            print_phases(phases, tag)
        r = mda._residuals(s)
        print(f"RESULT-direct eta={krylov.DGKS_ETA}: {wall:.2f}s "
              f"iters={its} resweeps={rs} "
              f"|r|={float(np.linalg.norm(r)):.2e}", flush=True)
        return

    levels = {}
    for P in (4, 8, 16):
        t0 = time.perf_counter()
        cd, ns, mda = build_coupled(1.0, 1.0, P_cd=P, P_ns=P, **KW)
        levels[P] = (cd, ns, mda, instrument_ns(ns))
        print(f"build P={P}: {time.perf_counter() - t0:.1f}s", flush=True)

    def ladder(tag):
        s = None
        prev = None
        for P in (4, 8, 16):
            cd, ns, mda, tot = levels[P]
            mda.cd_comp.iter_count_solve = mda.ns_comp.iter_count_solve = 0
            it0, rs0 = tot["iters"], tot["resweeps"]
            if s is not None:
                cd0, ns0 = prev
                s = CoupledState(T=apply_transfer(cd0.grid, cd.grid, s.T),
                                 u=apply_transfer(ns0.grid, ns.grid, s.u),
                                 v=apply_transfer(ns0.grid, ns.grid, s.v),
                                 p=apply_transfer(ns0.grid, ns.grid, s.p))
            t0 = time.perf_counter()
            s = mda.solve(s)
            wall = time.perf_counter() - t0
            its = tot["iters"] - it0
            rs = tot["resweeps"] - rs0
            frac = rs / its if its else 0.0
            print(f"  [{tag}] P={P}: {wall:.2f}s stats={mda.stats.as_list()} "
                  f"NS f32 iters={its} resweeps={rs} ({100 * frac:.0f}%)",
                  flush=True)
            prev = (cd, ns)
        return s, mda

    t0 = time.perf_counter()
    ladder("compile")
    print(f"solve 1 (incl compile): {time.perf_counter() - t0:.1f}s",
          flush=True)
    t0 = time.perf_counter()
    s, mda = ladder("cached")
    wall = time.perf_counter() - t0
    u_anchor = float(jnp.max(jnp.abs(s.u))) * 1e3 * 0.71
    r = mda._residuals(s)
    print(f"RESULT eta={krylov.DGKS_ETA} restart={args.restart or 'auto'}: "
          f"ladder {wall:.2f}s; u_max*RePr={u_anchor:.4f}; "
          f"|r|={float(np.linalg.norm(r)):.2e} "
          f"(atol {mda.atol_nonlin:.2e})", flush=True)


if __name__ == "__main__":
    main()
