"""Program-prefetch subsystem (sem_jax.utils.prefetch + hoist warm mode).

A fresh process otherwise pays each program's first compile (or cache
load) sequentially mid-solve; prefetch (opt-in, ``SEM_JAX_PREFETCH=1``)
records every compiled signature to a manifest and later processes warm
them concurrently.  These tests run the full record → manifest → warm →
solve cycle on CPU with a temporary cache dir.
"""
import json
import os

import numpy as np
import pytest

from sem_jax.models.convection_diffusion import ConvectionDiffusionSolver
from sem_jax.utils import prefetch


def _reset(tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("SEM_JAX_PREFETCH", "1")
    prefetch._manifest = None
    prefetch._dirty = False
    prefetch._live.clear()
    prefetch._warmed.clear()
    for k in prefetch._stats:
        prefetch._stats[k] = 0


def test_record_warm_solve_cycle(tmp_path, monkeypatch):
    _reset(tmp_path, monkeypatch)

    def solve(cd):
        u = np.ones(cd.N)
        v = np.zeros(cd.N)
        return np.asarray(cd._get_solution(u, v))

    # "process 1": solve records signatures, flush writes the manifest
    cd1 = ConvectionDiffusionSolver(1.0, 1.0, Pe=10.0, P=3, N_ex=3, N_ey=3,
                                    T_W=0.5, T_E=-0.5)
    T1 = solve(cd1)
    prefetch.flush()
    man_path = os.path.join(str(tmp_path), "prefetch_manifest.json")
    assert os.path.exists(man_path)
    man = json.load(open(man_path))
    labels = [l for l in man if l.startswith("cd.")]
    assert labels, man.keys()
    assert all("@P3_3x3" in l for l in labels)
    # every signature leaf is a reproducible spec
    for sigs in man.values():
        for sig in sigs:
            assert sig["leaves"], sig
            args = prefetch._rebuild_args(sig)
            assert isinstance(args, tuple)

    # "process 2": a fresh solver warms the recorded signatures
    # concurrently (new wrapper instances — their caches are cold)
    built0 = prefetch.stats()["built"]
    cd2 = ConvectionDiffusionSolver(1.0, 1.0, Pe=10.0, P=3, N_ex=3, N_ey=3,
                                    T_W=0.5, T_E=-0.5)
    prefetch.warm_async(force=True)
    prefetch.barrier()
    st = prefetch.stats()
    assert st["built"] > built0, st
    assert st["failed"] == 0, st
    # the warmed programs produce the identical solution
    T2 = solve(cd2)
    np.testing.assert_allclose(T1, T2, rtol=0, atol=1e-12)


def test_warm_wrong_config_is_harmless(tmp_path, monkeypatch):
    """Manifest signatures that no longer fit (e.g. stale shapes) are
    skipped without breaking construction or solving."""
    _reset(tmp_path, monkeypatch)
    # poison the manifest with a wrong-shaped signature under a real label
    import base64
    import pickle

    import jax
    tree = jax.tree_util.tree_structure((0, 0, 0))
    sig = {"tree": base64.b64encode(pickle.dumps(tree)).decode(),
           "leaves": [{"k": "arr", "s": [7], "d": "float64", "w": False}] * 3}
    os.makedirs(str(tmp_path), exist_ok=True)
    with open(os.path.join(str(tmp_path), "prefetch_manifest.json"),
              "w") as f:
        json.dump({"cd.residual@P3_3x3": [sig]}, f)

    cd = ConvectionDiffusionSolver(1.0, 1.0, Pe=10.0, P=3, N_ex=3, N_ey=3,
                                   T_W=0.5, T_E=-0.5)
    prefetch.warm_async(force=True)
    prefetch.barrier()
    # wrong-shaped warm fails quietly; real solve is unaffected
    u = np.ones(cd.N)
    v = np.zeros(cd.N)
    T = np.asarray(cd._get_solution(u, v))
    assert np.isfinite(T).all()


def test_leaf_specs_roundtrip():
    import jax.numpy as jnp
    leaves = [np.zeros((2, 3), np.float32), jnp.zeros(4, jnp.float64),
              np.float64(1.5), 3, 2.5, True]
    for a in leaves:
        spec = prefetch._leaf_spec(a)
        assert spec is not None, a
        b = prefetch._make_leaf(spec)
        sa = (tuple(getattr(a, "shape", ())),
              str(getattr(a, "dtype", type(a))))
        sb = (tuple(getattr(b, "shape", ())),
              str(getattr(b, "dtype", type(b))))
        assert sa == sb, (a, b)


@pytest.mark.parametrize("env,on", [({}, False),
                                    ({"SEM_JAX_PREFETCH": "1"}, True),
                                    ({"SEM_JAX_PREFETCH": "0"}, False),
                                    ({"SEM_JAX_PREFETCH": "1",
                                      "SEM_JAX_CACHE": "0"}, False)])
def test_prefetch_is_opt_in(monkeypatch, env, on):
    """Prefetch runs dummy executions beside the solve and keeps solvers
    alive, so it is off unless asked for (and never without the cache)."""
    for k in ("SEM_JAX_PREFETCH", "SEM_JAX_CACHE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert prefetch.enabled() is on
    if not on:
        assert prefetch.warm_async() == 0
