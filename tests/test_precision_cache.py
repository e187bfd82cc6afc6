"""Float32 products keep full precision, and the caches go where they
should.

On an NVIDIA GPU a float32 contraction without an explicit precision may
run in TF32 (about three decimal digits), which stalls the f32 inner Krylov
solves and pollutes converged solutions.  The audit lowers the main path's
hot programs here on the CPU and checks that every float32 ``dot_general``
in the StableHLO carries ``HIGHEST`` — what the GPU compiler is then bound
to honour.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from sem_jax import operators as ops
from sem_jax.fdm import FDM2D
from sem_jax.krylov import cg, gmres
from sem_jax.mesh import Grid2D
from sem_jax.ops import banded as bd
from sem_jax.utils import diskcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = Grid2D(P=4, N_ex=3, N_ey=4, L_x=1.0, L_y=1.2)
F32 = jnp.float32


def _f32_dots(fn, *args):
    """(total, lacking HIGHEST) f32 dot_general ops in ``fn``'s StableHLO."""
    text = jax.jit(fn).lower(*args).as_text()
    dots = [l for l in text.splitlines()
            if "stablehlo.dot_general" in l and "xf32>" in l]
    bad = [l.strip() for l in dots
           if not re.search(r"precision = \[HIGHEST, HIGHEST\]", l)]
    return len(dots), bad


def _vec(n=None):
    return jax.ShapeDtypeStruct((n or GRID.N,), F32)


def _coupled_args():
    v = _vec()
    return (_vec(3 * GRID.N), v, v, (v, v, v, v),
            jax.ShapeDtypeStruct((GRID.N,), jnp.bool_))


CASES = {
    "cd_apply_dense": (lambda w, u: ops.apply_system(GRID, u, u, w, 2.0),
                       (_vec(), _vec())),
    "cd_apply_banded": (lambda w, u: bd.apply_system_banded_xla(
        GRID, u, u, w, 2.0), (_vec(), _vec())),
    "coupled_dense": (lambda *a: ops.apply_coupled_system(GRID, *a, 3.0),
                      _coupled_args()),
    "coupled_banded": (lambda *a: bd.apply_coupled_system_banded_xla(
        GRID, *a, 3.0), _coupled_args()),
    "fdm_apply": (lambda r: FDM2D(GRID, dirichlet_x=(True, True),
                                  dirichlet_y=(False, True))(r, sigma=0.5),
                  (_vec(),)),
    "gmres_cycle": (lambda b, u: gmres(
        lambda x: ops.apply_system(GRID, u, u, x, 2.0), b,
        atol=jnp.asarray(1e-6, F32), restart=8, maxiter=8,
        precon=FDM2D(GRID))[0], (_vec(), _vec())),
    "cg": (lambda b: cg(lambda x: ops.apply_stiffness(GRID, x)
                        + ops.apply_mass(GRID, x), b,
                        atol=1e-6, maxiter=5)[0], (_vec(),)),
    "transfer": (lambda u: __import__("sem_jax.interp", fromlist=["x"])
                 .apply_transfer(GRID, Grid2D(P=3, N_ex=2, N_ey=2, L_x=1.0,
                                              L_y=1.2), u), (_vec(),)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_f32_dots_are_highest(name):
    fn, args = CASES[name]
    total, bad = _f32_dots(fn, *args)
    assert total > 0, f"{name}: no f32 dot found — the audit saw nothing"
    assert not bad, f"{name}: f32 dots without HIGHEST:\n" + "\n".join(bad)


def test_compile_cache_env_is_honoured(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the compile cache and the NPZ
    constants both go there and no other directory is set in code."""
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path),
               JAX_PLATFORMS="cpu")
    env.pop("SEM_JAX_CACHE", None)
    script = (
        "import jax, sem_jax\n"
        "from sem_jax.utils import diskcache\n"
        "from sem_jax.fdm import FDM2D\n"
        "from sem_jax.mesh import Grid2D\n"
        "FDM2D(Grid2D(P=3, N_ex=2, N_ey=2, L_x=1.0, L_y=1.0))\n"
        "print(jax.config.jax_compilation_cache_dir, diskcache.cache_dir())\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(tmp_path), str(tmp_path)]
    assert any(f.endswith(".npz") for f in os.listdir(tmp_path))


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    """Unset, the cache is the one fixed, gitignored path in the checkout
    (never built from a temp name, pid or time)."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert diskcache.cache_dir() == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
    monkeypatch.setenv("SEM_JAX_CACHE", "0")
    assert not diskcache.enabled()
    calls = []
    out = diskcache.npz_cached("never_written",
                               lambda: calls.append(1) or {"a": np.ones(2)})
    assert calls and not os.path.exists(
        os.path.join(diskcache.cache_dir(), "never_written.npz"))
    assert np.array_equal(out["a"], np.ones(2))


def test_env_knob_list_is_complete():
    """Every ``SEM_JAX_*`` variable the package reads is a listed knob, so
    the old-name check covers all of them."""
    import sem_jax
    src = os.path.join(REPO, "sem_jax")
    read = set()
    for root, _, files in os.walk(src):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    read |= set(re.findall(r"SEM_JAX_([A-Z0-9_]*[A-Z0-9])",
                                           f.read()))
    assert read and read <= set(sem_jax.ENV_KNOBS), read - set(
        sem_jax.ENV_KNOBS)


@pytest.mark.parametrize("env,bad", [
    ({"SEM_JAX_FUSED_WINDOW": "3", "SEMAPHORE_X": "1"}, None),
    ({"SEM_OLD_FUSED_WINDOW": "3"}, "SEM_JAX_FUSED_WINDOW"),
    ({"SEM_OLD_APPLY_KERNEL": "xla"}, "removed"),
    ({"SEM_OLD_CACHE_DIR": "/x"}, "JAX_COMPILATION_CACHE_DIR"),
])
def test_old_knob_names_are_refused(env, bad):
    """A knob under another ``SEM_<prefix>_`` name raises, naming what to
    set instead; the package's own names and unrelated variables pass."""
    import sem_jax
    if bad is None:
        sem_jax.check_env(env)
        return
    with pytest.raises(RuntimeError, match=bad):
        sem_jax.check_env(env)
