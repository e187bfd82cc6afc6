"""Concurrent first-call prefetch of the jitted solver programs (opt-in).

A solve reaches each of its programs for the first time somewhere inside the
Newton/Krylov/MDA control flow, so a fresh process pays every program's
compile (or persistent-cache load) sequentially.  This module lets a later
process pay them concurrently, right after solver construction:

* :func:`note` — :func:`sem_jax.utils.hoist.jit_hoisted` reports every
  (label, argument signature) it compiles; signatures are persisted to
  ``<cache_dir>/prefetch_manifest.json`` next to the XLA jit cache.
* :func:`register` — every live hoisted wrapper registers itself under its
  label (labels carry the grid configuration, so a P=4 solver never warms
  P=16 signatures).
* :func:`warm_async` — for each live wrapper, every manifest signature
  recorded by a previous process is re-dispatched with zero-filled dummy
  arguments from a thread pool.  The wrapper's per-signature build lock
  (hoist.py) makes this race-free against the real solve: whichever thread
  gets there first builds, the other waits.

The warm calls are real executions on the device beside the solve, and the
registry keeps every registered solver alive, so prefetch is off unless
``SEM_JAX_PREFETCH=1`` (whether it pays on the H100 is not measured yet).
``SEM_JAX_PREFETCH_WORKERS`` sets the pool size (default 8).

The reference has no analog (it pays no compilation; SuperLU factors at
solve time instead — reference NavierStokes_Solver.py:184).
"""
from __future__ import annotations

import atexit
import base64
import json
import os
import pickle
import threading

import numpy as np

from sem_jax.utils import diskcache

__all__ = ["note", "register", "warm_async", "barrier", "enabled", "stats"]

_lock = threading.RLock()
_live: dict = {}          # label -> [wrapper, ...] (strong refs; solvers
                          # are long-lived and processes short)
_manifest = None          # label -> [sig dict, ...]
_dirty = False
_warmed: set = set()      # (id(wrapper), sig_json) already submitted
_futures: list = []
_pool = None
_stats = {"submitted": 0, "built": 0, "failed": 0}
_MAX_SIGS_PER_LABEL = 12


def enabled() -> bool:
    return (os.environ.get("SEM_JAX_PREFETCH") == "1"
            and diskcache.enabled())


def _path() -> str:
    return os.path.join(diskcache.cache_dir(), "prefetch_manifest.json")


def _load():
    global _manifest
    if _manifest is None:
        _manifest = {}
        try:
            with open(_path()) as f:
                _manifest = json.load(f)
        except (OSError, ValueError):
            pass
    return _manifest


def flush():
    """Merge-write the manifest (atomic, best-effort)."""
    global _dirty
    with _lock:
        if not _dirty or _manifest is None or not diskcache.enabled():
            return
        try:
            on_disk = {}
            try:
                with open(_path()) as f:
                    on_disk = json.load(f)
            except (OSError, ValueError):
                pass
            for label, sigs in _manifest.items():
                have = on_disk.setdefault(label, [])
                for s in sigs:
                    if s not in have and len(have) < _MAX_SIGS_PER_LABEL:
                        have.append(s)
            os.makedirs(diskcache.cache_dir(), exist_ok=True)
            tmp = _path() + f".tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(on_disk, f)
            os.replace(tmp, _path())
            _dirty = False
        except OSError:
            pass


atexit.register(flush)


def _leaf_spec(a):
    """JSON-able spec of one flattened argument leaf, exact enough to
    reproduce the jit signature (shape, dtype, weak_type; python scalars
    by value).  Returns None for unsupported leaf types."""
    shape = getattr(a, "shape", None)
    dtype = getattr(a, "dtype", None)
    if shape is not None and dtype is not None:
        # numpy scalars subclass python float/int but carry shape/dtype —
        # they take this branch so the jit key (shape, dtype) reproduces
        return {"k": "arr", "s": list(shape), "d": str(dtype),
                "w": bool(getattr(a, "weak_type", False))}
    kind = type(a).__name__
    if isinstance(a, (bool, int, float, complex)) and \
            kind in ("bool", "int", "float", "complex"):
        v = a if kind != "complex" else [a.real, a.imag]
        return {"k": "py", "t": kind, "v": v}
    return None


def _make_leaf(spec):
    """Zero-filled dummy leaf reproducing the recorded jit signature
    (shape, dtype, weak_type; python scalars by value).  Warm calls are
    real executions, so the first execution's one-off costs are paid in
    the warm thread too."""
    import jax.numpy as jnp
    if spec["k"] == "py":
        v = spec["v"]
        return {"bool": bool, "int": int, "float": float,
                "complex": lambda x: complex(x[0], x[1])}[spec["t"]](v)
    x = jnp.zeros(tuple(spec["s"]), np.dtype(spec["d"]))
    if spec.get("w"):
        try:  # no public weak_type constructor; best-effort private one
            from jax._src.lax.lax import _convert_element_type
            x = _convert_element_type(x, np.dtype(spec["d"]), weak_type=True)
        except Exception:
            pass
    return x


def _sig_arg_bytes(sig) -> int:
    return sum(int(np.prod(s["s"])) * np.dtype(s["d"]).itemsize
               for s in sig["leaves"] if s["k"] == "arr")


def note(label: str, args):
    """Record the signature of a freshly-compiled call (from jit_hoisted)."""
    if not label:
        return
    global _dirty
    import jax
    flat, tree = jax.tree_util.tree_flatten(args)
    specs = [_leaf_spec(a) for a in flat]
    if any(s is None for s in specs):
        return
    try:
        tree_b64 = base64.b64encode(pickle.dumps(tree)).decode()
    except Exception:
        return
    sig = {"tree": tree_b64, "leaves": specs}
    with _lock:
        sigs = _load().setdefault(label, [])
        if sig not in sigs and len(sigs) < _MAX_SIGS_PER_LABEL:
            sigs.append(sig)
            _dirty = True


def known_labels(prefix: str = ""):
    """Manifest labels starting with ``prefix`` (for eager construction of
    lazily-built program sets a previous process recorded)."""
    with _lock:
        return [l for l in _load() if l.startswith(prefix)]


def register(label: str, wrapper):
    """Make a hoisted wrapper visible to :func:`warm_async`."""
    if not label:
        return
    with _lock:
        _live.setdefault(label, []).append(wrapper)


def _rebuild_args(sig):
    import jax
    tree = pickle.loads(base64.b64decode(sig["tree"]))
    leaves = [_make_leaf(s) for s in sig["leaves"]]
    return jax.tree_util.tree_unflatten(tree, leaves)


# concurrent dummy EXECUTIONS allocate real device buffers (megakernel
# arguments reach GiB scale at p16); cap how many large-argument warms run
# at once so the transient working sets cannot OOM the device
_big_sem = threading.Semaphore(2)
_BIG_BYTES = 64 * 1024 * 1024


def _warm_one(wrapper, sig):
    try:
        big = _sig_arg_bytes(sig) > _BIG_BYTES
        if big:
            _big_sem.acquire()
        try:
            args = _rebuild_args(sig)
            # real call: pays trace + compile (or cache load) + one
            # execution; the per-key lock in hoist.py dedups vs the solve
            # and other warm threads, so each is paid exactly once
            wrapper(*args)
        finally:
            if big:
                _big_sem.release()
        _stats["built"] += 1
    except Exception:           # wrong-epoch signature etc. — harmless
        _stats["failed"] += 1


def warm_async(force: bool = False):
    """Submit concurrent first-calls for every (live wrapper, recorded
    signature) pair not yet warmed.  Returns the number submitted.
    Idempotent and cheap to call after each solver construction."""
    if not (force or enabled()):
        return 0
    global _pool
    manifest = _load()
    tasks = []
    with _lock:
        if _pool is None:
            from concurrent.futures import ThreadPoolExecutor
            _pool = ThreadPoolExecutor(
                max_workers=int(os.environ.get(
                    "SEM_JAX_PREFETCH_WORKERS", "8")),
                thread_name_prefix="sem_jax_prefetch")
        for label, wrappers in _live.items():
            for sig in manifest.get(label, []):
                key_base = json.dumps(sig, sort_keys=True)
                for w in wrappers:
                    key = (id(w), key_base)
                    if key in _warmed:
                        continue
                    _warmed.add(key)
                    tasks.append((w, sig))
    for w, sig in tasks:
        _futures.append(_pool.submit(_warm_one, w, sig))
    _stats["submitted"] += len(tasks)
    return len(tasks)


def barrier():
    """Block until all submitted warm-ups finish (benchmark hygiene)."""
    with _lock:
        fs, _futures[:] = list(_futures), []
    for f in fs:
        try:
            f.result()
        except Exception:
            pass


def stats() -> dict:
    return dict(_stats)
