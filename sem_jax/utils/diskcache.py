"""Where the compile cache and the host-side solver constants live, and a
best-effort NPZ disk cache for the latter.

Host-side solver construction is dominated by single-threaded LAPACK
(eigendecompositions of the 1D pencils, the spectral-Schur boundary-ring
inverse), while the results depend only on the grid configuration.
Persisting them next to the XLA compilation cache cuts p16 solver
construction from tens of seconds to load time.

The directory is ``JAX_COMPILATION_CACHE_DIR`` when that is set (JAX reads
it itself), else the fixed ``<checkout>/.jax_cache`` (gitignored) — a fixed
path, because the path is part of what makes a cache entry found again.
``SEM_JAX_CACHE=0`` turns both caches off.
"""
from __future__ import annotations

import os
import typing

import numpy as np

__all__ = ["npz_cached", "cache_dir", "enabled"]

_DEFAULT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _DEFAULT


def enabled() -> bool:
    return os.environ.get("SEM_JAX_CACHE", "1") != "0"


def npz_cached(key: str, builder: typing.Callable[[], dict]) -> dict:
    """Return ``builder()`` (a dict of NumPy arrays), persisted as
    ``<cache_dir>/<key>.npz``.  Caching is best-effort: any I/O failure
    falls back to building in-process."""
    path = os.path.join(cache_dir(), key + ".npz")
    if enabled() and os.path.exists(path):
        try:
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
        except (OSError, ValueError):
            pass
    out = builder()
    if enabled():
        try:
            os.makedirs(cache_dir(), exist_ok=True)
            tmp = path + f".tmp{os.getpid()}.npz"
            np.savez(tmp, **out)
            os.replace(tmp, path)
        except OSError:
            pass
    return out
