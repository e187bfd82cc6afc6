"""Checkpoint / resume of coupled solver state.

The reference has **no** mid-solve checkpointing — only end-of-run ``.npz``
dumps keyed by a config-encoding filename (reference
study/Boussinesq_run.py:125-135) and warm-start threading of previous
outputs through the OpenMDAO components (SURVEY.md §5.4).  This module is the
capability upgrade SURVEY.md §5.4 calls for: persist the full coupled iterate
``(T, u, v, p)`` + iteration counters + the generating configuration, and
resume an MDA from it (every solver/MDA entry point accepts initial guesses,
so a loaded state warm-starts exactly).

Format: a single ``.npz`` (portable, dependency-free).  The configuration is
stored as a JSON string and verified on load — resuming onto a mismatched
discretization raises instead of silently interpolating.
"""
from __future__ import annotations

import json

import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint"]

_FORMAT_VERSION = 1


def save_checkpoint(path: str, state, config: dict, stats=None,
                    extras: dict = None) -> None:
    """Persist a coupled iterate.

    :param path: target ``.npz`` path
    :param state: ``sem_jax.coupling.mda.CoupledState`` (or any object with
        T/u/v/p array attributes)
    :param config: the configuration dict that generated the state (verified
        on load)
    :param stats: optional ``MDAStats`` to carry iteration counters
    :param extras: optional JSON-able scalars to carry solver-controller
        state across resumes (e.g. the PTC pseudo-time step ``ptc_dt`` — a
        resumed march that restarts the SER ramp at Δt₀ re-crawls dozens of
        cheap steps it already took)
    """
    meta = {"version": _FORMAT_VERSION, "config": config}
    if extras:
        meta["extras"] = extras
    arrays = dict(T=np.asarray(state.T), u=np.asarray(state.u),
                  v=np.asarray(state.v), p=np.asarray(state.p))
    if stats is not None:
        arrays["iters"] = np.array([stats.cd_solves, stats.ns_solves,
                                    stats.nonlinear_iters, stats.gmres_iters])
    np.savez(path, meta=json.dumps(meta), **arrays)


def load_checkpoint(path: str, expect_config: dict = None,
                    with_extras: bool = False):
    """Load a coupled iterate; returns ``(CoupledState, config, iters)``,
    plus the saved ``extras`` dict as a fourth element when
    ``with_extras=True``.

    :param expect_config: if given, raises ValueError on any mismatch with
        the stored configuration.
    """
    from sem_jax.coupling.mda import CoupledState
    import jax.numpy as jnp

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("version") != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {meta.get('version')}")
        config = meta["config"]
        if expect_config is not None:
            mismatched = {k: (config.get(k), v) for k, v in
                          expect_config.items() if config.get(k) != v}
            if mismatched:
                raise ValueError(f"checkpoint config mismatch: {mismatched}")
        state = CoupledState(jnp.asarray(z["T"]), jnp.asarray(z["u"]),
                             jnp.asarray(z["v"]), jnp.asarray(z["p"]))
        iters = z["iters"].tolist() if "iters" in z else None
        extras = meta.get("extras", {})
    if with_extras:
        return state, config, iters, extras
    return state, config, iters
