"""Multi-host (multi-process) execution entry point.

The reference's parallel coupler genuinely runs TWO OS processes under MPI
(reference OpenMDAO/Boussinesq_ParallelCoupler.py:8-9 ``MPI.COMM_WORLD``,
:115 final gather).  The JAX analog (SURVEY.md §5.8) is the
multi-controller runtime: every process calls
:func:`jax.distributed.initialize`, after which ``jax.devices()`` returns the
GLOBAL device set, single-program SPMD code runs unchanged, and XLA routes
the collectives (NCCL between GPUs: NVLink within a host, the network
across hosts).  On one GPU host a single process drives all of its cards
and needs none of this.  No
application-level message passing exists anywhere — the same
``use_mesh(make_mesh())`` + jitted-solver path as single-process.

Launch recipe (every process runs the SAME script):

    # per process (CPU example; under a cluster manager that JAX detects
    # the three values come from its environment):
    SEM_JAX_COORDINATOR=host0:12345 SEM_JAX_NUM_PROCESSES=2 \
    SEM_JAX_PROCESS_ID=<rank> python my_run.py

    # my_run.py
    from sem_jax.parallel import init_distributed, make_mesh, use_mesh
    init_distributed()                      # reads the SEM_JAX_* env vars
    with use_mesh(make_mesh()):             # mesh over ALL global devices
        ... build_coupled(...).solve() ...  # unchanged solver code

Host-side orchestration (Newton loops, mixed-precision refinement, Δt
controllers) executes identically in every process: the scalars it branches
on (residual norms, iteration counts) are replicated jit outputs, so control
flow cannot diverge.  SEM global vectors are replicated across processes
(``place`` — odd lengths) or row-strip sharded (divisible lengths); fully
sharded results can be fetched everywhere with :func:`gather_global`.

Validated by a 2-process × 2-virtual-CPU-device smoke test
(tests/test_multiprocess.py) that reproduces the single-process coupled
result — the moral equivalent of the reference's single-box ``mpirun -n 2``
study runs (reference study/Boussinesq_run.py:65-93).
"""
from __future__ import annotations

import os

import jax

__all__ = ["init_distributed", "gather_global"]


def init_distributed(coordinator_address: str = None,
                     num_processes: int = None,
                     process_id: int = None,
                     local_device_count: int = None):
    """Initialize the JAX multi-controller runtime for this process.

    Must run before any backend-initializing JAX call.  Arguments default to
    the ``SEM_JAX_COORDINATOR`` / ``SEM_JAX_NUM_PROCESSES`` /
    ``SEM_JAX_PROCESS_ID`` environment variables; with everything unset the
    call delegates to :func:`jax.distributed.initialize`'s own
    auto-detection (cluster-manager environment).

    :param local_device_count: optional CPU-only convenience — force this
        many virtual host devices per process (sets the XLA flag; must be
        called before backend init)
    :return: ``(process_index, process_count)``
    """
    if local_device_count:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags
                + f" --xla_force_host_platform_device_count"
                  f"={int(local_device_count)}").strip()
        else:
            import re
            m = re.search(r"xla_force_host_platform_device_count=(\d+)",
                          flags)
            if m and int(m.group(1)) != int(local_device_count):
                # never silently ignore the explicit request: the global
                # mesh shape would differ from what the caller asked for,
                # breaking far from the cause
                raise ValueError(
                    f"init_distributed(local_device_count="
                    f"{local_device_count}) conflicts with XLA_FLAGS "
                    f"already forcing {m.group(1)} host devices; unset "
                    f"XLA_FLAGS or drop the argument")
    coordinator_address = (coordinator_address
                           or os.environ.get("SEM_JAX_COORDINATOR"))
    if num_processes is None and os.environ.get("SEM_JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["SEM_JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("SEM_JAX_PROCESS_ID"):
        process_id = int(os.environ["SEM_JAX_PROCESS_ID"])
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return jax.process_index(), jax.process_count()


def gather_global(x):
    """Fetch a (possibly cross-process-sharded) array as a full NumPy copy
    in EVERY process — the replacement of the reference's final
    ``MPI.COMM_WORLD.gather`` (reference Boussinesq_ParallelCoupler.py:115).

    Replicated arrays (the normal solver outputs) short-circuit to a local
    copy; sharded ones go through an all-gather collective.
    """
    import numpy as np

    if jax.process_count() == 1 or getattr(x, "sharding",
                                           None) is None \
            or x.sharding.is_fully_replicated:
        return np.asarray(x)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
