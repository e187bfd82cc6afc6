"""Mesh construction and field placement for SPMD execution.

Model (SURVEY.md §5.7-5.8): the element grid is the "long axis".  A global
field in x-major flat order shards contiguously along its single dimension —
equivalently, grid-form ``(Ngx, Ngy)`` shards by rows — which is an x-strip
domain decomposition.  Every operator in ``sem_jax.operators`` is
sharding-agnostic: under ``jit`` XLA's SPMD partitioner propagates the input
sharding through the gathers, batched contractions, segment-sums (the C0
interface sum becomes a neighbor exchange), and dense 1D matmuls, and inserts
the collectives; Krylov dot products become ``psum`` over the mesh — the
direct replacement of PETSc's MPI reductions (reference
Boussinesq_ParallelCoupler.py:91-93).

Placement is the only knob: wrap a region in ``use_mesh(mesh)`` and every
field entering the jitted kernels is ``device_put`` with the row sharding, so
the same solver code runs single-chip or multi-chip.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "use_mesh", "active_mesh", "place", "field_sharding"]

_state = threading.local()


def make_mesh(devices=None, axis_name: str = "x", dcn: bool = None) -> Mesh:
    """Device mesh over ``devices`` (default: ALL global devices — in a
    multi-process run, :func:`jax.devices` spans every host).

    :param dcn: add a leading ``'dcn'`` (between-host) mesh axis along
        process (= host) boundaries, making the inter-host topology explicit
        to XLA's collective scheduler: fields shard over
        ``('dcn', axis_name)`` jointly, so each host owns a contiguous
        x-strip block, intra-host traffic stays on the host's own links
        (NVLink between the GPUs of one host), and only the strip-boundary
        exchanges cross the network (SURVEY.md §5.8).  Default ``None`` = automatic (on whenever the
        participating devices span >1 process).  The numerical layout is
        identical to the flat 1D mesh — only the axis factorization differs.
    """
    if devices is None:
        devices = jax.devices()
    devices = list(devices)
    procs = sorted({d.process_index for d in devices})
    explicit = dcn is not None
    if dcn is None:
        dcn = len(procs) > 1
    if dcn and len(procs) > 1:
        by_proc = {p: [] for p in procs}
        for d in devices:              # jax.devices() is process-ordered,
            by_proc[d.process_index].append(d)  # but never rely on it
        per = len(devices) // len(procs)
        if (len(devices) % len(procs) == 0
                and all(len(v) == per for v in by_proc.values())):
            arr = np.empty((len(procs), per), dtype=object)
            for i, p in enumerate(procs):
                arr[i, :] = by_proc[p]
            return Mesh(arr, ("dcn", axis_name))
        # uneven per-process device counts cannot factor along the host
        # boundary.  An EXPLICIT dcn=True request errors (downstream code
        # keyed on the ('dcn', axis) factorization would break far from
        # the cause); the automatic default degrades to the flat 1D mesh,
        # which is numerically equivalent.
        if explicit:
            raise ValueError(
                f"make_mesh(dcn=True): cannot factor {len(devices)} devices "
                f"into a ('dcn', '{axis_name}') mesh — per-process device "
                f"counts are uneven: "
                f"{ {p: len(v) for p, v in by_proc.items()} }")
    elif dcn and explicit and len(procs) <= 1:
        raise ValueError(
            "make_mesh(dcn=True): only one process participates — there is "
            "no host boundary to factor (did init_distributed run?)")
    return Mesh(np.array(devices), (axis_name,))


def active_mesh() -> Mesh | None:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Activate a mesh: fields placed via :func:`place` shard over it."""
    prev = active_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def field_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding of a flat global field: contiguous chunks along ALL mesh
    axes jointly (= grid-form row strips, an x-direction domain
    decomposition).  On a 2-level ``('dcn', 'x')`` mesh the joint spec keeps
    each host's strips contiguous, so only strip boundaries cross hosts."""
    return NamedSharding(mesh, P(tuple(mesh.axis_names)))


def place(x, dtype=None):
    """Convert to a jnp array with a *canonical* layout over the active mesh.

    This is the single entry point the solvers use to ingest fields; with no
    active mesh it is ``jnp.asarray``.  Divisible lengths get the row-strip
    sharding; SEM global vectors of odd length (N_e·P+1 per direction), which
    ``device_put`` cannot split evenly, are **explicitly replicated** and
    re-sharded by the :func:`constrain` annotations inside the jitted kernels
    (GSPMD pads internally).

    The explicit replication is load-bearing, not cosmetic: outputs of jitted
    kernels carry whatever sharding GSPMD's auto-propagation chose (e.g. a
    ``[4,2] last_tile_dim_replicate`` tiling leaking out of the residual
    program), and feeding such arrays into the compiled Krylov programs was
    observed to produce *numerically wrong* solves (residual growth above
    ‖b‖ in f64 right-preconditioned GMRES with bit-identical input values —
    only the input layout differed).  Normalizing every program-boundary
    crossing to a deterministic layout removes the entire class.
    """
    import jax.numpy as jnp
    x = jnp.asarray(x, dtype=dtype)
    mesh = active_mesh()
    if mesh is not None and x.ndim == 1:
        if x.shape[0] % mesh.devices.size == 0:
            x = jax.device_put(x, field_sharding(mesh))
        else:
            x = jax.device_put(x, NamedSharding(mesh, P()))
    return x


def constrain(x):
    """Sharding constraint for a global field *inside* jitted code.

    Reads the active mesh at trace time: a solver whose kernels are first
    traced inside a ``use_mesh`` region bakes row-strip sharding constraints
    into its compiled programs, and XLA's SPMD partitioner propagates the
    sharding through gathers, segment-sums, and matmuls, inserting the
    collectives.  With no active mesh this is the identity.
    """
    mesh = active_mesh()
    if mesh is None or x.ndim != 1:
        return x
    return jax.lax.with_sharding_constraint(x, field_sharding(mesh))
