"""Device-mesh parallelism (the replacement of MPI/PETSc).

The reference's only multi-process parallelism is a 2-rank MPI disciplinary
split plus PETSc's distributed GMRES (reference Boussinesq_ParallelCoupler.py,
SURVEY.md §2.4-2.5).  Here parallelism is SPMD element-domain decomposition:
fields and element batches shard over a ``jax.sharding.Mesh``; the C0
assembly's interface sum and all Krylov reductions lower to XLA collectives
(NCCL between GPUs).

Multi-host: every process calls
:func:`sem_jax.parallel.init_distributed` first (JAX multi-controller
runtime — the replacement of the reference's ``mpirun``), after which the
same mesh/solver code spans all hosts; ``make_mesh(dcn=True)`` factors the
host boundary into an explicit ``'dcn'`` (between-host) mesh axis.
"""
from sem_jax.parallel.sharding import (make_mesh, use_mesh, active_mesh,
                                       place, field_sharding)
from sem_jax.parallel.distributed import init_distributed, gather_global

__all__ = ["make_mesh", "use_mesh", "active_mesh", "place", "field_sharding",
           "init_distributed", "gather_global"]
