"""sem_jax — a JAX (XLA/sharding) spectral-element framework.

Re-designed from scratch with the capabilities of the reference Galerkin SEM
framework (Tangxiaotian11/SEM): Gauss-Legendre-Lobatto nodal bases, 2D
continuous-Galerkin tensor-product discretization, steady convection-diffusion
and Navier-Stokes (Boussinesq) solvers, and multidisciplinary coupling with
nonlinear Gauss-Seidel / Newton-block-Jacobi / block-Jacobi-preconditioned
Newton-Krylov MDA schemes.

Architectural differences from the reference (see SURVEY.md §7):

* **Matrix-free everywhere.** The reference eagerly assembles global SciPy CSR
  matrices and rank-3 sparse convection tensors (reference SEM.py:113-146,
  :226-245).  Here every operator is applied matrix-free: linear operators
  (mass/stiffness/gradient) exploit the global tensor-product structure
  ``A = A1x ⊗ M1y + M1x ⊗ A1y`` and are applied as two dense 1D matmuls on the
  field in grid form — matmul-shaped work; the nonlinear convection term is a
  batched per-element sum-factorization contraction plus a C0 scatter-add
  (``segment_sum``).
* **Fast-diagonalization direct solves** replace SuperLU (reference
  NavierStokes_Solver.py:184): on the uniform tensor-product mesh the
  Dirichlet-restricted Laplacian is inverted *exactly* by a generalized
  eigendecomposition per dimension and four dense matmuls per apply.
* **jit-compiled restarted GMRES** (``lax.while_loop``) replaces SciPy LGMRES
  (reference ConvectionDiffusion_Solver.py:146, NavierStokes_Solver.py:222).
* **Pure-JAX MDA couplers** replace OpenMDAO + MPI + PETSc (reference
  OpenMDAO/*); disciplinary fields shard over a ``jax.sharding.Mesh`` with XLA
  collectives instead of MPI messages.

float64 is enabled at import because the reference's Newton iterations
converge to 1e-13 rms residuals (reference NavierStokes_Solver.py:13);
the inner Krylov solves run their operators in float32 inside float64
iterative refinement.
"""
import os as _os

import jax

#: The package's environment knobs, read as ``SEM_JAX_<name>``.
ENV_KNOBS = ("CACHE", "PREFETCH", "PREFETCH_WORKERS", "DEVICE_KRYLOV_MAX_DOF",
             "PTC_DEVICE_MAX_DOF", "FUSED_WINDOW", "FUSED_PC", "FG_FUSED",
             "ADJ_INNER_F32_MIN_DOF", "COORDINATOR", "NUM_PROCESSES",
             "PROCESS_ID")
_REMOVED_KNOBS = {"APPLY_KERNEL": "the apply form follows platform and mesh",
                  "CACHE_DIR": "set JAX_COMPILATION_CACHE_DIR instead"}


def check_env(environ=_os.environ) -> None:
    """Refuse knob names from an earlier package prefix.

    A knob set under another ``SEM_<prefix>_`` name would be ignored and
    could silently change which solver path runs, so it is an error that
    names the variable to set instead."""
    stale = []
    for key in environ:
        parts = key.split("_", 2)
        if len(parts) < 3 or parts[0] != "SEM" or parts[1] == "JAX":
            continue
        if parts[2] in ENV_KNOBS:
            stale.append(f"{key} (set SEM_JAX_{parts[2]})")
        elif parts[2] in _REMOVED_KNOBS:
            stale.append(f"{key} (removed: {_REMOVED_KNOBS[parts[2]]})")
    if stale:
        raise RuntimeError("sem_jax: environment knobs under an old name: "
                           + "; ".join(sorted(stale)))


check_env()

jax.config.update("jax_enable_x64", True)

# The solver megakernels (nested Krylov under jit) take minutes to compile;
# the persistent compilation cache makes every later process start fast.
# JAX_COMPILATION_CACHE_DIR places it (JAX reads it itself); otherwise it is
# the fixed <checkout>/.jax_cache.  SEM_JAX_CACHE=0 turns it off.
from sem_jax.utils import diskcache as _diskcache

if _diskcache.enabled():
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          _diskcache.cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from sem_jax import gll
from sem_jax.mesh import Grid2D
from sem_jax import operators
from sem_jax.krylov import gmres, cg
from sem_jax.fdm import FDM2D
from sem_jax.models.convection_diffusion import ConvectionDiffusionSolver
from sem_jax.models.navier_stokes import NavierStokesSolver

__version__ = "0.1.0"

__all__ = [
    "gll",
    "Grid2D",
    "operators",
    "gmres",
    "cg",
    "FDM2D",
    "ConvectionDiffusionSolver",
    "NavierStokesSolver",
]
