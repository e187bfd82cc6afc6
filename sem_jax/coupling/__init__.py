"""Multidisciplinary coupling layer (the reference's L4, reference OpenMDAO/*).

Pure-JAX re-design: no OpenMDAO, no MPI, no PETSc.  The implicit-component
graph + Newton/Gauss-Seidel MDA machinery of the reference becomes a small
explicit engine (``sem_jax.coupling.mda``) operating on the seven-method
discipline protocol, with the cross-mesh transfer as precomputed tensor-product
interpolation matrices.
"""
from sem_jax.coupling.components import (ConvectionDiffusionComponent,
                                         NavierStokesComponent)
from sem_jax.coupling.mda import BoussinesqMDA, MDAStats
from sem_jax.coupling.boussinesq import run, run_parallel, build_coupled

__all__ = [
    "ConvectionDiffusionComponent",
    "NavierStokesComponent",
    "BoussinesqMDA",
    "MDAStats",
    "run",
    "run_parallel",
    "build_coupled",
]
