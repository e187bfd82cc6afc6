"""PDE solver models (the reference's L3 layer, reference Solvers/*.py)."""
from sem_jax.models.convection_diffusion import ConvectionDiffusionSolver
from sem_jax.models.navier_stokes import NavierStokesSolver

__all__ = ["ConvectionDiffusionSolver", "NavierStokesSolver"]
