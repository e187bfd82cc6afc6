"""Discipline components: the coupling-facing wrappers of the PDE solvers.

Capability parity with the reference's OpenMDAO ``ImplicitComponent`` wrappers
(reference OpenMDAO/ConvectionDiffusion_Component.py:6-61,
OpenMDAO/NavierStokes_Component.py:5-65): each component exposes

* ``apply_nonlinear``  — residual of its outputs given coupled inputs,
* ``linearize``        — precompute Jacobians at the current outputs,
* ``apply_linear``     — forward-mode Jacobian-vector product incl. the
  cross-discipline terms through the mesh transfer,
* ``solve_linear``     — invert the own-block Jacobian (the block-Jacobi
  preconditioner building block),
* ``solve_nonlinear``  — full own-discipline solve with warm starts,

mapped onto the seven-method solver protocol.  The cross-mesh re-basis
(``change_inputs`` in the reference, re-interpolated per call through Python
loops at reference ConvectionDiffusion_Component.py:23-36) is here a
precomputed pair of 1D interpolation matrices applied as two dense matmuls
(``sem_jax.interp.apply_transfer``) — a static linear map, as the reference
itself notes it must be.

Each component counts its linear solves in ``iter_count_solve`` exactly like
the reference (ConvectionDiffusion_Component.py:21, :57, :61;
NavierStokes_Component.py:65 adds the inner-Newton count).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from sem_jax.interp import apply_transfer
from sem_jax.models.convection_diffusion import ConvectionDiffusionSolver
from sem_jax.models.navier_stokes import NavierStokesSolver

__all__ = ["ConvectionDiffusionComponent", "NavierStokesComponent"]


class ConvectionDiffusionComponent:
    """CD discipline: output ``T_cd``; inputs ``u_ns``, ``v_ns``."""

    def __init__(self, solver_cd: ConvectionDiffusionSolver,
                 solver_ns: NavierStokesSolver):
        self.cd = solver_cd
        self.ns = solver_ns
        self.iter_count_solve = 0

    def change_inputs(self, u_ns, v_ns):
        """Re-basis (u, v) from the NS grid onto the CD grid (linear map)."""
        u_cd = apply_transfer(self.ns.grid, self.cd.grid, jnp.asarray(u_ns))
        v_cd = apply_transfer(self.ns.grid, self.cd.grid, jnp.asarray(v_ns))
        return u_cd, v_cd

    def apply_nonlinear(self, T_cd, u_ns, v_ns):
        return self.cd._get_residuals(T_cd, *self.change_inputs(u_ns, v_ns))

    def linearize(self, T_cd, sigma: float = 0.0):
        self.cd._calc_jacobians(T_cd, sigma=sigma)

    def apply_linear(self, dT_cd, du_ns, dv_ns):
        return self.cd._get_dresiduals(dT_cd,
                                       *self.change_inputs(du_ns, dv_ns))

    def solve_linear(self, d_residual, dT0=None, mtol=None,
                     best_effort=False):
        out = self.cd._get_update(d_residual, dT0=dT0, mtol=mtol,
                                  best_effort=best_effort)
        self.iter_count_solve += 1
        return out

    def solve_nonlinear(self, u_ns, v_ns, T0=None, mtol=None):
        out = self.cd._get_solution(*self.change_inputs(u_ns, v_ns), T0=T0,
                                    mtol=mtol)
        self.iter_count_solve += 1  # problem linear: one update per solve
        return out


class NavierStokesComponent:
    """NS discipline: outputs ``u_ns``, ``v_ns``, ``p_ns``; input ``T_cd``."""

    def __init__(self, solver_cd: ConvectionDiffusionSolver,
                 solver_ns: NavierStokesSolver):
        self.cd = solver_cd
        self.ns = solver_ns
        self.iter_count_solve = 0

    def change_inputs(self, T_cd):
        """Re-basis T from the CD grid onto the NS grid (linear map)."""
        return apply_transfer(self.cd.grid, self.ns.grid, jnp.asarray(T_cd))

    def apply_nonlinear(self, u_ns, v_ns, p_ns, T_cd):
        return self.ns._get_residuals(u_ns, v_ns, p_ns,
                                      self.change_inputs(T_cd))

    def linearize(self, u_ns, v_ns, sigma: float = 0.0):
        self.ns._calc_jacobians(u_ns, v_ns, sigma=sigma)

    def apply_linear(self, du_ns, dv_ns, dp_ns, dT_cd):
        return self.ns._get_dresiduals(du_ns, dv_ns, dp_ns,
                                       self.change_inputs(dT_cd))

    def solve_linear(self, dres_u, dres_v, dres_cont,
                     du0=None, dv0=None, dp0=None, mtol=None,
                     best_effort=False):
        out = self.ns._get_update(dres_u, dres_v, dres_cont,
                                  du0=du0, dv0=dv0, dp0=dp0, mtol=mtol,
                                  best_effort=best_effort)
        self.iter_count_solve += 1
        return out

    def solve_nonlinear(self, T_cd, u0=None, v0=None, p0=None, mtol=None):
        out = self.ns._get_solution(self.change_inputs(T_cd),
                                    u0=u0, v0=v0, p0=p0, mtol=mtol)
        self.iter_count_solve += self.ns._k  # inner-Newton update count
        return out
