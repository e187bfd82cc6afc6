"""Shared pseudo-transient-continuation (PTC) Δt controller.

One SER/trust-region implementation used by BOTH PTC drivers —
:meth:`sem_jax.models.navier_stokes.NavierStokesSolver.solve_ptc` (standalone
NS) and :meth:`sem_jax.coupling.mda.BoussinesqMDA._solve_ptc` (coupled) — so
controller lessons propagate to both (the two loops had once drifted to
different constants and features).  The unified semantics are
the coupled controller's, which subsumes the standalone one:

* **SER (switched evolution relaxation)**: on every non-blowup step,
  ``Δt_{k+1} = Δt_k · ‖F_k‖/‖F_{k+1}‖``, growth-capped at ``growth`` and
  shrink-capped at 10× — steps are always *accepted* (the physical transient
  may transiently raise ‖F‖, e.g. the first step imposing Dirichlet walls on
  an inconsistent initial state; a monotone line search deadlocks there).
* **Blowup rejection**: a non-finite or >1e3× residual jump rejects the step
  and damps Δt 10× (re-solve about the same state).
* **Linear-failure-gated shrink + Δt trust-region ceiling**: a linear solve
  that stalled far above its target marks the current Δt band uncrackable —
  cut Δt 4× when the step also went nowhere, and hold a ceiling at half the
  failing Δt so SER does not immediately re-enter the bad band (measured:
  without the ceiling the controller oscillates, re-growing into failure
  every few steps near a near-singular large-Δt Jacobian).  The ceiling
  relaxes ``CEIL_RELAX``× per healthy step.  Slow-but-real progress with a
  healthy linear solve is the normal transient march and must NOT shrink Δt.

The controller is pure host-side state (two floats); the mass shift
σ = scale/Δt it implies is carried in the solvers' Jacobian *diagonals* (GLL
mass is diagonal) and matched spectrally by every preconditioner, so ramping
Δt never recompiles (see the callers' docstrings).

Capability beyond the reference, whose Newton loops simply diverge in the
convection-dominated regimes PTC unlocks (reference
NavierStokes_Solver.py:253-268; PTC reaches steady Ra=1e5/1e6 from zero,
Boussinesq_study/BoussinesqPTC_*).
"""
from __future__ import annotations

__all__ = ["SERController"]


class SERController:
    """SER Δt controller with blowup damping and a linear-failure trust
    region.  Drive it with exactly one of :meth:`reject_blowup` (step
    rejected, state unchanged) or :meth:`accept` (step taken) per PTC step.
    """

    #: growth cap of the per-step SER ratio is ``growth`` (ctor); these are
    #: the remaining shared constants, measured in round 3 (coupled PTC):
    SHRINK_BLOWUP = 0.1    # Δt factor on a rejected (blown-up) step
    SHRINK_LINFAIL = 0.25  # Δt factor when the linear solve failed AND the
    #                        step went nowhere (<5% residual drop)
    RATIO_FLOOR = 0.1      # SER shrink cap on accepted steps
    CEIL_RELAX = 1.25      # trust-region ceiling relaxation per healthy step
    #   (was 1.5 through round 4; at Ra=1e8 p16 the 1.5 relax re-entered the
    #   uncrackable Δt band every ~3 steps and each probe ground the full
    #   per-step linear-effort cap.  1.25 spaces the probes ~6 steps
    #   apart; the forecast exit (mda._fgmres) makes each probe cheap)
    NOPROGRESS = 0.95      # "went nowhere": ‖F_new‖ > 0.95·‖F_old‖

    def __init__(self, dt0: float, growth: float = 3.0,
                 dt_max: float = 1e12, dt_min: float = 1e-10):
        self.dt = float(dt0)
        self.growth = float(growth)
        self.dt_max = float(dt_max)
        self.dt_min = float(dt_min)
        self.dt_ceil = float(dt_max)

    def reject_blowup(self) -> bool:
        """Step rejected (non-finite / >1e3× residual jump): damp Δt 10×.

        :return: False when Δt has collapsed below ``dt_min`` — the caller
            should abort (the system is not crackable at any shift).
        """
        self.dt = self.dt * self.SHRINK_BLOWUP
        return self.dt >= self.dt_min

    def reject_linfail(self) -> bool:
        """Step rejected because its linear solve FAILED and the update
        RAISED the residual: a dx that does not solve the implicit-Euler
        system is not a pseudo-time step, so re-solving about the same
        state at the damped Δt is strictly safer than walking it.  Damp Δt
        4× and hold the trust-region ceiling at half the failing Δt; the
        caller bounds consecutive rejections (a residual rise with a
        HEALTHY linear solve is the normal oscillatory transient and must
        still be accepted — SER's always-accept rationale; measured: the
        coarse-grid limit cycles / spurious-root captures all had healthy
        solves, so this rejection correctly does NOT fire there).

        :return: False when Δt has collapsed below ``dt_min``.
        """
        self.dt_ceil = max(self.dt / 2.0, self.dt_min)
        self.dt = self.dt * self.SHRINK_LINFAIL
        return self.dt >= self.dt_min

    def accept(self, norm_old: float, norm_new: float,
               lin_failed: bool) -> None:
        """Step accepted: apply SER + the linear-failure trust region.

        :param norm_old/norm_new: nonlinear residual norms before/after
        :param lin_failed: the step's linear solve stalled far above its
            target (including a raised/aborted solve treated as a zero step)
        """
        if lin_failed:
            # this Δt band is uncrackable: ceiling at half the failing Δt
            self.dt_ceil = max(self.dt / 2.0, self.dt_min)
        if lin_failed and norm_new > self.NOPROGRESS * norm_old:
            self.dt = max(self.dt * self.SHRINK_LINFAIL, self.dt_min)
        else:
            if not lin_failed:
                self.dt_ceil = min(self.dt_ceil * self.CEIL_RELAX,
                                   self.dt_max)
            ratio = norm_old / max(norm_new, 1e-300)
            self.dt = min(self.dt * min(max(ratio, self.RATIO_FLOOR),
                                        self.growth),
                          self.dt_ceil)
