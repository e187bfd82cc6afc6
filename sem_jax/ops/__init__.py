"""Banded operator applies (plain XLA) and the choice of apply form."""
from sem_jax.ops.banded import (apply_system_best,
                                apply_coupled_system_best,
                                apply_system_banded_xla,
                                apply_coupled_system_banded_xla,
                                apply_impl)

__all__ = ["apply_system_best", "apply_coupled_system_best",
           "apply_system_banded_xla", "apply_coupled_system_banded_xla",
           "apply_impl"]
