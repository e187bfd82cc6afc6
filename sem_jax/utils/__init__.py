"""Utilities: checkpoint/resume, tracing/profiling."""
from sem_jax.utils.checkpoint import save_checkpoint, load_checkpoint
from sem_jax.utils.profiling import PhaseTimer, trace

__all__ = ["save_checkpoint", "load_checkpoint", "PhaseTimer", "trace"]
