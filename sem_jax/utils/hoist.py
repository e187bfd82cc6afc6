"""jit with closure constants hoisted to runtime arguments.

The solver megakernels close over large host constants (spectral-Schur
transforms, the boundary-ring inverse, FDM eigenbases, assembled 1D
operators).  Under plain ``jax.jit`` those are embedded in the program as
HLO literals, which has two costs at the north-star size (p16 64×64):

* the serialized executables balloon (~150 MB per Krylov megakernel), so
  every persistent-compilation-cache entry is large to store and to load;
* any constant that is a *device* array is read back device→host at MLIR
  lowering time and destabilizes the cache key.

``jit_hoisted(fun)`` removes the literals wholesale: the function is traced
once per argument structure with ``jax.make_jaxpr`` (all closure arrays
land in ``jaxpr.consts``), the consts are ``device_put`` once per process,
and the compiled program evaluates the jaxpr with the consts passed as a
leading pytree argument.  No per-function signature plumbing: callers keep
calling the wrapper exactly like the jitted original.

Nesting composes: calling a hoisted function inside another traced function
re-embeds its consts as the outer trace's constants, and hoisting the
outermost entry point lifts them again — so only the outermost jit of each
dispatch path needs to be hoisted.

``label`` plugs the wrapper into :mod:`sem_jax.utils.prefetch`: each
compiled signature is recorded to the prefetch manifest, and later
processes re-dispatch all recorded signatures concurrently right after
solver construction (loads parallelize across threads; see prefetch.py).
Builds are serialized per signature with an event so a prefetch thread and
the real solve never compile the same program twice.
"""
from __future__ import annotations

import threading

import jax
from jax import tree_util

__all__ = ["jit_hoisted"]

# Warm calls (sem_jax.utils.prefetch) are REAL calls with zero-filled
# arguments, so any one-off cost of a program's first execution is paid in
# the warm thread too; the per-signature build lock below guarantees each
# program is built exactly once regardless of which thread gets there
# first.


def jit_hoisted(fun, label: str = None):
    """Wrap ``fun`` like ``jax.jit(fun)`` but with every array constant the
    trace closes over hoisted out of the executable and passed as a runtime
    argument (device-resident, transferred once per process).

    :param label: stable identity for the prefetch manifest (include the
        grid configuration — e.g. ``"ns.gmres32@P16_64x64"`` — so warm-ups
        never cross solver configurations).  ``None`` disables prefetch
        participation for this wrapper.
    """
    cache = {}       # key -> ("done", jf, consts) | ("building", Event)
    lock = threading.Lock()

    def wrapper(*args):
        # Under an ACTIVE trace (this hoisted function called inside another
        # traced one), inline: the enclosing trace captures our constants
        # and the OUTERMOST hoisted wrapper lifts them once.  Running the
        # make_jaxpr + device_put machinery here instead would CACHE
        # tracer-valued "constants" (device_put is a traced op in that
        # context), poisoning every later concrete call with stale tracers
        # (measured: the fused host-FGMRES step tracing _dres_jit with a
        # fresh argument signature).
        from jax._src import core as _core
        if not _core.trace_state_clean():
            return fun(*args)
        flat, in_tree = tree_util.tree_flatten(args)
        key = (in_tree, tuple((getattr(a, "shape", ()),
                               str(getattr(a, "dtype", type(a))))
                              for a in flat))
        while True:
            with lock:
                entry = cache.get(key)
                if entry is None:
                    ev = threading.Event()
                    cache[key] = ("building", ev)
                    break
                if entry[0] == "done":
                    _, jf, consts = entry
                    return jf(consts, flat)
                ev = entry[1]
            ev.wait()       # another thread (prefetch or solve) is building
        try:
            closed, out_shape = jax.make_jaxpr(fun, return_shape=True)(*args)
            out_tree = tree_util.tree_structure(out_shape)
            consts = [jax.device_put(c) for c in closed.consts]
            jaxpr = closed.jaxpr

            def run(consts_, flat_):
                out = jax.core.eval_jaxpr(jaxpr, consts_, *flat_)
                return tree_util.tree_unflatten(out_tree, out)

            jf = jax.jit(run)
            # compile + per-process program load happen at the first call —
            # pay them here, inside the build critical section, so released
            # waiters never race a second load of the same program
            out = jf(consts, flat)
            if label:
                from sem_jax.utils import prefetch
                prefetch.note(label, args)
            with lock:
                cache[key] = ("done", jf, consts)
        except BaseException:
            with lock:
                del cache[key]
            raise
        finally:
            ev.set()
        return out

    wrapper.__wrapped__ = fun
    if label:
        from sem_jax.utils import prefetch
        prefetch.register(label, wrapper)
    return wrapper
