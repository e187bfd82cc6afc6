"""Multi-device tests on the virtual 8-device CPU mesh — the analog of the
reference's single-box ``mpirun -n 2`` strategy (SURVEY.md §4)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sem_jax import operators as ops
from sem_jax.mesh import Grid2D
from sem_jax.parallel.sharding import (make_mesh, use_mesh, field_sharding,
                                       constrain, place)

RNG = np.random.default_rng(5)


def test_eight_devices_available():
    assert jax.device_count() == 8


def test_sharded_operator_parity():
    """Operator applies with sharded inputs match unsharded to ~1e-14."""
    grid = Grid2D(P=4, N_ex=8, N_ey=4, L_x=1.0, L_y=1.0)
    mesh = make_mesh()
    u = RNG.standard_normal(grid.N)
    w = RNG.standard_normal(grid.N)
    ref_K = np.asarray(ops.apply_stiffness(grid, jnp.asarray(u)))
    ref_C = np.asarray(ops.apply_convection(grid, jnp.asarray(u),
                                            jnp.asarray(u), jnp.asarray(w)))

    sharded_apply = jax.jit(lambda x: constrain(ops.apply_stiffness(grid, x)))
    sharded_conv = jax.jit(
        lambda a, b, c: constrain(ops.apply_convection(grid, a, b, c)))
    with use_mesh(mesh):
        got_K = np.asarray(sharded_apply(jnp.asarray(u)))
        got_C = np.asarray(sharded_conv(jnp.asarray(u), jnp.asarray(u),
                                        jnp.asarray(w)))
    np.testing.assert_allclose(got_K, ref_K, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(got_C, ref_C, rtol=1e-13, atol=1e-13)


def test_sharded_solver_parity():
    """A CD solve with kernels traced under the mesh equals the unsharded
    solve (SURVEY.md §7.2 step 8 acceptance: parity to ~1e-14)."""
    from sem_jax import ConvectionDiffusionSolver

    kw = dict(L_x=1.0, L_y=1.0, Pe=10.0, P=3, N_ex=4, N_ey=4,
              T_W=0.5, T_E=-0.5, mtol=1e-11)
    u = RNG.standard_normal((3 * 4 + 1) ** 2)
    v = RNG.standard_normal((3 * 4 + 1) ** 2)

    cd0 = ConvectionDiffusionSolver(**kw)
    T_ref = np.asarray(cd0._get_solution(jnp.asarray(u), jnp.asarray(v)))

    with use_mesh(make_mesh()):
        cd1 = ConvectionDiffusionSolver(**kw)
        T_sh = np.asarray(cd1._get_solution(jnp.asarray(u), jnp.asarray(v)))

    np.testing.assert_allclose(T_sh, T_ref, atol=1e-12)


def test_place_divisibility_rules():
    mesh = make_mesh()
    with use_mesh(mesh):
        a = place(np.zeros(64))          # divisible -> sharded
        b = place(np.zeros(81))          # odd -> left unsharded
    assert a.sharding == field_sharding(mesh)
    assert not b.sharding.is_equivalent_to(field_sharding(mesh), 1)


def test_dryrun_multichip():
    """The driver's multi-chip dry run executes on the 8-device CPU mesh."""
    import __graft_entry__ as g
    g.dryrun_multichip(8)


def test_dryrun_forces_cpu_before_backend_touch():
    """``_ensure_devices`` must force the CPU platform BEFORE the first
    backend-initializing call: the dry run needs no accelerator, and with
    an accelerator platform exported in ``JAX_PLATFORMS`` the first
    ``jax.devices()`` would otherwise initialize (or fail to find) that
    backend.

    Runs in a subprocess with ``JAX_PLATFORMS=cuda`` exported and a spy on
    ``jax.devices`` that records the configured platform at each call:
    every call must observe ``jax_platforms == 'cpu'``.
    """
    import os
    import subprocess
    import sys

    script = r"""
import os
os.environ["JAX_PLATFORMS"] = "cuda"      # an accelerator export
import jax
_real = jax.devices
calls = []
def spy(*a, **k):
    calls.append(jax.config.jax_platforms)
    return _real(*a, **k)
jax.devices = spy
import __graft_entry__ as g
devs = g._ensure_devices(8)
assert calls, "jax.devices was never called"
assert all(c == "cpu" for c in calls), f"backend touched pre-CPU: {calls}"
assert len(devs) == 8 and all(d.platform == "cpu" for d in devs), devs
assert jax.default_backend() == "cpu"
print("CPU_FORCED_OK")
"""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", script], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, (out.stdout, out.stderr)
    assert "CPU_FORCED_OK" in out.stdout


def test_sharded_hlo_contains_collectives():
    """Compiled sharded programs actually communicate over the mesh axis.

    Captures the post-SPMD-partitioning HLO of (a) a sharded operator apply
    and (b) a Krylov-style reduction, and asserts XLA inserted collectives
    (the PETSc-reduction / OpenMDAO-transfer replacements, SURVEY.md §5.8) —
    so a regression that silently de-shards everything (all work replicated)
    becomes visible without multi-chip hardware.  Also guards the Krylov
    memory model: the basis-sized buffers in the reduction program must stay
    sharded (no accidental full all-gather of a basis-shaped operand).
    """
    grid = Grid2D(P=4, N_ex=8, N_ey=4, L_x=1.0, L_y=1.0)
    mesh = make_mesh()
    N = grid.N
    # SEM global vectors are odd-length, so inputs arrive replicated and the
    # in-kernel constrain() re-shards (GSPMD pads) — the production path.

    # (a) operator apply with in-kernel sharding constraints
    with use_mesh(mesh):
        f = jax.jit(lambda x: constrain(ops.apply_stiffness(grid,
                                                            constrain(x))))
        hlo_op = f.lower(
            jax.ShapeDtypeStruct((N,), jnp.float64)).compile().as_text()
    assert any(c in hlo_op for c in
               ("all-reduce", "all-gather", "collective-permute",
                "reduce-scatter", "all-to-all")),         "sharded apply compiled with no collectives"

    # (b) dot product over a constrained vector -> psum (all-reduce)
    with use_mesh(mesh):
        g = jax.jit(lambda x: jnp.vdot(constrain(x), constrain(x)))
        hlo_dot = g.lower(
            jax.ShapeDtypeStruct((N,), jnp.float64)).compile().as_text()
    assert "all-reduce" in hlo_dot, "sharded dot product lost its psum"


def test_place_normalizes_program_boundary_layouts():
    """place() gives every 1-D array a canonical layout under a mesh:
    row-strip for divisible lengths, explicit replication otherwise.

    Regression guard for a round-2 bug class: jitted-kernel outputs carry
    GSPMD auto-chosen layouts (e.g. ``[4,2] last_tile_dim_replicate``
    leaking out of the residual program), and feeding such arrays into the
    compiled Krylov programs produced numerically WRONG solves with
    bit-identical input values — an f64 right-preconditioned GMRES residual
    grew above ‖b‖.  Normalizing at every program boundary removes the
    class; this test pins the normalization behavior.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = make_mesh()
    n_dev = mesh.devices.size
    with use_mesh(mesh):
        # odd length (every SEM global vector): must come out REPLICATED
        odd = place(np.arange(1025.0))
        assert odd.sharding.is_fully_replicated
        # a leaked auto-sharding on an odd-length array is normalized too
        leaked = jax.device_put(
            jnp.arange(1025.0),
            NamedSharding(mesh, P()))  # start replicated, then re-place
        assert place(leaked).sharding.is_fully_replicated
        # divisible length: row-strip sharding over the mesh axis
        div = place(np.arange(float(8 * n_dev)))
        spec = div.sharding.spec
        assert tuple(spec) == (mesh.axis_names[0],)
    # no mesh: plain arrays
    plain = place(np.arange(7.0))
    assert not hasattr(plain.sharding, "spec") or \
        plain.sharding.is_fully_replicated
