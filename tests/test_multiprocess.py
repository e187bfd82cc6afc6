"""Multi-HOST (multi-process) smoke test — SURVEY.md §5.8.

The reference genuinely runs 2 OS processes over MPI (reference
OpenMDAO/Boussinesq_ParallelCoupler.py:8-9 ``MPI.COMM_WORLD``, :115 gather);
the sem_jax analog is JAX's multi-controller runtime.  This test launches
TWO coordinated processes (2 virtual CPU devices each → a 4-device global
mesh with an explicit ``('dcn', 'x')`` factorization along the process
boundary) and checks that a coupled Gauss-Seidel step — CD linear solve +
full NS Newton/Uzawa update, nested Krylov included — matches the
single-process result in every process.  The moral equivalent of the
reference's single-box ``mpirun -n 2`` strategy (reference
study/Boussinesq_run.py:65-93), runnable without multi-host hardware.
"""
import os
import socket
import subprocess
import sys

_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
sys.path.insert(0, sys.argv[3])

from sem_jax.parallel import (init_distributed, make_mesh, use_mesh,
                              gather_global)

pid, nproc = init_distributed(f"127.0.0.1:{sys.argv[2]}", 2,
                              int(sys.argv[1]), local_device_count=2)
assert nproc == 2, nproc
assert jax.device_count() == 4, jax.devices()       # global across processes
assert jax.local_device_count() == 2

import numpy as np
import jax.numpy as jnp
from sem_jax.coupling import build_coupled
from sem_jax.coupling.mda import CoupledState

kw = dict(Re=1e2, Ra=1e2, Pr=0.71, P_cd=2, N_ex_cd=2, N_ey_cd=2,
          P_ns=2, N_ex_ns=4, N_ey_ns=4, mtol_internal=1e-10, iprint=False)

# single-device reference (identical in both processes: local device 0)
cd0, ns0, mda0 = build_coupled(1.0, 1.0, **kw)
z = lambda n: jnp.zeros(n)
ref = mda0._gs_sweep(CoupledState(z(cd0.N), z(ns0.N), z(ns0.N), z(ns0.N)))

mesh = make_mesh()   # all 4 global devices; auto 'dcn' axis across processes
assert mesh.axis_names == ("dcn", "x"), mesh
assert mesh.devices.shape == (2, 2), mesh.devices.shape

with use_mesh(mesh):
    cd, ns, mda = build_coupled(1.0, 1.0, **kw)
    s1 = mda._gs_sweep(CoupledState(z(cd.N), z(ns.N), z(ns.N), z(ns.N)))
    jax.block_until_ready((s1.T, s1.u, s1.v))

for got, want in ((s1.T, ref.T), (s1.u, ref.u), (s1.v, ref.v)):
    np.testing.assert_allclose(gather_global(got), np.asarray(want),
                               atol=1e-10)
print(f"MP_OK pid={pid}", flush=True)
"""


def test_make_mesh_explicit_dcn_errors_single_process():
    """An EXPLICIT dcn=True with no host boundary must error, not silently
    return a flat mesh that downstream ('dcn', 'x')-keyed code trips over."""
    import pytest

    from sem_jax.parallel import make_mesh

    with pytest.raises(ValueError, match="only one process"):
        make_mesh(dcn=True)
    # the automatic default stays silent and flat
    assert make_mesh().axis_names == ("x",)


def test_init_distributed_rejects_conflicting_device_count(monkeypatch):
    """local_device_count conflicting with an XLA_FLAGS override must raise,
    not silently produce a different global mesh shape."""
    import pytest

    from sem_jax.parallel import init_distributed

    monkeypatch.setenv("XLA_FLAGS",
                       "--xla_force_host_platform_device_count=8")
    with pytest.raises(ValueError, match="conflicts with XLA_FLAGS"):
        init_distributed("127.0.0.1:1", 1, 0, local_device_count=2)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_coupled_step_matches_single_process(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)          # workers force their own 2 devices
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(rank), str(port), repo],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
        assert f"MP_OK pid={rank}" in out
