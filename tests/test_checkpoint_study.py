"""Checkpoint/resume and study-harness tests (SURVEY.md §5.4, component #30)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp

from sem_jax.coupling import build_coupled
from sem_jax.coupling.mda import CoupledState
from sem_jax.utils import save_checkpoint, load_checkpoint

CFG = dict(Re=1e3, Ra=1e3, Pr=0.71, P=3, N_e=3)


def _solve(mtol=1e-9, s0=None):
    cd, ns, mda = build_coupled(1.0, 1.0, Re=CFG["Re"], Ra=CFG["Ra"],
                                Pr=CFG["Pr"], P_cd=3, N_ex_cd=3, N_ey_cd=3,
                                P_ns=3, N_ex_ns=3, N_ey_ns=3,
                                mode="GS", mtol_nonlin=mtol, iprint=False)
    return mda.solve(s0), mda


def test_checkpoint_roundtrip(tmp_path):
    state, mda = _solve()
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, state, CFG, mda.stats)
    loaded, config, iters = load_checkpoint(path, expect_config=CFG)
    np.testing.assert_array_equal(np.asarray(loaded.T), np.asarray(state.T))
    np.testing.assert_array_equal(np.asarray(loaded.p), np.asarray(state.p))
    assert config == CFG
    assert iters[2] == mda.stats.nonlinear_iters


def test_checkpoint_config_mismatch_raises(tmp_path):
    state, mda = _solve()
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, state, CFG)
    with pytest.raises(ValueError, match="mismatch"):
        load_checkpoint(path, expect_config={**CFG, "Ra": 1e4})


def test_resume_from_checkpoint_converges_immediately(tmp_path):
    """A solve warm-started from a converged checkpoint finishes in one
    sweep — true resume capability (the reference only has in-run warm
    starts, SURVEY.md §5.4)."""
    state, mda0 = _solve()
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, state, CFG, mda0.stats)
    loaded, _, _ = load_checkpoint(path)
    state2, mda = _solve(s0=loaded)
    assert mda.stats.nonlinear_iters <= 1
    # the single confirming sweep may move the iterate within the
    # convergence band (atol_nonlin ≈ 2e-8)
    np.testing.assert_allclose(np.asarray(state2.T), np.asarray(state.T),
                               atol=1e-6)


def test_study_harness_cli(tmp_path):
    """The sweep CLI runs end-to-end and saves the npz/log artifacts."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(repo, "study", "boussinesq_run.py"),
         "-P", "2", "-Ne", "2", "-mode", "GS", "-log", "True",
         "-save", "True", "-Re", "100", "-Ra", "100"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=500)
    assert out.returncode == 0, out.stderr[-2000:]
    files = os.listdir(tmp_path / "Boussinesq_study")
    assert any(f.endswith(".npz") for f in files), files
    assert any(f.endswith(".log") for f in files), files
    npz = [f for f in files if f.endswith(".npz")][0]
    with np.load(tmp_path / "Boussinesq_study" / npz) as z:
        arrays = [z[k] for k in z.files if k != "meta"]
    # element-scattered T, u, v + iteration counters
    assert len(arrays) == 4


def test_mid_solve_checkpointing_and_cli_resume(tmp_path):
    """``BoussinesqMDA(checkpoint_path=...)`` persists the coupled iterate
    DURING the solve (every ``checkpoint_every`` accepted iterations), and
    a fresh MDA warm-started from that mid-run checkpoint converges with
    strictly less work than from zero — crash/timeout recovery for long
    PTC/GS runs (a killed Ra=1e7 p16 run motivated this)."""
    path = str(tmp_path / "mid.ckpt.npz")
    cd, ns, mda = build_coupled(1.0, 1.0, Re=CFG["Re"], Ra=CFG["Ra"],
                                Pr=CFG["Pr"], P_cd=3, N_ex_cd=3, N_ey_cd=3,
                                P_ns=3, N_ex_ns=3, N_ey_ns=3,
                                mode="GS", mtol_nonlin=1e-9, iprint=False,
                                checkpoint_path=path, checkpoint_every=2)
    assert mda.checkpoint_config["Ra"] == CFG["Ra"]  # auto-filled stamp
    mda.solve()
    total_sweeps = mda.stats.nonlinear_iters
    assert os.path.exists(path)                      # written mid-solve
    loaded, config, iters = load_checkpoint(
        path, expect_config=mda.checkpoint_config)
    # the stored iterate is a mid-run snapshot, not the converged state
    assert 0 < iters[2] < total_sweeps

    _, mda2 = _solve(s0=loaded)
    assert mda2.stats.nonlinear_iters < total_sweeps  # resumed, not redone


def test_time_budget_checkpoints_and_raises(tmp_path):
    """An exhausted wall-clock budget exits GRACEFULLY between nonlinear
    iterations: the iterate is force-checkpointed (even off the
    checkpoint_every cadence) and a RuntimeError names the budget — long
    high-Ra marches must never be SIGTERM'd mid-dispatch by an external
    timeout (a mid-dispatch kill can wedge a remote accelerator)."""
    path = str(tmp_path / "budget.ckpt.npz")
    cd, ns, mda = build_coupled(1.0, 1.0, Re=CFG["Re"], Ra=CFG["Ra"],
                                Pr=CFG["Pr"], P_cd=3, N_ex_cd=3, N_ey_cd=3,
                                P_ns=3, N_ex_ns=3, N_ey_ns=3,
                                mode="GS", mtol_nonlin=1e-9, iprint=False,
                                checkpoint_path=path, checkpoint_every=1000,
                                time_budget_s=0.0)
    with pytest.raises(RuntimeError, match="budget"):
        mda.solve()
    assert os.path.exists(path)  # forced, despite checkpoint_every=1000
    loaded, _, iters = load_checkpoint(path)
    assert iters[2] >= 1
    # the checkpointed iterate resumes to convergence without the budget
    _, mda2 = _solve(s0=loaded)
    assert mda2.stats.nonlinear_iters >= 0

    # the ABSOLUTE-deadline form (what continuation ladders must use —
    # each ladder level builds a fresh MDA, so a per-solve budget would
    # restart per level) fires identically
    import time
    cd3, ns3, mda3 = build_coupled(1.0, 1.0, Re=CFG["Re"], Ra=CFG["Ra"],
                                   Pr=CFG["Pr"], P_cd=3, N_ex_cd=3,
                                   N_ey_cd=3, P_ns=3, N_ex_ns=3, N_ey_ns=3,
                                   mode="GS", mtol_nonlin=1e-9, iprint=False,
                                   time_deadline=time.monotonic() - 1.0)
    with pytest.raises(RuntimeError, match="budget"):
        mda3.solve()


def test_cli_budget_exit_and_cross_physics_init(tmp_path):
    """The study CLI's -budget flag exits gracefully with a checkpoint, and
    -init warm-starts a DIFFERENT-Ra run from it (manual Ra continuation —
    how the Ra=1e8 march is seeded from the converged Ra=1e7 state)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    # P=3 Ne=3 at Re=Ra=1e3 needs several GS sweeps — the budget check
    # (between sweeps) must actually be reached (tinier configs converge
    # in ONE sweep and return before any budget test)
    base = [sys.executable,
            os.path.join(repo, "study", "boussinesq_run.py"),
            "-P", "3", "-Ne", "3", "-mode", "GS", "-save", "False",
            "-Re", "1000"]
    out = subprocess.run(
        base + ["-Ra", "1000", "-ckpt", "True", "-budget", "0"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=500)
    assert out.returncode != 0                     # graceful budget raise
    assert "budget" in out.stderr
    ckpts = [f for f in os.listdir(tmp_path / "Boussinesq_study")
             if f.endswith(".ckpt.npz")]
    assert len(ckpts) == 1
    out2 = subprocess.run(
        base + ["-Ra", "2000",
                "-init", os.path.join("Boussinesq_study", ckpts[0])],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=500)
    assert out2.returncode == 0, out2.stderr[-2000:]
    assert "init from" in out2.stdout


def test_ptc_dt_persists_across_resume(tmp_path):
    """PTC checkpoints carry the live SER Δt (checkpoint ``extras``): a
    resumed march continues the pseudo-time ramp where it stopped instead
    of re-crawling from Δt₀ (measured: a restarted p16 Ra=1e7 ramp spent
    ~40 cheap steps re-covering ground its checkpoint had already won)."""
    path = str(tmp_path / "ptc.ckpt.npz")
    kw = dict(Re=CFG["Re"], Ra=1e4, Pr=CFG["Pr"], P_cd=3, N_ex_cd=3,
              N_ey_cd=3, P_ns=3, N_ex_ns=6, N_ey_ns=6, mode="PTC",
              mtol_nonlin=1e-8, iprint=False)
    cd, ns, mda = build_coupled(1.0, 1.0, checkpoint_path=path,
                                checkpoint_every=2, **kw)
    mda.solve()
    loaded, _, _, extras = load_checkpoint(path, with_extras=True)
    assert extras.get("ptc_dt", 0) > mda.ptc_dt0  # the ramp had grown
    # resume semantics (study CLI): adopt the checkpointed Δt unless the
    # user pinned -ptc_dt0 — here just assert the handoff value is usable
    cd2, ns2, mda2 = build_coupled(1.0, 1.0, **kw)
    mda2.ptc_dt0 = float(extras["ptc_dt"])
    s = mda2.solve(loaded)
    assert mda2.stats.nonlinear_iters <= mda.stats.nonlinear_iters
