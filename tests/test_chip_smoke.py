"""chip_smoke.py: refuses to run without a GPU, and its phases rehearse at
a tiny size on the CPU (the full-size run happens on the card)."""
import os
import subprocess
import sys

import jax
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(cs.MAIN_KW, N_ex_cd=2, N_ey_cd=2, N_ex_ns=4, N_ey_ns=4)


def test_chip_smoke_refuses_cpu():
    """On the CPU the script exits non-zero, names the missing GPU and
    prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_needs_the_repo(tmp_path):
    """Alone in a directory, without the package, it fails too — on the
    missing package, before it looks for a GPU."""
    import shutil
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    assert "No module named 'sem_jax'" in out.stderr


def test_chip_smoke_operator_phases_tiny():
    """Parity (dispatcher on the CPU: the dense form) and the timing table
    of the two XLA forms."""
    res = cs.phase_parity(P=4, Ne=4, expect_impl="xla-dense")
    assert set(res["errors"]) == {"cd_apply", "coupled_matvec"}
    with pytest.raises(AssertionError):
        cs.phase_parity(P=4, Ne=4, expect_impl="xla-banded")
    t = cs.phase_timing(shapes=((4, 4),), reps=2, device_time=False)
    assert len(t) == 4 and all(w > 0 for w, _ in t.values())


def test_chip_smoke_solve_phases_tiny():
    """The CD example check and the coupled main path (cold + second solve)
    at a tiny size, by a ladder and directly at the finest order."""
    cs.phase_cd(P=3, Ne=4)
    out = cs.phase_main(ladder=[(2, 2), (3, 3)], P=3, kw=TINY, anchor=None)
    assert out["cold"]["anchor"] == pytest.approx(out["second"]["anchor"])
    direct = cs.phase_main(ladder=[(3, 3)], P=3, kw=TINY, anchor=None)
    assert direct["cold"]["anchor"] == pytest.approx(out["cold"]["anchor"],
                                                     rel=1e-5)


def test_chip_smoke_four_phase_tiny():
    """The --four comparison on four virtual CPU devices."""
    res = cs.phase_four(jax.devices()[:4], ladder=[(2, 2), (3, 3)], P=3,
                        kw=TINY, anchor=None)
    assert res["diff"] <= 1e-6 and res["impl"] == "xla-dense"


@pytest.mark.gpu
def test_chip_smoke_parity_on_gpu(gpu_device):
    """On a card: the banded form through the dispatcher against the
    float64 reference (chip_smoke.py runs the same check at p16 64×64)."""
    res = cs.phase_parity(P=8, Ne=8)
    assert res["impl"] == "xla-banded"
