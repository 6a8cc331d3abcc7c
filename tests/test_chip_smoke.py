"""chip_smoke.py without a card: it must refuse to report success, and its
phases rehearse the main path end to end at tiny sizes on the CPU."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_exits_nonzero_without_gpu(where, tmp_path):
    """On the CPU, and in a directory holding chip_smoke.py and nothing
    else of the repo, the script fails and prints no result line."""
    cwd = ROOT
    if where == "alone":
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    r = _run(cwd, "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_rehearse_ncc_phase():
    out = chip_smoke.phase_ncc_teddy(pair="synth", max_disp=8, grid_step=40,
                                     sweeps=8, crop=(48, 64))
    for schedule in ("checkerboard", "banded"):
        e, lb = out[schedule]
        assert lb <= e


def test_rehearse_global_phase():
    out = chip_smoke.phase_global_baby2(pair="synth", sweeps=8,
                                        crop=(40, 48))
    for schedule in ("checkerboard", "banded"):
        e, lb = out[schedule]
        assert lb <= e


def test_rehearse_kernels_phase():
    out = chip_smoke.phase_kernels(phase_sizes=((3, 9, 11), (17, 6, 13)),
                                   send=(5, 40), interpret=True)
    assert all(r["ok"] for r in out.values())
