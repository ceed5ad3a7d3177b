"""chip_smoke.py refuses to report success anywhere but on a GPU checkout."""

import os
import shutil
import subprocess
import sys

from conftest import REPO

SMOKE = os.path.join(REPO, "chip_smoke.py")


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True, text=True, timeout=120
    )


def test_exits_nonzero_on_cpu_backend():
    r = _run(SMOKE, REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU backend" in r.stderr


def test_exits_nonzero_outside_a_checkout(tmp_path):
    shutil.copy(SMOKE, tmp_path)
    r = _run(str(tmp_path / "chip_smoke.py"), tmp_path)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "not a kajo-tpu checkout" in r.stderr
