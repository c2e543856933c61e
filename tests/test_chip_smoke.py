"""chip_smoke.py refuses to report a result without a GPU."""

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_fails_without_gpu():
    p = _run(ROOT, "chip_smoke.py")
    assert p.returncode != 0
    assert '"ok"' not in p.stdout and "needs a GPU" in p.stderr


def test_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    p = _run(str(tmp_path), "chip_smoke.py")
    assert p.returncode != 0 and '"ok"' not in p.stdout
