"""`chip_smoke.py` and `bench.py` measure the GPU: without one they
exit non-zero and print no result line."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("script,env", [
    ("chip_smoke.py", {"JAX_PLATFORMS": "cpu"}),
    ("chip_smoke.py", {"JAX_PLATFORMS": None, "CUDA_VISIBLE_DEVICES": ""}),
    ("bench.py", {"JAX_PLATFORMS": "cpu"}),
])
def test_refuses_to_run_without_gpu(script, env):
    full = dict(os.environ)
    full.pop("PYTEST_CURRENT_TEST", None)
    full.pop("XLA_FLAGS", None)
    for k, v in env.items():
        if v is None:
            full.pop(k, None)
        else:
            full[k] = v
    out = subprocess.run(
        [sys.executable, script], cwd=REPO, env=full,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0, out.stdout[-2000:]
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout
