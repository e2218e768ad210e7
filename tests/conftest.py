"""Shared test helpers.

IMPORTANT: no global XLA flags here — smoke tests must see ONE device
(assignment requirement).  Multi-device tests spawn a subprocess with
XLA_FLAGS set before jax imports, via `run_with_devices`.
"""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
if REPO not in sys.path:          # make `benchmarks.*` importable in tests
    sys.path.insert(0, REPO)

_PRELUDE = """\
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={n}"
import sys
sys.path.insert(0, {src!r})
import jax
from repro.compat import make_auto_mesh
"""


def run_with_devices(n: int, code: str, timeout: int = 520) -> str:
    """Run `code` in a fresh python with n fake devices; returns stdout.
    Raises on nonzero exit (stderr shown in the assertion)."""
    script = _PRELUDE.format(n=n, src=SRC) + code
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", script], timeout=timeout,
                          capture_output=True, text=True, env=env)
    assert proc.returncode == 0, \
        f"subprocess failed:\nSTDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr[-4000:]}"
    return proc.stdout


@pytest.fixture(scope="session")
def devices8():
    return 8


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips (from inside the test) "
        "where torch.cuda.is_available() is false")
