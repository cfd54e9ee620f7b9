"""The multi-chip dry run as a fresh process would run it.

``dryrun_multichip`` builds its mesh from virtual CPU devices.  This test
launches it in a new process with NO ``JAX_PLATFORMS`` override, only
``XLA_FLAGS``, so the entry point's own device choice is what makes it
pass.
"""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_dryrun_multichip_driver_style():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)  # the driver does not set it
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()
    proc = subprocess.run(
        [sys.executable, "-c",
         "from __graft_entry__ import dryrun_multichip; dryrun_multichip(8)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=560,
    )
    assert proc.returncode == 0, (
        f"dryrun failed (rc={proc.returncode})\n"
        f"stdout:\n{proc.stdout[-2000:]}\nstderr:\n{proc.stderr[-4000:]}"
    )
    assert "checkpoint roundtrip ok" in proc.stdout
