"""The port's native library builds once per checkout, into a gitignored
directory (rucene_tpu_torch/native/build/), so the test workers of a fresh
checkout all build it at once. Six processes that build it together into
one empty directory must each load a whole library."""

import os
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BUILD = r"""
import sys, time
import rucene_tpu_torch.native as native
native._BUILD_DIR = sys.argv[1]
native.available = False
time.sleep(max(0.0, float(sys.argv[2]) - time.time()))  # start together
native._build_and_load()
print(native.available)
"""


def test_concurrent_builds_all_load(tmp_path):
    if subprocess.run(["g++", "--version"], capture_output=True).returncode != 0:
        pytest.skip("no g++: the native library cannot be built here")
    build_dir = str(tmp_path / "build")
    start = time.time() + 8.0  # past every process's import
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _BUILD, build_dir, repr(start)],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env={**os.environ, "PYTHONPATH": REPO},
        )
        for _ in range(6)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err
            outs.append(out.strip().splitlines()[-1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert outs == ["True"] * 6
    built = [n for n in os.listdir(build_dir) if n.endswith(".so")]
    assert len(built) == 1 and not [n for n in os.listdir(build_dir) if n.endswith(".tmp")]
