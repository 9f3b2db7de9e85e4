"""Nothing the benchmark runs loads JAX or the JAX package: a tiny CPU run
of each cell's set-up, loop and reference (traced too), in a fresh
process, then a look at sys.modules by top-level name. The command itself
refuses to run without a card."""

import os
import subprocess
import sys
import types

from portbench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SCRIPT = """
import sys, tempfile, time
sys.path[:0] = [{root!r}, {here!r}]
import pb_tiny
from portbench import run
root = pb_tiny.make_root(tempfile.mkdtemp(dir={tmp!r}))
for cell in ("zipf1m.mix", "zipf1m.manyword"):
    for trace in (False, True):
        line = run.run_cell(cell, 7, 1.0, trace, device="cpu", root=root, t_start=time.perf_counter())
        assert line["correct"], (cell, line["checks"])
print("FOUND", run.forbidden_modules())
print("PORT", "rucene_tpu_torch" in sys.modules)
"""


def test_no_jax_in_a_run(tmp_path):
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=ROOT, here=here, tmp=str(tmp_path))],
                         capture_output=True, text=True, timeout=600, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout
    assert "PORT True" in out.stdout


def test_top_level_names_compared_whole(monkeypatch):
    assert "rucene_tpu_torch" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "rucene_tpu.search", types.ModuleType("rucene_tpu.search"))
    assert run.forbidden_modules() == ["rucene_tpu"]


def test_command_refuses_without_a_card():
    """In a process with no CUDA card the command prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "zipf1m.mix",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
