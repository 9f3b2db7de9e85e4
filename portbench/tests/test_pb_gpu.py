"""The tiny cells on a CUDA card: the kernels on the timed path give
answers the reference accepts, and the traced window closes inside the
run (the profiler's first start stalls a batch for several seconds). Run
on the card with ``python -m pytest portbench/tests -m gpu``; skips
without one."""

import time

import pytest

import pb_tiny
from portbench import run


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ("zipf1m.mix", "zipf1m.manyword"))
def test_tiny_cell_on_the_card(tmp_path, cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = pb_tiny.make_root(str(tmp_path))
    line = run.run_cell(cell, 2**31 + 1, 20.0, True, device="cuda", root=root,
                        t_start=time.perf_counter())
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0
