"""The port's own entry points (counterparts of the repo's drivers, which
import rucene_tpu and so jax):

- ``python -m rucene_tpu_torch.drivers.bench [--nrt]``: bench.py's
  ``main`` and ``main_nrt`` (drivers/bench.py; its serving loop is
  ``serve_mix``);
- ``python -m rucene_tpu_torch.drivers.build_bench_cache``:
  tools/build_bench_cache.py;
- ``python -m rucene_tpu_torch.drivers.profile_bench``:
  tools/profile_bench.py;
- ``python -m rucene_tpu_torch.drivers.profile_candidate``:
  tools/profile_candidate.py (the flat executor's stages, one batch);
- ``rucene_tpu_torch.drivers.graft_entry``: __graft_entry__.py's
  ``entry`` and ``dryrun_multichip``;
- ``python -m rucene_tpu_torch.examples.example`` and
  ``...examples.nrt_search``: examples/.

drivers/workload.py holds the bench's corpus, mix and cache. Every entry
point runs on the card (``cuda``) unless it is given ``--device cpu`` /
``device="cpu"``; asked for the card where there is none, it fails rather
than run on the CPU.
"""

from __future__ import annotations

import torch


def require_device(device="cuda") -> torch.device:
    """torch.device(device); a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but torch finds no CUDA card "
                           "(pass --device cpu / device='cpu' to run on the CPU)")
    return dev


def device_name(dev: torch.device) -> str:
    """The card's name, or ``cpu``."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
