"""Same-card A/B of the NRT phase of chip_smoke.py (serve_nrt): fresh
segments served decoded (RUCENE_DECODED unset: ``auto``, every NRT segment
is built through the decode kernel) against packed (RUCENE_DECODED=0:
served through the scoring decode kernel), in turns, in one process.

    python3 tests/torch_nrt_ab.py                 # legs auto,0,0,auto
    python3 tests/torch_nrt_ab.py --legs auto,0 --seconds 45

Each leg builds its own writer and index (200,000 base docs), serves the
bench mix under ingest for ``--seconds`` and runs the phase's gates; the
on-disk stage is left out. Prints the card's name and power limit, then
one JSON line a leg: QPS, ingest rate, refresh times,
batch latencies (the first batch after each refresh among them), the time
from a refresh to the end of its first batch, leaves, device builds, peak
memory and kernel launches.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_nrt_ab: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--legs", default="auto,0,0,auto")
    ap.add_argument("--seconds", type=float, default=45.0)
    args = ap.parse_args()
    import chip_smoke
    from rucene_tpu_torch.ops import cuda_build

    cuda_build.kernels()
    card = chip_smoke.card_line()
    print(card, flush=True)
    for leg in args.legs.split(","):
        if leg == "auto":
            os.environ.pop("RUCENE_DECODED", None)
        else:
            os.environ["RUCENE_DECODED"] = leg
        out = chip_smoke.serve_nrt(torch.device("cuda", 0), card, seconds=args.seconds, disk=False)
        print(json.dumps({"leg": leg, "card": card, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
