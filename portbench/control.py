"""The readings that ``portbench/check.py``'s limits are set from, for
one cell, in one process:

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 --seconds 4

For each seed: the traffic of that seed, a short window at the cell's own
size and load (the set-up shared between seeds where the loop allows it),
and then the numbers of ``check.py`` twice over the same kept rows:

- ``program``: the program's answers against the reference (the lower
  readings: a limit sits above the largest);
- ``control``: the reference computed in bfloat16 (the precision below the
  configuration's float32) put in the program's place, against the
  reference (the upper readings: a limit sits below the smallest; the
  control has to fail).

Prints one JSON line a seed and a last line with the largest program
reading and the smallest control reading of each number. The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from portbench import run


def control_kept(kept, scorer, row, k):
    """The bf16 reference's answer to a kept row, as the program's."""
    from portbench.check import Kept

    a = scorer.answer(row, k)
    return Kept(kept.row, kept.n_docs, a.total, a.docs, a.scores)


def readings(workload: str, seeds, seconds: float, device: str = "cuda", root: str = run.ROOT):
    """Yields one dict a seed: the program's and the control's numbers."""
    import torch

    from portbench import check, traffic
    from portbench.reference import bm25

    _bench, _wl, config, mix, corpus, loop = run.load_cell(workload, root)
    index = bm25.Index(corpus.tokens, corpus.offsets, len(corpus.probs))
    dev = torch.device(device)
    k = mix["k"]
    state = None
    try:
        for seed in seeds:
            rows = traffic.build_rows(mix, corpus, seed)
            cell = run.Cell(workload, config, mix, corpus, rows, seed, dev, run.log,
                            os.path.join(root, "portbench", ".cache"))
            if state is None or not loop.REUSE_STATE:
                if state is not None:
                    loop.close(state)
                    state = None
                state = loop.setup(cell)
            out = loop.window(cell, state, seconds, None)
            t = time.perf_counter()
            scorers: dict = {}

            def scorer(kept, precision="f64"):
                key = (kept.n_docs, precision)
                if key not in scorers:
                    scorers[key] = bm25.Scorer(index, kept.n_docs, precision)
                return scorers[key]

            def answer(kr):
                return scorer(kr).answer(rows[kr.row], k)

            prog = check.judge(out.kept, answer, k, {"failed_rows": out.failed, **out.checks})
            ctrl = check.judge([control_kept(kr, scorer(kr, "bf16"), rows[kr.row], k)
                                for kr in out.kept], answer, k)
            yield {"seed": seed, "rows_checked": len(out.kept), "attempted": out.attempted,
                   "program": prog, "program_correct": check.verdict(prog)[0],
                   "control": ctrl, "control_correct": check.verdict(ctrl)[0],
                   "reference_s": time.perf_counter() - t}
    finally:
        if state is not None:
            loop.close(state)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=4.0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    worst: dict = {}
    best: dict = {}
    for line in readings(args.workload, [int(s) for s in args.seeds.split(",")], args.seconds):
        print(json.dumps(line), flush=True)
        for name, v in line["program"].items():
            worst[name] = max(worst.get(name, v), v)
        for name, v in line["control"].items():
            best[name] = min(best.get(name, v), v)
    print(json.dumps({"workload": args.workload, "program_max": worst, "control_min": best}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
