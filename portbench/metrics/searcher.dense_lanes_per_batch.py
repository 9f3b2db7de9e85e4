"""searcher.dense_lanes_per_batch: the lanes the executor's dense branch
reads a batch, in millions (the counter search.dense_lanes of
rucene_tpu_torch.util.metrics.METRICS: each dense call's work items x 128)
over the process's batches (the span search.batch, once a batch). The
closed loop hands its readers no counters of the window, so the count
covers every batch the process served: the warm-up's and the window's,
drawn from the same traffic. None where the program does not count the
lanes."""

COUNTER = "search.dense_lanes"


def read(ctx):
    from rucene_tpu_torch.util.metrics import METRICS

    snap = METRICS.snapshot()
    n = snap["timers"].get("search.batch", {}).get("count", 0)
    if not n or COUNTER not in snap["counters"]:
        return None
    return snap["counters"][COUNTER] / n / 1e6
