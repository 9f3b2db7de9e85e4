"""searcher.leaves_per_batch: the leaves a batch's dispatch walks (the
counter search.leaves of rucene_tpu_torch.util.metrics.METRICS, the
searcher's leaf count once a batch) over the window's batches. None where
the program does not count them."""


def read(ctx):
    n, counters = ctx.layers.get("batches"), ctx.layers.get("counters", {})
    if not n or "search.leaves" not in counters:
        return None
    return counters["search.leaves"] / n
