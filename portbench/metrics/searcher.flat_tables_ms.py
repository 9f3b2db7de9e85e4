"""searcher.flat_tables_ms: the term path's host table building in its
dispatch (the spans search.device.tables, search.device.conj_prune and
search.device.combine_tables of rucene_tpu_torch.util.metrics.METRICS:
statistics, clause tables, row classes, block tables and work lists,
conjunction pruning, combine tables) over the window, in ms a batch.
None where the program times none of these spans."""

SPANS = ("search.device.tables", "search.device.conj_prune", "search.device.combine_tables")


def read(ctx):
    n, timers = ctx.layers.get("batches"), ctx.layers.get("timers", {})
    if not n or not any(s in timers for s in SPANS):
        return None
    return 1000.0 * sum(timers.get(s, (0.0, 0))[0] for s in SPANS) / n
