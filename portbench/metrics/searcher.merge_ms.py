"""searcher.merge_ms: the collect's assembly of each row's hits from the
host copies, merged over leaves (the spans search.device.merge and
search.phrases.merge of rucene_tpu_torch.util.metrics.METRICS) over the
window, in ms a batch. None where the program times neither span."""

SPANS = ("search.device.merge", "search.phrases.merge")


def read(ctx):
    n, timers = ctx.layers.get("batches"), ctx.layers.get("timers", {})
    if not n or not any(s in timers for s in SPANS):
        return None
    return 1000.0 * sum(timers.get(s, (0.0, 0))[0] for s in SPANS) / n
