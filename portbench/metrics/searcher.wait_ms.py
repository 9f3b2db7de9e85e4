"""searcher.wait_ms: the collect's copies of the term and phrase paths'
results to the host, the wait for the device included (the spans
search.device.wait and search.phrases.wait of
rucene_tpu_torch.util.metrics.METRICS) over the window, in ms a batch.
None where the program times neither span."""

SPANS = ("search.device.wait", "search.phrases.wait")


def read(ctx):
    n, timers = ctx.layers.get("batches"), ctx.layers.get("timers", {})
    if not n or not any(s in timers for s in SPANS):
        return None
    return 1000.0 * sum(timers.get(s, (0.0, 0))[0] for s in SPANS) / n
