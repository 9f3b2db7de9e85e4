"""searcher.dispatch_ms: the searcher's host dispatch (the spans
search.device.dispatch, search.phrases.dispatch and search.mixed.dispatch
of rucene_tpu_torch.util.metrics.METRICS: queueing a batch's term, phrase
and mixed paths, no device sync) over the window, in ms a batch."""

SPANS = ("search.device.dispatch", "search.phrases.dispatch", "search.mixed.dispatch")


def read(ctx):
    n = ctx.layers.get("batches")
    if not n:
        return None
    return 1000.0 * sum(ctx.layers["timers"].get(s, (0.0, 0))[0] for s in SPANS) / n
