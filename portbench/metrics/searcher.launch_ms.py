"""searcher.launch_ms: the host time of the uploads and executor calls of
the term and phrase paths (the spans search.device.launch and
search.phrases.launch of rucene_tpu_torch.util.metrics.METRICS; a
blocking upload waits there for the work queued before it) over the
window, in ms a batch. None where the program times neither span."""

SPANS = ("search.device.launch", "search.phrases.launch")


def read(ctx):
    n, timers = ctx.layers.get("batches"), ctx.layers.get("timers", {})
    if not n or not any(s in timers for s in SPANS):
        return None
    return 1000.0 * sum(timers.get(s, (0.0, 0))[0] for s in SPANS) / n
