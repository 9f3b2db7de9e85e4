"""searcher.phrase_select_ms: the phrase path's statistics and, a leaf at
a time, its rows' block selection and routing, the postings decoded for
the selections its memo lacks included (the span search.phrases.select of
rucene_tpu_torch.util.metrics.METRICS; its child search.phrases.postings
is not added again) over the window, in ms a batch. None where the
program does not time the span."""

SPANS = ("search.phrases.select",)


def read(ctx):
    n, timers = ctx.layers.get("batches"), ctx.layers.get("timers", {})
    if not n or not any(s in timers for s in SPANS):
        return None
    return 1000.0 * sum(timers.get(s, (0.0, 0))[0] for s in SPANS) / n
