"""searcher.phrase_scalar_ms: the phrase rows answered on the host by the
scalar engine, in the dispatch and in the collect (the span
search.phrases.scalar of rucene_tpu_torch.util.metrics.METRICS) over the
window, in ms a batch. The span times only the calls there are, so a
program that times the phrase path's stages (search.phrases.select) but
made no scalar call reads 0; None where it times neither span."""

SPANS = ("search.phrases.scalar",)
STAGES = "search.phrases.select"  # timed in every batch that holds a phrase row


def read(ctx):
    n, timers = ctx.layers.get("batches"), ctx.layers.get("timers", {})
    if not n or not any(s in timers for s in SPANS + (STAGES,)):
        return None
    return 1000.0 * sum(timers.get(s, (0.0, 0))[0] for s in SPANS) / n
