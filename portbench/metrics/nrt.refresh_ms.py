"""nrt.refresh_ms: an NRT refresh, in ms (the span nrt.refresh of
rucene_tpu_torch.util.metrics.METRICS: the whole of
SearcherManager.maybe_refresh, the writer's get_reader and the new
searcher's device builds within it) over the window's refreshes. None
where the program times no refresh."""


def read(ctx):
    t = ctx.layers.get("timers", {}).get("nrt.refresh")
    if t is None or not t[1]:
        return None
    return 1000.0 * t[0] / t[1]
