"""writer.host_frac: the share of the window's host time the writer took
from the serving thread: the spans writer.add_documents (a block's
inversion into the buffer, on the ingest thread) and writer.flush
(packing and writing a segment, in a refresh) of
rucene_tpu_torch.util.metrics.METRICS, summed over the window, over its
seconds. A merge (writer.merge) runs in a worker process of the merge
scheduler, off the serving process's host, so it is not counted. None
where the program times neither span."""

SPANS = ("writer.add_documents", "writer.flush")


def read(ctx):
    timers, seconds = ctx.layers.get("timers", {}), ctx.layers.get("seconds")
    if not seconds or not any(s in timers for s in SPANS):
        return None
    return sum(timers.get(s, (0.0, 0))[0] for s in SPANS) / seconds
