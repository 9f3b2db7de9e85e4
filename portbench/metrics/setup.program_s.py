"""setup.program_s: the program's own share of set-up, in seconds: opening
the committed index, building each segment's device form and prewarming
the phrase planes (the spans reader.open, reader.device_build and
search.prewarm_planes, read from the process's
rucene_tpu_torch.util.metrics.METRICS, since the window's timers cover
only the window; each runs once a process, in set-up, and none runs
inside another). Host time: device work these spans queue that is still
running when they close is not counted here. The harness's own work
(the corpus, the rows, the index build on a first run) and the warm
batches are left out. None where the program times none of these spans."""

SPANS = ("reader.open", "reader.device_build", "search.prewarm_planes")


def read(ctx):
    from rucene_tpu_torch.util.metrics import METRICS

    timers = METRICS.snapshot()["timers"]
    if not any(s in timers for s in SPANS):
        return None
    return sum(timers[s]["total_s"] for s in SPANS if s in timers)
