"""device.idle_frac: the share of the traced stretch in which no kernel,
memcpy or memset ran on the card (portbench/trace.py): 1 - busy / window."""


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0:
        return None
    return 1.0 - t.busy_s / t.window_s
