"""kernels.postings_roofline: the least time the traced batches' postings
work needs at the card's memory bandwidth (metrics/postings_bytes.py, over
portbench/peaks.py), as a percentage of the device's busy time in the same
stretch. A whole pass's share, not a kernel's: it reads low where the
device does more than stream the postings once (dense [rows x docs]
planes, tables, sorts)."""

from portbench.metrics.postings_bytes import batch_bytes
from portbench.peaks import HBM_BYTES_PER_S


def read(ctx):
    peak = HBM_BYTES_PER_S.get(ctx.device_kind)
    if peak is None or ctx.trace is None or ctx.trace.busy_s <= 0 or not ctx.traced:
        return None
    n = sum(batch_bytes([ctx.rows[i] for i in b], ctx.k, ctx.index, ctx.n_docs)
            for b in ctx.traced)
    return 100.0 * n / peak / ctx.trace.busy_s
