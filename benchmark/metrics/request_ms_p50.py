"""The median latency of every request in the untraced window, in ms,
beside their 95th percentile, the cell's end-to-end metric. Read on a card
only, as every per-layer metric is."""

import numpy as np


def read(ctx):
    if not ctx.on_device or ctx.latencies_ms is None or len(ctx.latencies_ms) == 0:
        return None
    return float(np.percentile(ctx.latencies_ms, 50))
