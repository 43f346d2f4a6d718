"""The 95th percentile of the latencies of all requests completed in the
window: each from its issue to its output ready, on the card's clock."""

import numpy as np


def read(run):
    if run.latency_ms.size == 0:
        return None
    return float(np.percentile(run.latency_ms, 95))
