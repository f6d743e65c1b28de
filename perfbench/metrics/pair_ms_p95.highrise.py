"""``pair_ms_p95`` of the high-rise cell, under a bound of its own: 95th
percentile of every pair's latency in the window (host clock to the
device's synchronisation)."""

import numpy as np


def read(run):
    lat = run.latencies_ms()
    return float(np.percentile(lat, 95)) if lat else None
