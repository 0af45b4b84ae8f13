"""Median latency of every request due in the window (see latency_p95_ms)."""
import numpy as np


def read(run):
    lat = run.record.get("latencies_s")
    return 1e3 * float(np.percentile(lat, 50)) if lat else None
