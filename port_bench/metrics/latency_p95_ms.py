"""95th percentile of the latency of every request due in the window: from
when it was due to when its counts reached the caller (one that never came
counts its wait until the check)."""
import numpy as np


def read(run):
    lat = run.record.get("latencies_s")
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
