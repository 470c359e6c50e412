"""snapshot_ms_p95: the 95th percentile over the window's segments of the
time from a segment's first launch to its positions on the host."""

import numpy as np


def read(rec):
    return float(np.percentile(np.asarray(rec["segment_s"]) * 1e3, 95))
