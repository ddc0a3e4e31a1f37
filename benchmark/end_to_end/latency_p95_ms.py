"""95th percentile of the latency of every item completed in the window,
from its hand-off to the program to its result in the caller's hands
(numpy's linear interpolation between order statistics)."""

import numpy as np


def read(run):
    if not run.latencies:
        return None
    return float(np.percentile(np.asarray(run.latencies) * 1e3, 95))
