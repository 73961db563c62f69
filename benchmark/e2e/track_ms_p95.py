"""The 95th percentile over every frame of the window of its latency, from
the call to the returned pose, in milliseconds."""

import numpy as np


def read(window):
    return 1e3 * float(np.percentile(window["latencies"], 95))
