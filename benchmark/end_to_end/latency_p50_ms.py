"""Median latency of every request of the window, each timed from the call
to its return on the host clock."""

import numpy as np


def read(window) -> float:
    return float(np.percentile(np.asarray(window.latency_s) * 1e3, 50))
