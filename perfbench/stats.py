"""Rate and percentile arithmetic of the end-to-end metrics.

Both run over every request of the window: a rate is all the work over
all the time, and a tail is read from the raw latencies, never from
buckets or from medians of chunks.
"""

from __future__ import annotations

import numpy as np


def rate(count: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return count / seconds


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of every sample in ``values`` (linear
    interpolation between the two nearest ranks)."""
    values = np.asarray(values, np.float64)
    if values.size == 0:
        raise ValueError("no samples")
    return float(np.percentile(values, q))
