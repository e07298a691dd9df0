"""95th percentile, over every request of the window, of the host clock
from a request's issue to its answers on the host, in milliseconds."""

from perfbench import stats


def read(run):
    return 1e3 * stats.percentile([r.latency_s for r in run.records], 95)
