"""Queries answered in the window over the window's seconds; the window
closes when the last answer is on the host and the card synchronized."""

from perfbench import stats


def read(run):
    return stats.rate(run.queries_answered, run.window_s)
