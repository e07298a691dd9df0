"""The least time of the window's query steps over the traced window's
wall time, in percent.

The least time of a launch is the sum of its parts' bounds, each the
larger of its bytes over the card's bandwidth and its operations over
their unit's peak (``perfbench.cost``, the published H100 rates at
700 W): both fused passes over the group state at its (n, beta_pad, d,
Q, L), with the level tests its queries' own tables need, the top-k and
the exact re-rank.  It prices the work, not the kernels that do it, so
it still bounds the step after a kernel is fused away.
"""

from perfbench import cost


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    least = sum(cost.step_least_s(launch) for launch in run.launches)
    return 100.0 * least / run.trace.window_s
