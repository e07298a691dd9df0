"""Device milliseconds per request of the kernels under the engine's
``wlsh_topk`` and ``wlsh_rerank`` ranges, in the traced window."""

RANGES = ("wlsh_topk", "wlsh_rerank")


def read(run):
    if run.trace is None or not run.trace.gpu_ranges:
        return None
    answered = sum(r.ok for r in run.records)
    return 1e3 * run.trace.seconds(cats=("kernel",), ranges=RANGES) / answered
