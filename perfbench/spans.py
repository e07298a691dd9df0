"""Host time inside the program's own layer spans.

The port names each layer of its serving path with a ``record_function``
range while a profiler runs (``repro_torch.obs.trace.LAYER_SPANS``:
``wlsh_encode``, ``wlsh_upload``, ``wlsh_restore``, ...).  They are
``user_annotation`` events on the thread that runs the window, on the
trace's one clock.  A reader sums the union of the named spans' host
intervals, clipped to the window, per request answered in it.
"""

from __future__ import annotations

# a launch's span: a trace without it comes from a program without spans
LAUNCH = "wlsh_batch"


def host_ms_per_request(run, names) -> float | None:
    """Host milliseconds per answered request inside the spans ``names``
    in the traced window; None without a trace, without an answer, or
    from a program that opens no layer spans."""
    view = run.trace
    if view is None:
        return None
    answered = sum(r.ok for r in run.records)
    spans = [(a, b, name) for a, b, name, cat in view.host
             if cat == "user_annotation" and name.startswith("wlsh_")]
    if not answered or not any(name == LAUNCH for _, _, name in spans):
        return None
    total, end = 0.0, view.t0
    for a, b in sorted((max(a, view.t0), min(b, view.t1))
                       for a, b, name in spans if name in names):
        if b > max(a, end):  # the union: a span inside another counts once
            total += b - max(a, end)
            end = b
    return total / 1e3 / answered
