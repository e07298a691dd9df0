"""Host milliseconds per request inside the program's ``wlsh_upload``
spans (the codes' and the per-query inputs' host-to-device copies) in
the traced window."""

from perfbench.spans import host_ms_per_request


def read(run):
    return host_ms_per_request(run, ("wlsh_upload",))
