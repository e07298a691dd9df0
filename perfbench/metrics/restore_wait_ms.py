"""Host milliseconds per request inside the program's ``wlsh_restore``
and ``wlsh_offload`` spans in the traced window: the host blocked by
paging, beside ``copy_ms``'s device copies."""

from perfbench.spans import host_ms_per_request


def read(run):
    return host_ms_per_request(run, ("wlsh_restore", "wlsh_offload"))
