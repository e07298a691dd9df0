"""Host milliseconds per request inside the program's ``wlsh_encode``
spans (the query codes and their padding) in the traced window."""

from perfbench.spans import host_ms_per_request


def read(run):
    return host_ms_per_request(run, ("wlsh_encode",))
