"""Device milliseconds per request of host-to-device and device-to-host
copies in the traced window: state restores and offloads, and each
request's upload and download."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    answered = sum(r.ok for r in run.records)
    return 1e3 * run.trace.seconds(cats=("gpu_memcpy",),
                                   names=("HtoD", "DtoH")) / answered
