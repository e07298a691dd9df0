"""Host seconds of the service's set-up, ending in a synchronize: every
group state built on the card (``warmup``) and one request per group."""


def read(run):
    return run.build_s
