"""Host seconds from the run's process start to the window's opening:
imports, inputs, the plan, the kernel build where there is none cached,
every group state and one request per group."""


def read(run):
    return run.setup_s
