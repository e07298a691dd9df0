"""Host seconds of ``WLSHIndex(...)`` and ``export_serving_plan()``: the
partition, the families and the host codes of every group."""


def read(run):
    return run.plan_s
