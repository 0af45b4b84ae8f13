"""Device operations (kernels, copies, sets) in the traced window over the
fabric ticks run in it."""


def read(run):
    if run.trace is None or not run.record.get("ticks"):
        return None
    return run.trace.events / run.record["ticks"]
