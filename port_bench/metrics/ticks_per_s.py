"""Ticks of the one stream completed in the window over the window's wall
time (the host's clock around chunks that end in a wait for the device)."""


def read(run):
    r = run.record
    return r["ticks"] / r["window_s"] if r.get("ticks") else None
