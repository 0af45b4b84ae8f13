"""Useful slot-ticks completed in the window over the window: a request's
budget counts once it retires inside the window; one stream's every tick."""


def read(run):
    r = run.record
    return r["useful_slot_ticks"] / r["window_s"] if r["useful_slot_ticks"] else None
