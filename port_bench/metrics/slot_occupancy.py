"""Useful slot-ticks over the slot-ticks run, from the server's registry
counters (``snn_useful_slot_ticks_total`` / ``snn_slot_ticks_total``)."""


def read(run):
    r = run.record
    if not r.get("slot_ticks_run"):
        return None
    return 100.0 * r["slot_ticks_useful"] / r["slot_ticks_run"]
