"""Host milliseconds a chunk spends before the device runs it: the server's
``host_time`` assemble and dispatch stages over the chunks run. A driver
whose record has no ``host_s`` gives nothing to read."""


def read(run):
    r = run.record
    if not r.get("chunks") or "host_s" not in r:
        return None
    host = r["host_s"]
    return 1e3 * (host.get("assemble", 0.0) + host.get("dispatch", 0.0)) / r["chunks"]
