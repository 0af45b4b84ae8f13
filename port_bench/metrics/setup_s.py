"""Set-up: from the process's start to the window's (imports, the kernel
build on a checkout's first run, tenants or weights, warm-up)."""


def read(run):
    return run.setup_s
