"""The tick's synaptic product against its roofline: the work its inputs
need (``work.product``, each network's own matrix, state and drive once, for
every tick in a request's budget) over the device time of the kernels that
compute it (``work.PRODUCT_KERNELS`` of the backends that ran)."""
from port_bench import work


def read(run):
    if run.trace is None:
        return None
    backends = run.record["backends"]
    sec = run.trace.seconds_of(lambda n: any(work.is_product_kernel(n, b) for b in backends))
    return work.roofline_share(run.record["product_work"], sec, run.kind)
