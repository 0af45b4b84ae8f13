"""The whole tick's share of the chip's peak: the least time of the work
completed in the window (``work.product``: the larger of its operations
over the float32 peak and its bytes over the HBM peak) over the window's
wall time."""
from port_bench import work


def read(run):
    return work.roofline_share(run.record["tick_work"], run.record["window_s"], run.kind)
