"""Device milliseconds of every kernel of the sketch jobs but K1 (the tree
merge's sorts and compactions, and the index's keys) per Gbase sketched,
from the trace of the window."""

from benchmark.yardstick import readers


def read(run):
    rest = readers.kernel_s(run, lambda n: readers.K1_KERNEL not in n)
    if rest is None:
        return None
    return 1e3 * rest / (len(run.walls) * run.state["gbase"])
