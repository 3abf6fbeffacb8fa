"""K3's share of its roofline over the window: the least card time of the
exact counts of every pair i < j of the jobs' sketches (a linear merge a
pair, two int32 operations a key; each sketch read once, 12 B written a
pair) over K3's device time in the trace."""

from benchmark.yardstick import readers


def read(run):
    return readers.share(readers.k3_bound_s(run), readers.k3_s(run))
