"""K1's share of its roofline over the window: the least card time of
hashing every window of the jobs' genomes (each code byte read once, 8 B
written a window, 24 int32 operations a window) over K1's device time in
the trace."""

from benchmark.yardstick import readers


def read(run):
    return readers.share(readers.k1_bound_s(run), readers.k1_s(run))
