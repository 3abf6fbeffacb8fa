"""K1's share of its roofline over the screen jobs: the least card time of
hashing every window of the read set's reads (each read's bases read once,
8 B written a window, 24 int32 operations a window; counted from the read
lengths, whatever the program hashes besides, such as the separators and
padding of its packed batches) over K1's device time in the trace."""

from benchmark.yardstick import readers


def read(run):
    return readers.share(readers.k1_bound_s(run), readers.k1_s(run))
