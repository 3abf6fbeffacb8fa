"""K4's share of its roofline over the window: the least card time of the
exact counts of every pair of one stripe row and one DB row of the jobs'
compact sketches (a linear merge a pair, one int32 operation a 32-bit
key; each sketch read once, 12 B written a pair) over the device time of
K4, the int32-key instance of the merge kernel, in the trace."""

from benchmark.yardstick import readers, roofline

K4_KERNEL = "tile_counts_kernel<int"


def read(run):
    if not run.peaks:
        return None
    sizes, rows, bound = run.state["sizes"], run.state["rows"], 0.0
    for r0 in run.state["window_stripes"]:
        ops, nbytes = roofline.k3_work_rect(sizes[r0:r0 + rows], sizes, key_bytes=4,
                                            ops_per_key=1)
        bound += roofline.bound_s(ops, nbytes, run.peaks)
    return readers.share(bound, readers.kernel_s(run, lambda n: K4_KERNEL in n))
