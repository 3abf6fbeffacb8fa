"""Host milliseconds a million TSV rows of the dist jobs' formatting: the
self seconds of the program's `dist.format` span (each row-block stripe's
pairs sorted, their columns formatted and joined), less the `dist.pvalue`
and `dist.write` spans it holds, over the rows it counts.  A program
without those two spans gives None: its `dist.format` holds them."""

from benchmark.yardstick import spans


def read(run):
    if spans.seconds("dist.format", "dist.pvalue", "dist.write") is None:
        return None
    return spans.per(spans.count("dist.format", "self_s"), spans.count("dist.format", "rows"),
                     1e9)
