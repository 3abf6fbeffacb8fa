"""Host milliseconds of the screen jobs' read parse and packing a batch:
the program's `screen.pack` span (the job's wait for each packed batch
from the reader thread, which parses the FASTQ and packs its reads, and
the batch's upload; once more a file for its end) over the batches it
counts.  A program whose span counts no batches gives None."""

from benchmark.yardstick import spans


def read(run):
    return spans.per(spans.seconds("screen.pack"), spans.count("screen.pack", "batches"), 1e3)
