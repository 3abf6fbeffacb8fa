"""Host milliseconds of the sketch jobs' batching per Gbase sketched: the
program's `sketch.bucket` (each genome's row shape from its length, and
the grouping by shape) and `sketch.pack` (each batch's genome bases
written end to end into a pinned staging slot) spans over the window's
Gbase."""

from benchmark.yardstick import spans


def read(run):
    return spans.per(spans.seconds("sketch.bucket", "sketch.pack"), spans.gbase(run), 1e3)
